// Kernels H, H8, I, I8, J, J8, 19 and 20 for Hopper: x (B <= 32, Din) @
// w_all[layer] for the stacked (L, Din, Dout) weights read in place, fp32
// sums rounded once to bf16. H-J8 replace
// grasp_any_region_tpu/ops/layer_matmul.py's layer_matmul (_mm_kernel, H),
// layer_matmul_q8 (_mm_q8_kernel, H8), layer_swiglu (_swiglu_kernel, I),
// layer_swiglu_q8 (_swiglu_q8_kernel, I8), layer_qkv (_qkv_kernel, J) and
// layer_qkv_q8 (_qkv_q8_kernel, J8); 19 and 20 replace
// grasp_any_region_tpu/ops/decode_megakernel.py's layer_qkv_norm_rope
// (_qkv_kernel) and layer_qkv_norm_rope_q8 (_qkv_q8_kernel), the mega decode
// step's RMSNorm, q, k and v products and rope. H and H8 are called twice a
// layer by the fused decode step (wo, w_down), I and I8, J and J8 once; 19
// or 20 once a layer by the mega step. H8 is (x w_q8[l]) s[l], int8 weights
// with one fp32 scale a column; I is silu(x wg[l]) * (x wu[l]); I8 is
// silu((x wg_q8[l]) sg[l]) * ((x wu_q8[l]) su[l]); J is x wq[l], x wk[l],
// x wv[l] (rope stays outside, as in JAX), J8 the same with int8 weights
// and column scales. SiLU and the product
// are in fp32 from the fp32 sums, one rounding. The int8 kernels put the
// scale on the summed column (the TPU kernels scale the widened weight
// before the sum; the scale is constant along it, so this equals it up to
// fp32 reassociation). GAR-1B streams 8.4 / 4.2 MB (wo, bf16 / int8),
// 33.6 / 16.8 MB (w_down), 67.1 / 33.6 MB (gate and up) and 12.6 / 6.3 MB
// (q, k and v) a call.
//
// What bounds it: at B = 1 each weight byte feeds one or two FLOPs, so the
// time is the time to stream the weight from HBM (2.5 us for H's wo, 10 for
// its w_down, 20 for I, at 3.35 TB/s). A call of 10-45 us is as much fixed
// cost (launch, ramp, the reduction at the end) as streaming, so the
// design streams fast from the first microsecond and keeps the end short:
//
//  * The weight comes in by TMA: one tensor map over the (Dout, Din, L)
//    view, boxes of one 128-byte swizzle row x 128 rows (16 KB: 64 bf16
//    or 128 int8 columns), the layer a coordinate, so one map serves every
//    layer. Rows past Din and
//    columns past Dout are outside the map and land as zeros. The map is
//    encoded once per weight tensor (sm90.cuh:stacked_weight_map caches it
//    by base and shape), so a call costs the host no more than the
//    cp.async form did.
//  * A CTA owns a box's columns (a tile) and a K range of k_split rows, a
//    multiple of the box; the S CTAs of a tile form a thread-block cluster.
//    S (ops/layer_matmul.py:stream_splits: two CTAs an SM, one for I8)
//    doubles while the grid stays within the kernel's CTAs an SM.
//  * One lane of a producer warp keeps a ring of three stages in flight:
//    each stage one weight box by TMA (two for a SwiGLU's gate and up) and
//    the matching 128 columns of x by a second tensor map (x as (Din, B),
//    two 64-column boxes of xr = B rounded up to 8 rows, swizzled as the
//    weight is; rows past B and columns past Din land as zeros), on one
//    mbarrier. (x by 1D bulk copies, one a row, cost I 8 us and H8 2 us
//    back to back at B = 24: ab_kernels.py.) Three one-box stages (50-75 KB a CTA)
//    let three or four CTAs share an SM, so all 32 clusters of 8 of H are
//    resident at once; rings of 4-12 stages, or x stages of 32 rows at B =
//    24, measured slower where that no longer held (ab_kernels.py). The
//    producer issues the first weight boxes before waiting on the kernel
//    before this one (programmatic dependent launch: the weights never
//    depend on it); x is loaded, and out written, only after
//    griddepcontrol.wait.
//  * Four consumer warps own a quarter of the tile's columns each (16 bf16
//    or 32 int8), over every row of a stage: mma.sync m16n8k16 with x as
//    the A operand (16 or 32 rows; those past B reach only sums that are
//    not stored) through ldmatrix of the swizzled x boxes, and the weight as B through
//    ldmatrix.trans of the swizzled rows (both conflict-free), int8
//    widened exactly to bf16 in registers (weight_tile.cuh:b_frags, as
//    kernel 21 does it). At B = 1 the tensor cores idle
//    either way; at B = 24 the CUDA cores would not keep up with HBM. (The
//    warps splitting a stage's rows instead needed a pass summing their
//    partials at the end, and measured slower.) A warp
//    hands a stage back one stage late, behind a proxy fence, after the
//    products that read it: the TMA unit must not refill shared memory
//    that a warp's loads may still be reading (handed back at once without
//    the fence, weight boxes were overwritten under their readers).
//  * The partials meet in fixed order in the same launch: CTA r finishes
//    columns [r BN / S, (r + 1) BN / S) of the tile, so each CTA stages its
//    (rows, BN) partial in its own shared memory and pushes each
//    finisher's columns into that CTA's shared memory (distributed shared
//    memory) in 16-byte pieces, the cluster syncs once, and each CTA sums
//    what it received in rank order. (Pulling the partials with remote
//    loads took a second barrier, to keep a CTA alive while its peers read
//    it, and measured slower at B = 24; the warps' fragments stored
//    straight into the finishers, 4 bytes at a time, too.) A cluster
//    barrier arrived at when a CTA starts, and waited on before its first
//    remote store, makes sure every peer has started. No
//    workspace, no atomics, and the result does not depend on timing
//    (ops/layer_matmul.py:layer_matmul_stream_plain mirrors this order on
//    the CPU for all four kernels).
//
// The body takes the weight type, the number of weights a stage (NW = 2:
// a SwiGLU's gate and up, two boxes a stage, silu(gate) * up in the
// epilogue) and how x reaches the products (XN) as template parameters: H
// and J are (bf16, 1), H8 and J8 (int8, 1), I (bf16, 2), I8 (int8, 2), x
// in boxes beside the weights; the int8 finisher puts each column's scale on its summed
// weight. The grid's column tiles come from a table of up to three
// segments (StreamArgs::seg), each its own weight, tensor map, width,
// output, int8 scales and rope tables; blockIdx.y finds its segment by the
// tiles' prefix sums. H-I8 are one segment. J and J8 are three (q, k, v:
// 48 bf16 tiles or 24 int8 tiles at GAR-1B; qkv_segments fills the table)
// and otherwise H's body: x in boxes, no prologue, no rope; a segment
// narrower than a box (k and v of a narrow model) comes in as zeros past
// its width, and the finisher stores none of it. 19 and 20 are the same
// three segments with two more parts:
//
//  * An RMSNorm prologue (rms_prologue.cuh, as 21 / 23's): the producer
//    issues the first weight boxes at once; the consumers wait for the
//    kernel before, take each whole x row's rstd (fp32 squares, a warp a
//    row) and write xn over the CTA's K range into shared memory once, in
//    the x boxes' swizzled layout (conflict-free ldmatrix), so a stage holds
//    only its weight box. 19 rounds xn to bf16, as _qkv_kernel does; 20
//    keeps JAX's fp32 xn as a bf16 high half and low half (hi = bf16(v), lo
//    = bf16(v - hi): 16 significant bits), two products a weight fragment.
//    At GAR-1B xn is at most 32 KB a CTA (B = 32: k_split 512 bf16, 256
//    int8 with two halves). A thread loads 8 chunks of x before it
//    converts any (one load a chunk, each waited for, cost 19 and 20 several
//    us at B = 24). Past 16 rows the CTAs of a cluster split the rows' rstd
//    and store them into each other (distributed shared memory, one more
//    cluster barrier): every CTA reading all of x cost 19 1.8 us and 20 3.3
//    us at B = 24, the barrier 1.5 us at B = 1 (ab_kernels.py, PERF.md).
//  * A rope epilogue in the finisher: a finisher of a roped segment owns a
//    share of each 64-column head's 32 rotate-half pairs (c, c + 32), its
//    first halves and then their partners (ws_col), so the partials still
//    arrive in 16-byte pieces; it sums both columns of each pair in rank
//    order, puts each column's int8 scale on its sum, and applies v cos +
//    (second half ? pv : -pv) sin in fp32, the tables (rows, w) read at
//    column mod w, one rounding. That needs at least 4 pairs a finisher: S
//    <= 8 at bf16, 16 at int8.
//
// A SwiGLU's stage at GAR-1B holds 2 x 16 KB of boxes: at B = 24 three
// such stages and the partials fit only a CTA alone on its SM, so a grid within one CTA an SM takes a whole SM's
// shared memory (launch_stream); the CTAs an SM are measured
// (ops/layer_matmul.py: STREAM_CTAS_PER_SM, STREAM_CTAS_PER_SM_Q8).
#include <cooperative_groups.h>

#include <algorithm>

#include "rms_prologue.cuh"  // rms_rstd, rms_pair
#include "sm90.cuh"
#include "weight_tile.cuh"  // box_frags, b_frags, frag_col, opt_in, card_sm_count

namespace gar {

namespace cg = cooperative_groups;

constexpr int kWsN = 64;          // bf16 columns a tile: one 128-byte swizzle row
constexpr int kWsBK = 128;        // weight rows (and x columns) a stage: 16 KB a weight
constexpr int kWsStages = 3;      // the ring (fewer only where a stage would not fit the budget)
constexpr int kWsConsumers = 4;   // warp w multiplies columns 16 w .. 16 w + 15
constexpr int kWsThreads = 32 * (kWsConsumers + 1);  // and one producer warp
constexpr int kWsMaxSplits = 16;  // Hopper's largest (non-portable) cluster
constexpr int kWsMaxRows = 32;
constexpr int kWsBox = kWsBK * 128;  // bytes of one weight's stage
constexpr int kWsXBox = 64;          // x columns a box: one 128-byte swizzle row
constexpr int kWsCtaSmem = 232448 / 2 - 1024;  // two CTAs an SM, each with its 1 KB reserve
constexpr int kWsSmemMax = 232448;  // a CTA alone on its SM
constexpr int kWsFixed = 1024 + 2 * kWsStages * 8;  // the alignment slack and the barriers
constexpr int kWsMaxSegs = 3;  // the segment table: q, k and v
constexpr int kWsHead = 64;    // rope: a head's columns, pairs (c, c + 32)

// How x reaches the products: H-I8 load it beside each stage's weight
// boxes; 19 and 20 normalise it once a CTA into shared memory, 19 rounded
// to bf16, 20 as a bf16 high and low half.
constexpr int kXBoxes = 0, kXnRounded = 1, kXnSplit = 2;

// Columns a tile: one 128-byte swizzle row, 64 bf16 or 128 int8.
template <typename W>
__host__ __device__ constexpr int ws_n() {
  return 128 / static_cast<int>(sizeof(W));
}

struct StreamMaps {
  // each weight as (Dout, Din, L, 1), box (ws_n, 128, 1, 1): segment s's at
  // w[s NW + w] (a SwiGLU, one segment: gate w[0], up w[1])
  CUtensorMap w[kWsMaxSegs];
  CUtensorMap x;  // x as (Din, rows, 1, 1), box (64, ws_x_rows, 1, 1); kXBoxes only
};

struct StreamSeg {
  bf16* out;              // (rows, dout)
  const float* scale[2];  // int8: each weight's column scales at the layer, (dout,)
  const float* cos;       // rope: the tables (rows, cos_width), column c read at
  const float* sin;       // c mod cos_width; null: no rope
  int dout, tiles, cos_width;
};

struct StreamArgs {
  const bf16* x;     // (rows, din)
  const bf16* norm;  // the prologue's RMSNorm weight at the layer, (din,)
  int layer, rows, din;
  int k_split;    // weight rows a CTA of a cluster: a multiple of kWsBK
  int stages;     // of the ring, 2 .. kWsStages
  int segs;       // of the table, 1 .. kWsMaxSegs: their tiles in order along the grid's y
  float eps;
  StreamSeg seg[kWsMaxSegs];
};

// x rows a stage holds: B rounded up to 8, so each 128-byte-wide x box is
// whole 1024-byte swizzle atoms (and starts on one).
__host__ __device__ constexpr int ws_x_rows(int rows) {
  return (rows + 7) / 8 * 8;
}

// Bytes of one stage: NW weight boxes, and with kXBoxes two x boxes of
// ws_x_rows rows.
template <int NW, int XN>
__host__ __device__ constexpr int ws_stage(int rows) {
  return NW * kWsBox + (XN == kXBoxes ? 2 * 128 * ws_x_rows(rows) : 0);
}

// Bytes of the prologue's xn over a CTA's k_split columns: boxes of 64
// columns x ws_x_rows rows, 128-byte swizzled as the x boxes are; twice
// that for a high and a low half.
template <int XN>
__host__ __device__ constexpr int ws_xn(int k_split, int rows) {
  return XN == kXBoxes ? 0 : (XN == kXnSplit ? 2 : 1) * k_split * 2 * ws_x_rows(rows);
}

// The bytes past the stages that do not depend on them: alignment slack,
// barriers, the prologue's rstd and xn.
template <int XN>
__host__ __device__ constexpr int ws_fixed(int k_split, int rows) {
  return kWsFixed + (XN == kXBoxes ? 0 : 4 * kWsMaxRows) + ws_xn<XN>(k_split, rows);
}

// The tile column of finisher q's i-th of its cols = BN / S columns. No
// rope: the q-th contiguous run. Rope (cols >= 8): its share of the tile's
// first halves (the columns c with c % 64 < 32, counted in order), then
// their partners 32 columns on, so that i and i + cols / 2 are a pair.
// Runs of 4 (the 16-byte pieces) stay contiguous either way.
__host__ __device__ inline int ws_col(bool rope, int q, int i, int cols) {
  if (!rope) return q * cols + i;
  const int half = cols / 2, f = q * half + i % half;
  return f / (kWsHead / 2) * kWsHead + f % (kWsHead / 2) + (i < half ? 0 : kWsHead / 2);
}

// Bytes of the partials a CTA receives: NW x (rows, tile) fp32, from every
// CTA of its cluster its columns of the tile.
template <typename W, int NW>
__host__ __device__ constexpr int ws_recv(int rows) {
  return NW * rows * ws_n<W>() * 4;
}

// Grid (S, the segments' tiles), cluster (S, 1, 1).
template <typename W, int NW, int MT, int XN>
__global__ void __launch_bounds__(kWsThreads)
    weight_stream_kernel(const __grid_constant__ StreamMaps maps, const StreamArgs a) {
  using namespace sm90;
  constexpr bool Q8 = sizeof(W) == 1;
  constexpr int BN = ws_n<W>();           // columns a tile
  constexpr int WN = BN / kWsConsumers;  // a warp's: 16 bf16, 32 int8
  constexpr int NT = WN / 8;             // its n-tiles: 2, 4
  static_assert(sizeof(W) == 2 || Q8, "bf16 or int8 weights");
  static_assert(NW == 1 || NW == 2, "one weight, or a SwiGLU's gate and up");
  static_assert(XN == kXBoxes || NW == 1, "a prologue feeds one weight a stage");
  // 19 / 20 past 16 rows: the CTAs of a cluster take a share of the rows'
  // rstd each and store it into every CTA of the cluster (at B = 24 every
  // CTA reading all of x measured slower; at B = 1 the extra cluster barrier)
  constexpr bool SHARE = XN != kXBoxes && MT == 2;
  extern __shared__ uint8_t smem_raw[];
  // (1024-aligned) [stages][NW] weight boxes; [stages][2] x boxes, or the
  // prologue's xn ([k_split / 64] boxes, then as many of its low half); the
  // barriers, the prologue's rstd, and the partials this CTA receives
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = a.stages, xr = ws_x_rows(a.rows), x_box = 128 * xr;
  uint8_t* xs = sm + stages * NW * kWsBox;  // [stages][2] x boxes, or xn
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * ws_stage<NW, XN>(a.rows) +
                                               ws_xn<XN>(a.k_split, a.rows));
  uint64_t* empty = full + kWsStages;
  float* rstd = reinterpret_cast<float*>(empty + kWsStages);  // the prologue's, [kWsMaxRows]
  float* recv = rstd + (XN == kXBoxes ? 0 : kWsMaxRows);      // [NW][splits][rows][BN / S]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  int tile = blockIdx.y, si = 0;  // the segment, and the tile within it
  while (si + 1 < a.segs && tile >= a.seg[si].tiles) tile -= a.seg[si++].tiles;
  const StreamSeg sg = a.seg[si];
  const CUtensorMap* wmap = &maps.w[si * NW];
  const bool rope = XN != kXBoxes && sg.cos != nullptr;
  const int n0 = tile * BN;
  const int k_begin = rank * a.k_split;
  const int k_end = min(a.din, k_begin + a.k_split);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + kWsBK - 1) / kWsBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrival, with the copies' bytes
      mbar_init(&empty[s], kWsConsumers);    // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  // this CTA has started: a peer may store into its shared memory once every
  // CTA of the cluster has arrived here (waited for before the first store)
  cluster_arrive_relaxed();

  float acc[NW][MT][NT][4];  // this warp's (16 MT, WN) partial of each weight
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.f;

  if (warp == kWsConsumers) {  // the producer warp: lane 0 issues every copy
    // stage j's bytes: NW weight boxes and (kXBoxes) two x boxes, each
    // counted whole (zero-filled past Din and past B); a stage never reaches
    // past k_end but at Din, since k_split is a multiple of the stage
    auto weights = [&](int j, int s) {
      mbar_arrive_expect_tx(&full[s], NW * kWsBox + (XN == kXBoxes ? 2 * x_box : 0));
#pragma unroll
      for (int w = 0; w < NW; ++w)
        tma_load_4d(sm + (s * NW + w) * kWsBox, &wmap[w], &full[s], n0, k_begin + j * kWsBK,
                    a.layer, 0);
    };
    const int ahead = min(n_stages, stages);
    if (lane == 0)
      for (int j = 0; j < ahead; ++j) weights(j, j);  // the weights wait for nothing
    __syncwarp();
    if constexpr (SHARE) {  // the rstd exchange's barrier: this warp has nothing to give
      cluster_wait();
      cluster_arrive();
    }
    if (lane == 0) {
      if (XN == kXBoxes) grid_dependency_wait();       // x is the kernel before's output
      for (int j = 0; j < n_stages; ++j) {
        const int s = j % stages;
        if (j >= ahead) {
          mbar_wait(&empty[s], ((j / stages) - 1) & 1);
          weights(j, s);
        }
        if (XN == kXBoxes)
          for (int b = 0; b < 2; ++b)
            tma_load_4d(xs + (2 * s + b) * x_box, &maps.x, &full[s],
                        k_begin + j * kWsBK + kWsXBox * b, 0, 0, 0);
      }
    }
    // the warp whole again before the block barriers below: lanes reaching
    // __syncthreads while lane 0 still issued copies ran one barrier ahead
    // (the CTA's sums then read partials not yet written)
    __syncwarp();
    if constexpr (SHARE) cluster_wait();
  } else {
    // the prologue: every x row's rstd (past 16 rows shared over the
    // cluster: SHARE), then xn over [k_begin, k_end) (zeros past k_end, to
    // the last stage's end, and in the rows past B) in 64-column boxes of xr
    // rows, chunk c of row r at c ^ (r % 8)
    constexpr int NH = XN == kXnSplit ? 2 : 1;  // xn's halves
    const int xn_half = ws_xn<kXnRounded>(a.k_split, a.rows);
    if constexpr (XN != kXBoxes) {
      // each thread loads kXnBatch 16-byte chunks of x (and of the norm
      // weight) before it converts any: one latency a batch, not a chunk
      constexpr int kXnBatch = 8, kStep = 32 * kWsConsumers;
      const int chunks = n_stages * (kWsBK / 8), total = xr * chunks;  // 16-byte chunks of xn
      grid_dependency_wait();  // x is the kernel before's output
      if constexpr (SHARE) {
        // CTA q of the cluster takes rows q, q + S, ... and stores each rstd
        // into every CTA of the cluster (all have started: the entry barrier)
        cluster_wait();
        rms_rstd(rstd, a.x, a.rows, a.din, a.eps, rank + splits * warp, splits * kWsConsumers,
                 lane);
        bar_sync(1, 32 * kWsConsumers);
        const int mine = (a.rows - rank + splits - 1) / splits;
        for (int e = threadIdx.x; e < mine * splits; e += kStep) {
          const int r = rank + splits * (e / splits);
          cluster.map_shared_rank(rstd, e % splits)[r] = rstd[r];
        }
        cluster_arrive();
        cluster_wait();  // every row's rstd is here
      } else {
        rms_rstd(rstd, a.x, a.rows, a.din, a.eps, warp, kWsConsumers, lane);
        bar_sync(1, 32 * kWsConsumers);
      }
      for (int e0 = threadIdx.x; e0 < total; e0 += kXnBatch * kStep) {
        uint4 xv[kXnBatch], nv[kXnBatch];
#pragma unroll
        for (int u = 0; u < kXnBatch; ++u) {
          const int e = e0 + u * kStep, r = e / chunks, k = k_begin + 8 * (e % chunks);
          const bool in = e < total && r < a.rows && k < k_end;
          xv[u] = in ? *reinterpret_cast<const uint4*>(a.x + static_cast<size_t>(r) * a.din + k)
                     : make_uint4(0u, 0u, 0u, 0u);
          nv[u] = in ? *reinterpret_cast<const uint4*>(a.norm + k) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kXnBatch; ++u) {
          const int e = e0 + u * kStep, r = e / chunks, kc = e % chunks;
          if (e >= total) continue;
          const float rs = r < a.rows ? rstd[r] : 0.f;
          const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv[u]);
          const __nv_bfloat162* nh = reinterpret_cast<const __nv_bfloat162*>(&nv[u]);
          uint32_t hv[NH][4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float2 v = rms_value(xh[p], nh[p], rs);
            const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
            hv[0][p] = *reinterpret_cast<const uint32_t*>(&h);
            if constexpr (NH == 2) {
              const float2 hf = __bfloat1622float2(h);
              hv[NH - 1][p] = pack_bf16x2(v.x - hf.x, v.y - hf.y);
            }
          }
          uint8_t* dst = xs + (kc >> 3) * x_box + r * 128 + (((kc & 7) ^ (r & 7)) << 4);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            *reinterpret_cast<uint4*>(dst + h * xn_half) =
                make_uint4(hv[h][0], hv[h][1], hv[h][2], hv[h][3]);
        }
      }
      bar_sync(1, 32 * kWsConsumers);  // xn is whole
    }
    // B fragments from ldmatrix.x4.trans of this warp's 16-byte chunks 2 w,
    // 2 w + 1 of 16 rows (weight_tile.cuh:box_frags; chunk c of row r sits
    // at c ^ (r % 8)): bf16 columns 16 w .. 16 w + 7, then + 8 .. + 15; int8
    // the even and the odd columns of 32 w .. 32 w + 15, then of + 16 ..
    // + 31, widened (frag_col says where each sum lands)
    for (int j = 0; j < n_stages; ++j) {
      const int s = j % stages;
      mbar_wait(&full[s], (j / stages) & 1);
      // k-step h's fragments: x as the A fragments by ldmatrix.x4 (for row
      // tile i, a[0] = x[16 i + g][16 h + 2t ..], a[1] = row + 8, a[2] =
      // column + 8, a[3] both; lane l gives row 16 i + l % 16 of 16-byte
      // chunk 2 (h % 4) + l / 16 in box h / 4, chunk c of row r at c ^ (r %
      // 8)), and each weight's raw ldmatrix.trans. A row of A reaches only
      // its own row of the sums, and rows past B are never stored: rows past
      // xr (xr = 16 MT - 8) read the row 8 above, which keeps the address in
      // the box. Each k-step's loads are issued before the products of the
      // one before (one warp a sub-partition at one CTA an SM waits on them
      // otherwise: with each k-step's loads at its products, H8 and I8 at
      // B = 1 took 0.55 and 0.9 us longer back to back, ab_kernels.py). xn's
      // boxes are the stage's (j), not the ring slot's; its low half (20)
      // gives a second A fragment, xl
      uint32_t xa[2][MT][4], xl[2][NH == 2 ? MT : 1][4], raw[2][NW][4];
      auto frags = [&](int h, int p) {
        const uint8_t* xbox = xs + (2 * (XN == kXBoxes ? s : j) + (h >> 2)) * x_box;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int r = 16 * i + (lane & 15);
          if (r >= xr) r -= 8;
          const int c = 2 * (h & 3) + (lane >> 4);
          ldmatrix_x4(xa[p][i],
                      reinterpret_cast<const bf16*>(xbox + r * 128 + ((c ^ (r & 7)) << 4)));
          if constexpr (NH == 2)
            ldmatrix_x4(xl[p][i], reinterpret_cast<const bf16*>(xbox + xn_half + r * 128 +
                                                                ((c ^ (r & 7)) << 4)));
        }
#pragma unroll
        for (int w = 0; w < NW; ++w)
          box_frags(raw[p][w], sm + (s * NW + w) * kWsBox, 16 * h, 2 * warp, lane);
      };
      frags(0, 0);
#pragma unroll
      for (int h = 0; h < kWsBK / 16; ++h) {
        if (h + 1 < kWsBK / 16) frags(h + 1, (h + 1) & 1);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t b[NT][2];
          b_frags<W, NT>(b, raw[h & 1][w]);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[w][i][n], xa[h & 1][i], b[n][0], b[n][1]);
          if constexpr (NH == 2)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_bf16_16816(acc[w][i][n], xl[h & 1][i], b[n][0], b[n][1]);
        }
      }
      if (j > 0) {  // stage j - 1: its products are issued, so its loads are done
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
      }
    }
  }
  grid_dependency_wait();  // out may be memory the kernel before still reads

  // CTA q finishes BN / S columns of the tile: [q BN / S, (q + 1) BN / S),
  // or under rope its share of the pairs (ws_col). This
  // CTA's partial goes first into its own shared memory, [NW][rows][BN + 4]
  // fp32 over the ring's first bytes (free once every warp is past its last
  // stage), then to the finishers in 16-byte pieces, each finisher's rows
  // contiguous (a fragment's sums stored one by one, 4 bytes at a time to
  // scattered addresses, measured slower at B = 24: ab_kernels.py); the
  // cluster syncs once, and each CTA sums what it received in rank order
  constexpr int PP = BN + 4;  // the partial's row pitch in floats: 16-byte rows, fewer conflicts
  float* part = reinterpret_cast<float*>(sm);
  __syncthreads();  // every stage is read
  if (warp < kWsConsumers) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * i + g + 8 * (e >> 1), col = frag_col<W>(j, e & 1, WN * warp, t);
            if (row < a.rows) part[(w * a.rows + row) * PP + col] = acc[w][i][j][e];
          }
  }
  __syncthreads();
  if constexpr (!SHARE) cluster_wait();  // every CTA of the cluster has started
  const int cols = BN / splits, quads = cols / 4, per_q = NW * a.rows * quads;
  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {
    const int q = e / per_q, f = e % per_q;   // finisher q, its f-th piece from this CTA
    const int wr = f / quads, c = 4 * (f % quads), w = wr / a.rows;  // wr = w rows + row
    const float4 v = *reinterpret_cast<const float4*>(part + wr * PP + ws_col(rope, q, c, cols));
    float* dst = cluster.map_shared_rank(recv, q) + ((w * splits + rank) * a.rows) * cols;
    *reinterpret_cast<float4*>(dst + (wr - w * a.rows) * cols + c) = v;
  }
  cluster.sync();  // every partial is in its finisher's shared memory; none is read remotely
  for (int e = threadIdx.x; e < a.rows * cols; e += kWsThreads) {
    const int row = e / cols, c = e % cols, col = n0 + ws_col(rope, rank, c, cols);
    if (col >= sg.dout) continue;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      v[w] = 0.f;
      for (int r = 0; r < splits; ++r) v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];
    }
    if constexpr (Q8) {  // each weight's column scale on its summed column
      v[0] *= sg.scale[0][col];
      if (NW == 2) v[NW - 1] *= sg.scale[NW - 1][col];
    }
    // a SwiGLU: silu(gate) * up in fp32, one rounding
    float o = NW == 2 ? v[0] / (1.f + expf(-v[0])) * v[NW - 1] : v[0];
    if (rope) {  // the pair's other column, summed in rank order too (a SwiGLU has no rope)
      const bool second = c >= cols / 2;
      const int pc = second ? c - cols / 2 : c + cols / 2;
      float pv = 0.f;
      for (int r = 0; r < splits; ++r) pv += recv[(r * a.rows + row) * cols + pc];
      if constexpr (Q8) pv *= sg.scale[0][second ? col - kWsHead / 2 : col + kWsHead / 2];
      const int ti = row * sg.cos_width + col % sg.cos_width;
      o = o * sg.cos[ti] + (second ? pv : -pv) * sg.sin[ti];
    }
    sg.out[static_cast<size_t>(row) * sg.dout + col] = __float2bfloat16(o);
  }
}

// One launch with a cluster of `splits` and programmatic stream
// serialization, x's tensor map encoded here (cached by address and shape,
// as the weights' are), the ring as deep as the CTA's share of an SM allows: a
// grid of at most one CTA an SM may take a whole SM's shared memory (a
// SwiGLU's three stages of gate and up at B = 24), a larger one half (two
// stages at least: one CTA an SM where two leave less); the first opts the
// kernel in to the most shared memory and to clusters of 16.
template <typename W, int NW, int MT, int XN>
int launch_stream(StreamMaps maps, StreamArgs a, int tiles, int splits, cudaStream_t stream) {
  const auto kernel = weight_stream_kernel<W, NW, MT, XN>;
  static bool opted_in = false;
  if (const int err = opt_in(kernel, kWsSmemMax, true, opted_in)) return err;
  if constexpr (XN == kXBoxes) {
    if (const int err =
            stacked_weight_map(&maps.x, a.x, 2, 1, a.rows, a.din, kWsXBox, ws_x_rows(a.rows)))
      return err;
  }
  const int recv = ws_recv<W, NW>(a.rows), fixed = ws_fixed<XN>(a.k_split, a.rows);
  const int budget = tiles * splits <= card_sm_count() ? kWsSmemMax : kWsCtaSmem;
  a.stages = std::max(2, std::min(kWsStages, (budget - fixed - recv) / ws_stage<NW, XN>(a.rows)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kWsThreads, 1, 1);
  cfg.dynamicSmemBytes = a.stages * ws_stage<NW, XN>(a.rows) + fixed + recv;
  if (static_cast<int>(cfg.dynamicSmemBytes) > kWsSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch at the row tile that covers a.rows: 16 rows or 32.
template <typename W, int NW, int XN>
int launch_rows(const StreamMaps& maps, const StreamArgs& a, int tiles, int splits,
                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.rows <= 16) return launch_stream<W, NW, 1, XN>(maps, a, tiles, splits, s);
  return launch_stream<W, NW, 2, XN>(maps, a, tiles, splits, s);
}

// The arguments but the segments', for x (rows, din) split over `splits`
// CTAs a tile: k_split = ceil(din / splits) rounded up to a stage.
inline StreamArgs stream_args(const void* x, int layer, int rows, int din, int splits) {
  StreamArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.layer = layer;
  a.rows = rows;
  a.din = din;
  a.k_split = ((din + splits - 1) / splits + kWsBK - 1) / kWsBK * kWsBK;
  a.segs = 1;
  return a;
}

// A segment of `dout` columns into `out`, its tiles of ws_n<W>() columns.
template <typename W>
StreamSeg stream_seg(void* out, int dout, const float* s0 = nullptr, const float* s1 = nullptr) {
  constexpr int BN = ws_n<W>();
  return {static_cast<bf16*>(out), {s0, s1}, nullptr, nullptr, dout, (dout + BN - 1) / BN, 0};
}

// The segment table of q, k and v (widths hq, hk, hk) at a.layer: each
// segment's stacked tensor map, output and (int8, s non-null) column
// scales; with rope tables (19 / 20) q's and k's tables, of widths cw_q
// and cw_k. J and J8 pass no tables. The grid's column tiles go to `tiles`.
template <typename W>
int qkv_segments(StreamMaps& maps, StreamArgs& a, const void* const* w, const void* const* s,
                 const void* const* tables, void* const* out, int n_layers, int d, int hq,
                 int hk, int cw_q, int cw_k, int& tiles) {
  constexpr int BN = ws_n<W>();
  a.segs = 3;
  const int ns[3] = {hq, hk, hk}, cws[3] = {cw_q, cw_k, 0};
  tiles = 0;
  for (int i = 0; i < 3; ++i) {
    if (const int err =
            stacked_weight_map(&maps.w[i], w[i], sizeof(W), n_layers, d, ns[i], BN, kWsBK))
      return err;
    const float* scale =
        s ? static_cast<const float*>(s[i]) + static_cast<size_t>(a.layer) * ns[i] : nullptr;
    a.seg[i] = stream_seg<W>(out[i], ns[i], scale);
    if (tables && i < 2) {  // q and k: rope
      a.seg[i].cos = static_cast<const float*>(tables[2 * i]);
      a.seg[i].sin = static_cast<const float*>(tables[2 * i + 1]);
      a.seg[i].cos_width = cws[i];
    }
    tiles += a.seg[i].tiles;
  }
  return tiles > 65535 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Kernels 19 (W bf16, xn rounded) and 20 (int8 with column scales s, xn as
// two halves): RMSNorm(x) @ wq, wk, wv at the layer, rope on q and k.
template <typename W>
int qkv_norm_rope(const void* x, const void* norm_all, const void* const* w,
                  const void* const* s, const void* const* tables, void* const* out, int layer,
                  int n_layers, int rows, int d, int hq, int hk, int cw_q, int cw_k, int splits,
                  float eps, void* stream) {
  constexpr int BN = ws_n<W>();
  if (rows < 1 || rows > kWsMaxRows || d <= 0 || d % 8 || hq <= 0 || hk <= 0 ||
      hq % kWsHead || hk % kWsHead || cw_q <= 0 || cw_k <= 0 || layer < 0 ||
      layer >= n_layers || splits < 1 || splits > BN / 8 || (splits & (splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  StreamArgs a = stream_args(x, layer, rows, d, splits);
  a.norm = static_cast<const bf16*>(norm_all) + static_cast<size_t>(layer) * d;
  a.eps = eps;
  int tiles = 0;
  if (const int err =
          qkv_segments<W>(maps, a, w, s, tables, out, n_layers, d, hq, hk, cw_q, cw_k, tiles))
    return err;
  return launch_rows<W, 1, sizeof(W) == 1 ? kXnSplit : kXnRounded>(maps, a, tiles, splits,
                                                                   stream);
}

// Kernels J (W bf16) and J8 (int8 with column scales s): x @ wq, wk, wv at
// the layer, x in boxes beside the weights, no prologue and no rope. hq
// and hk multiples of 8 (bf16) or 16 (int8): whole 16-byte rows.
template <typename W>
int layer_qkv(const void* x, const void* const* w, const void* const* s, void* const* out,
              int layer, int n_layers, int rows, int d, int hq, int hk, int splits,
              void* stream) {
  constexpr int chunk = 16 / static_cast<int>(sizeof(W));
  if (rows < 1 || rows > kWsMaxRows || d <= 0 || d % 8 || hq <= 0 || hk <= 0 || hq % chunk ||
      hk % chunk || layer < 0 || layer >= n_layers || splits < 1 || splits > kWsMaxSplits ||
      (splits & (splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  StreamArgs a = stream_args(x, layer, rows, d, splits);
  int tiles = 0;
  if (const int err = qkv_segments<W>(maps, a, w, s, nullptr, out, n_layers, d, hq, hk, 0, 0,
                                      tiles))
    return err;
  return launch_rows<W, 1, kXBoxes>(maps, a, tiles, splits, stream);
}

}  // namespace gar

// Kernel H: x (rows, din) @ w_all[layer], w_all (n_layers, din, dout), over
// clusters of `splits` CTAs (a power of two up to 16). din and dout
// multiples of 8, rows 1-32, bases 16-byte aligned (x's too: TMA).
extern "C" int gar_layer_matmul(const void* x, const void* w_all, void* out, int layer,
                                int n_layers, int rows, int din, int dout, int splits,
                                void* stream) {
  using namespace gar;
  const int tiles = (dout + kWsN - 1) / kWsN;
  if (rows < 1 || rows > kWsMaxRows || din <= 0 || din % 8 || dout <= 0 || dout % 8 ||
      layer < 0 || layer >= n_layers || splits < 1 || splits > kWsMaxSplits ||
      (splits & (splits - 1)) || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  if (const int err = stacked_weight_map(&maps.w[0], w_all, 2, n_layers, din, dout, kWsN, kWsBK))
    return err;
  StreamArgs a = stream_args(x, layer, rows, din, splits);
  a.seg[0] = stream_seg<bf16>(out, dout);
  return launch_rows<bf16, 1, kXBoxes>(maps, a, tiles, splits, stream);
}

// Kernel H8: (x @ w_all[layer]) * s_all[layer]; w_all (n_layers, din, dout)
// int8, s_all (n_layers, 1, dout) fp32; over clusters of `splits` CTAs (a
// power of two up to 16). din a multiple of 8, dout of 16, rows 1-32,
// bases 16-byte aligned.
extern "C" int gar_layer_matmul_q8(const void* x, const void* w_all, const void* s_all, void* out,
                                   int layer, int n_layers, int rows, int din, int dout,
                                   int splits, void* stream) {
  using namespace gar;
  constexpr int BN = ws_n<int8_t>();
  const int tiles = (dout + BN - 1) / BN;
  if (rows < 1 || rows > kWsMaxRows || din <= 0 || din % 8 || dout <= 0 || dout % 16 ||
      layer < 0 || layer >= n_layers || splits < 1 || splits > kWsMaxSplits ||
      (splits & (splits - 1)) || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  if (const int err = stacked_weight_map(&maps.w[0], w_all, 1, n_layers, din, dout, BN, kWsBK))
    return err;
  StreamArgs a = stream_args(x, layer, rows, din, splits);
  a.seg[0] = stream_seg<int8_t>(
      out, dout, static_cast<const float*>(s_all) + static_cast<size_t>(layer) * dout);
  return launch_rows<int8_t, 1, kXBoxes>(maps, a, tiles, splits, stream);
}

// Kernel I: silu(x @ wg_all[layer]) * (x @ wu_all[layer]); wg_all, wu_all
// (n_layers, din, m) bf16; over clusters of `splits` CTAs (a power of two
// up to 16). din and m multiples of 8, rows 1-32, bases 16-byte aligned.
extern "C" int gar_layer_swiglu(const void* x, const void* wg_all, const void* wu_all, void* out,
                                int layer, int n_layers, int rows, int din, int m, int splits,
                                void* stream) {
  using namespace gar;
  const int tiles = (m + kWsN - 1) / kWsN;
  if (rows < 1 || rows > kWsMaxRows || din <= 0 || din % 8 || m <= 0 || m % 8 || layer < 0 ||
      layer >= n_layers || splits < 1 || splits > kWsMaxSplits || (splits & (splits - 1)) ||
      tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  if (const int err = stacked_weight_map(&maps.w[0], wg_all, 2, n_layers, din, m, kWsN, kWsBK))
    return err;
  if (const int err = stacked_weight_map(&maps.w[1], wu_all, 2, n_layers, din, m, kWsN, kWsBK))
    return err;
  StreamArgs a = stream_args(x, layer, rows, din, splits);
  a.seg[0] = stream_seg<bf16>(out, m);
  return launch_rows<bf16, 2, kXBoxes>(maps, a, tiles, splits, stream);
}

// Kernel I8: silu((x @ wg_all[layer]) * sg_all[layer]) * ((x @ wu_all[layer])
// * su_all[layer]); wg_all, wu_all (n_layers, din, m) int8, sg_all, su_all
// (n_layers, 1, m) fp32; over clusters of `splits` CTAs (a power of two up
// to 16). din a multiple of 8, m of 16, rows 1-32, bases 16-byte aligned.
extern "C" int gar_layer_swiglu_q8(const void* x, const void* wg_all, const void* sg_all,
                                   const void* wu_all, const void* su_all, void* out, int layer,
                                   int n_layers, int rows, int din, int m, int splits,
                                   void* stream) {
  using namespace gar;
  constexpr int BN = ws_n<int8_t>();
  const int tiles = (m + BN - 1) / BN;
  if (rows < 1 || rows > kWsMaxRows || din <= 0 || din % 8 || m <= 0 || m % 16 || layer < 0 ||
      layer >= n_layers || splits < 1 || splits > kWsMaxSplits || (splits & (splits - 1)) ||
      tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamMaps maps{};
  if (const int err = stacked_weight_map(&maps.w[0], wg_all, 1, n_layers, din, m, BN, kWsBK))
    return err;
  if (const int err = stacked_weight_map(&maps.w[1], wu_all, 1, n_layers, din, m, BN, kWsBK))
    return err;
  const size_t at = static_cast<size_t>(layer) * m;
  StreamArgs a = stream_args(x, layer, rows, din, splits);
  a.seg[0] = stream_seg<int8_t>(out, m, static_cast<const float*>(sg_all) + at,
                                static_cast<const float*>(su_all) + at);
  return launch_rows<int8_t, 2, kXBoxes>(maps, a, tiles, splits, stream);
}

// Kernel 19: RMSNorm(x) rounded to bf16 @ wq, wk, wv[layer] (n_layers, d,
// hq / hk / hk) bf16, rotate-half rope on q and k from the (rows, cw_q) and
// (rows, cw_k) fp32 tables (cw 64 or the segment's width); over clusters of
// `splits` CTAs (a power of two up to 8). d a multiple of 8, hq and hk of
// 64, rows 1-32, bases 16-byte aligned.
extern "C" int gar_qkv_norm_rope(const void* x, const void* norm_all, const void* wq,
                                 const void* wk, const void* wv, const void* cos_q,
                                 const void* sin_q, const void* cos_k, const void* sin_k, void* q,
                                 void* k, void* v, int layer, int n_layers, int rows, int d,
                                 int hq, int hk, int cw_q, int cw_k, int splits, float eps,
                                 void* stream) {
  const void* w[3] = {wq, wk, wv};
  const void* tables[4] = {cos_q, sin_q, cos_k, sin_k};
  void* out[3] = {q, k, v};
  return gar::qkv_norm_rope<gar::bf16>(x, norm_all, w, nullptr, tables, out, layer, n_layers,
                                       rows, d, hq, hk, cw_q, cw_k, splits, eps, stream);
}

// Kernel 20: kernel 19 over int8 weights with fp32 (n_layers, 1, N) column
// scales, xn kept as two bf16 halves; clusters of up to 16.
extern "C" int gar_qkv_norm_rope_q8(const void* x, const void* norm_all, const void* wq,
                                    const void* sq, const void* wk, const void* sk,
                                    const void* wv, const void* sv, const void* cos_q,
                                    const void* sin_q, const void* cos_k, const void* sin_k,
                                    void* q, void* k, void* v, int layer, int n_layers, int rows,
                                    int d, int hq, int hk, int cw_q, int cw_k, int splits,
                                    float eps, void* stream) {
  const void* w[3] = {wq, wk, wv};
  const void* s[3] = {sq, sk, sv};
  const void* tables[4] = {cos_q, sin_q, cos_k, sin_k};
  void* out[3] = {q, k, v};
  return gar::qkv_norm_rope<int8_t>(x, norm_all, w, s, tables, out, layer, n_layers, rows, d, hq,
                                    hk, cw_q, cw_k, splits, eps, stream);
}

// Kernel J: x @ wq, wk, wv[layer], each (n_layers, d, hq / hk / hk) bf16,
// over clusters of `splits` CTAs a column tile (a power of two up to 16).
// d, hq and hk multiples of 8, rows 1-32, bases 16-byte aligned.
extern "C" int gar_layer_qkv(const void* x, const void* wq, const void* wk, const void* wv,
                             void* q, void* k, void* v, int layer, int n_layers, int rows, int d,
                             int hq, int hk, int splits, void* stream) {
  const void* w[3] = {wq, wk, wv};
  void* out[3] = {q, k, v};
  return gar::layer_qkv<gar::bf16>(x, w, nullptr, out, layer, n_layers, rows, d, hq, hk, splits,
                                   stream);
}

// Kernel J8: kernel J over int8 weights with fp32 (n_layers, 1, N) column
// scales on the summed columns; hq and hk multiples of 16.
extern "C" int gar_layer_qkv_q8(const void* x, const void* wq, const void* sq, const void* wk,
                                const void* sk, const void* wv, const void* sv, void* q, void* k,
                                void* v, int layer, int n_layers, int rows, int d, int hq, int hk,
                                int splits, void* stream) {
  const void* w[3] = {wq, wk, wv};
  const void* s[3] = {sq, sk, sv};
  void* out[3] = {q, k, v};
  return gar::layer_qkv<int8_t>(x, w, s, out, layer, n_layers, rows, d, hq, hk, splits, stream);
}
