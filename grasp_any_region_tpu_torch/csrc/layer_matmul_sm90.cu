// Kernels H, H8, I and I8 for Hopper: x (B <= 32, Din) @ w_all[layer] for
// the stacked (L, Din, Dout) weights read in place, fp32 sums rounded once
// to bf16. They replace grasp_any_region_tpu/ops/layer_matmul.py's
// layer_matmul (_mm_kernel, H), layer_matmul_q8 (_mm_q8_kernel, H8),
// layer_swiglu (_swiglu_kernel, I) and layer_swiglu_q8 (_swiglu_q8_kernel,
// I8). H and H8 are called twice a layer by the fused decode step (wo,
// w_down), I and I8 once. H8 is (x w_q8[l]) s[l], int8 weights with one
// fp32 scale a column; I is silu(x wg[l]) * (x wu[l]); I8 is
// silu((x wg_q8[l]) sg[l]) * ((x wu_q8[l]) su[l]). SiLU and the product
// are in fp32 from the fp32 sums, one rounding. The int8 kernels put the
// scale on the summed column (the TPU kernels scale the widened weight
// before the sum; the scale is constant along it, so this equals it up to
// fp32 reassociation). GAR-1B streams 8.4 / 4.2 MB (wo, bf16 / int8),
// 33.6 / 16.8 MB (w_down) and 67.1 / 33.6 MB (gate and up) a call.
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
// The body takes the weight type and the number of weights a stage (NW = 2:
// a SwiGLU's gate and up, two boxes a stage, silu(gate) * up in the
// epilogue) as template parameters: H is (bf16, 1), H8 (int8, 1), I (bf16,
// 2), I8 (int8, 2); the int8 finisher puts each column's scale on its
// summed weight. J and J8 stay on layer_matmul.cu's cp.async body, where
// the earlier forms of H, H8, I and I8 stay callable (gar_*_ring) for
// chip_smoke.py's side-by-side timing. A SwiGLU's stage at GAR-1B holds 2 x
// 16 KB of boxes: at B = 24 three such stages and the partials fit only a
// CTA alone on its SM, so a grid within one CTA an SM takes a whole SM's
// shared memory (launch_stream); the CTAs an SM are measured
// (ops/layer_matmul.py: STREAM_CTAS_PER_SM, STREAM_CTAS_PER_SM_Q8).
#include <cooperative_groups.h>

#include <algorithm>

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

// Columns a tile: one 128-byte swizzle row, 64 bf16 or 128 int8.
template <typename W>
__host__ __device__ constexpr int ws_n() {
  return 128 / static_cast<int>(sizeof(W));
}

struct StreamMaps {
  CUtensorMap w[2];  // each weight as (Dout, Din, L, 1), box (ws_n, 128, 1, 1)
  CUtensorMap x;     // x as (Din, rows, 1, 1), box (64, ws_x_rows, 1, 1)
};

struct StreamArgs {
  const bf16* x;  // (rows, din)
  bf16* out;      // (rows, dout)
  int layer, rows, din, dout;
  int k_split;    // weight rows a CTA of a cluster: a multiple of kWsBK
  int stages;     // of the ring, 2 .. kWsStages
  const float* scale[2];  // int8: each weight's column scales at the layer, (dout,)
};

// x rows a stage holds: B rounded up to 8, so each 128-byte-wide x box is
// whole 1024-byte swizzle atoms (and starts on one).
__host__ __device__ constexpr int ws_x_rows(int rows) {
  return (rows + 7) / 8 * 8;
}

// Bytes of one stage: NW weight boxes and two x boxes of ws_x_rows rows.
template <int NW>
__host__ __device__ constexpr int ws_stage(int rows) {
  return NW * kWsBox + 2 * 128 * ws_x_rows(rows);
}

// Bytes of the partials a CTA receives: NW x (rows, tile) fp32, from every
// CTA of its cluster its columns of the tile.
template <typename W, int NW>
__host__ __device__ constexpr int ws_recv(int rows) {
  return NW * rows * ws_n<W>() * 4;
}

// Grid (S, tiles), cluster (S, 1, 1).
template <typename W, int NW, int MT>
__global__ void __launch_bounds__(kWsThreads)
    weight_stream_kernel(const __grid_constant__ StreamMaps maps, const StreamArgs a) {
  using namespace sm90;
  constexpr bool Q8 = sizeof(W) == 1;
  constexpr int BN = ws_n<W>();           // columns a tile
  constexpr int WN = BN / kWsConsumers;  // a warp's: 16 bf16, 32 int8
  constexpr int NT = WN / 8;             // its n-tiles: 2, 4
  static_assert(sizeof(W) == 2 || Q8, "bf16 or int8 weights");
  static_assert(NW == 1 || NW == 2, "one weight, or a SwiGLU's gate and up");
  extern __shared__ uint8_t smem_raw[];
  // (1024-aligned) [stages][NW] weight boxes, [stages][2] x boxes, the
  // barriers, and the partials this CTA receives
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = a.stages, xr = ws_x_rows(a.rows), x_box = 128 * xr;
  uint8_t* xs = sm + stages * NW * kWsBox;  // [stages][2] x boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * ws_stage<NW>(a.rows));
  uint64_t* empty = full + kWsStages;
  float* recv = reinterpret_cast<float*>(empty + kWsStages);  // [NW][splits][rows][BN / S]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * BN;
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
    if (lane == 0) {
      // stage j's bytes: NW weight boxes and two x boxes, each counted whole
      // (zero-filled past Din and past B); a stage never reaches past k_end
      // but at Din, since k_split is a multiple of the stage
      auto weights = [&](int j, int s) {
        mbar_arrive_expect_tx(&full[s], NW * kWsBox + 2 * x_box);
#pragma unroll
        for (int w = 0; w < NW; ++w)
          tma_load_4d(sm + (s * NW + w) * kWsBox, &maps.w[w], &full[s], n0, k_begin + j * kWsBK,
                      a.layer, 0);
      };
      const int ahead = min(n_stages, stages);
      for (int j = 0; j < ahead; ++j) weights(j, j);  // the weights wait for nothing
      grid_dependency_wait();                          // x is the kernel before's output
      for (int j = 0; j < n_stages; ++j) {
        const int s = j % stages;
        if (j >= ahead) {
          mbar_wait(&empty[s], ((j / stages) - 1) & 1);
          weights(j, s);
        }
        for (int b = 0; b < 2; ++b)
          tma_load_4d(xs + (2 * s + b) * x_box, &maps.x, &full[s],
                      k_begin + j * kWsBK + kWsXBox * b, 0, 0, 0);
      }
    }
    // the warp whole again before the block barriers below: lanes reaching
    // __syncthreads while lane 0 still issued copies ran one barrier ahead
    // (the CTA's sums then read partials not yet written)
    __syncwarp();
  } else {
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
      // B = 1 took 0.55 and 0.9 us longer back to back, ab_kernels.py)
      uint32_t xa[2][MT][4], raw[2][NW][4];
      auto frags = [&](int h, int p) {
        const uint8_t* xbox = xs + (2 * s + (h >> 2)) * x_box;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int r = 16 * i + (lane & 15);
          if (r >= xr) r -= 8;
          const int c = 2 * (h & 3) + (lane >> 4);
          ldmatrix_x4(xa[p][i],
                      reinterpret_cast<const bf16*>(xbox + r * 128 + ((c ^ (r & 7)) << 4)));
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

  // CTA q finishes columns [q BN / S, (q + 1) BN / S) of the tile. This
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
  cluster_wait();  // every CTA of the cluster has started
  const int cols = BN / splits, quads = cols / 4, per_q = NW * a.rows * quads;
  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {
    const int q = e / per_q, f = e % per_q;   // finisher q, its f-th piece from this CTA
    const int wr = f / quads, c = 4 * (f % quads), w = wr / a.rows;  // wr = w rows + row
    const float4 v = *reinterpret_cast<const float4*>(part + wr * PP + q * cols + c);
    float* dst = cluster.map_shared_rank(recv, q) + ((w * splits + rank) * a.rows) * cols;
    *reinterpret_cast<float4*>(dst + (wr - w * a.rows) * cols + c) = v;
  }
  cluster.sync();  // every partial is in its finisher's shared memory; none is read remotely
  for (int e = threadIdx.x; e < a.rows * cols; e += kWsThreads) {
    const int row = e / cols, c = e % cols;
    if (n0 + rank * cols + c >= a.dout) continue;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      v[w] = 0.f;
      for (int r = 0; r < splits; ++r) v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];
    }
    if constexpr (Q8) {  // each weight's column scale on its summed column
      v[0] *= a.scale[0][n0 + rank * cols + c];
      if (NW == 2) v[NW - 1] *= a.scale[NW - 1][n0 + rank * cols + c];
    }
    // a SwiGLU: silu(gate) * up in fp32, one rounding
    const float o = NW == 2 ? v[0] / (1.f + expf(-v[0])) * v[NW - 1] : v[0];
    a.out[static_cast<size_t>(row) * a.dout + n0 + rank * cols + c] = __float2bfloat16(o);
  }
}

// One launch with a cluster of `splits` and programmatic stream
// serialization, x's tensor map encoded here (cached by address and shape,
// as the weights' are), the ring as deep as the CTA's share of an SM allows: a
// grid of at most one CTA an SM may take a whole SM's shared memory (a
// SwiGLU's three stages of gate and up at B = 24), a larger one half (two
// stages at least: one CTA an SM where two leave less); the first opts the
// kernel in to the most shared memory and to clusters of 16.
template <typename W, int NW, int MT>
int launch_stream(StreamMaps maps, StreamArgs a, int tiles, int splits, cudaStream_t stream) {
  const auto kernel = weight_stream_kernel<W, NW, MT>;
  static bool opted_in = false;
  if (const int err = opt_in(kernel, kWsSmemMax, true, opted_in)) return err;
  if (const int err =
          stacked_weight_map(&maps.x, a.x, 2, 1, a.rows, a.din, kWsXBox, ws_x_rows(a.rows)))
    return err;
  const int recv = ws_recv<W, NW>(a.rows);
  const int budget = tiles * splits <= card_sm_count() ? kWsSmemMax : kWsCtaSmem;
  a.stages = std::max(2, std::min(kWsStages, (budget - kWsFixed - recv) / ws_stage<NW>(a.rows)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kWsThreads, 1, 1);
  cfg.dynamicSmemBytes = a.stages * ws_stage<NW>(a.rows) + kWsFixed + recv;
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
  StreamMaps maps;
  if (const int err = stacked_weight_map(&maps.w[0], w_all, 2, n_layers, din, dout, kWsN, kWsBK))
    return err;
  const int per = (din + splits - 1) / splits;
  const StreamArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), layer, rows, din,
                     dout, (per + kWsBK - 1) / kWsBK * kWsBK, 0, {nullptr, nullptr}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 16) return launch_stream<bf16, 1, 1>(maps, a, tiles, splits, s);
  return launch_stream<bf16, 1, 2>(maps, a, tiles, splits, s);
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
  StreamMaps maps;
  if (const int err = stacked_weight_map(&maps.w[0], w_all, 1, n_layers, din, dout, BN, kWsBK))
    return err;
  const int per = (din + splits - 1) / splits;
  const float* scale = static_cast<const float*>(s_all) + static_cast<size_t>(layer) * dout;
  const StreamArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), layer, rows, din,
                     dout, (per + kWsBK - 1) / kWsBK * kWsBK, 0, {scale, nullptr}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 16) return launch_stream<int8_t, 1, 1>(maps, a, tiles, splits, s);
  return launch_stream<int8_t, 1, 2>(maps, a, tiles, splits, s);
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
  StreamMaps maps;
  if (const int err = stacked_weight_map(&maps.w[0], wg_all, 2, n_layers, din, m, kWsN, kWsBK))
    return err;
  if (const int err = stacked_weight_map(&maps.w[1], wu_all, 2, n_layers, din, m, kWsN, kWsBK))
    return err;
  const int per = (din + splits - 1) / splits;
  const StreamArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), layer, rows, din, m,
                     (per + kWsBK - 1) / kWsBK * kWsBK, 0, {nullptr, nullptr}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 16) return launch_stream<bf16, 2, 1>(maps, a, tiles, splits, s);
  return launch_stream<bf16, 2, 2>(maps, a, tiles, splits, s);
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
  StreamMaps maps;
  if (const int err = stacked_weight_map(&maps.w[0], wg_all, 1, n_layers, din, m, BN, kWsBK))
    return err;
  if (const int err = stacked_weight_map(&maps.w[1], wu_all, 1, n_layers, din, m, BN, kWsBK))
    return err;
  const int per = (din + splits - 1) / splits;
  const size_t at = static_cast<size_t>(layer) * m;
  const float* sg = static_cast<const float*>(sg_all) + at;
  const float* su = static_cast<const float*>(su_all) + at;
  const StreamArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), layer, rows, din, m,
                     (per + kWsBK - 1) / kWsBK * kWsBK, 0, {sg, su}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 16) return launch_stream<int8_t, 2, 1>(maps, a, tiles, splits, s);
  return launch_stream<int8_t, 2, 2>(maps, a, tiles, splits, s);
}
