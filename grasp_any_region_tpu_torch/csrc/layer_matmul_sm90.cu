// Kernels H and I8 for Hopper: x (B <= 32, Din) @ w_all[layer] for the
// stacked (L, Din, Dout) weights read in place, fp32 sums rounded once to
// bf16. H replaces grasp_any_region_tpu/ops/layer_matmul.py:layer_matmul
// (_mm_kernel), bf16, called twice a layer by the fused decode step (wo,
// w_down). I8 replaces layer_swiglu_q8 (_swiglu_q8_kernel) of the same
// file: silu((x wg_q8[l]) sg[l]) * ((x wu_q8[l]) su[l]), int8 gate and up
// with one fp32 scale a column, SiLU and the product in fp32 from the fp32
// sums, one rounding (the TPU kernel scales the widened weight before the
// sum; the scale is constant along it, so this equals it up to fp32
// reassociation). GAR-1B's gate and up are 2 x 2048 x 8192 int8, 33.6 MB.
//
// What bounds it: at B = 1 each weight byte feeds one FLOP, so the time is
// the time to stream the weight from HBM (GAR-1B: 8.4 MB for wo, 33.6 MB
// for w_down, 2.5 and 10 us at 3.35 TB/s). A call of 10-26 us is as much
// fixed cost (launch, ramp, the reduction at the end) as streaming, so the
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
//    S (ops/layer_matmul.py:stream_splits) doubles while the grid stays
//    within two CTAs an SM (w_down and wo: 32 tiles x 8 = 256 CTAs), for
//    I8 within one (gate and up: 64 tiles x 2, 1024 rows a CTA).
//  * One producer thread keeps a ring of three stages in flight: each stage
//    one weight box by TMA and the matching 128 columns of every x row by
//    1D bulk copies (no tensor map), on one mbarrier. Three stages (50-75
//    KB a CTA) let three or four CTAs share an SM, so all 32 clusters of 8
//    are resident at once; rings of 4-12 stages measured slower where that
//    no longer held (ab_kernels.py). The producer issues the first weight
//    boxes before waiting on the kernel before this one (programmatic
//    dependent launch: the weights never depend on it); x is copied, and
//    out written, only after griddepcontrol.wait.
//  * Four consumer warps own a quarter of the tile's columns each (16 bf16
//    or 32 int8), over every row of a stage: mma.sync m16n8k16 with x as
//    the A operand (rows past B zero, 16 or 32 rows) read from the stage's
//    x rows (at a pitch of 272 bytes: no bank conflicts), and the weight as
//    B through ldmatrix.trans of the swizzled rows (conflict-free), int8
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
//    columns [r 64 / S, (r + 1) 64 / S) of the tile, so each warp stores
//    its columns of its CTA's (rows, 64) partial straight into the
//    finishing CTA's shared memory (distributed shared memory), the
//    cluster syncs once, and each CTA sums what it received in rank order.
//    (Pulling the partials with remote loads took a second barrier, to
//    keep a CTA alive while its peers read it, and measured slower at
//    B = 24.) A cluster barrier arrived at when a CTA starts, and waited on
//    before its first remote store, makes sure every peer has started. No
//    workspace, no atomics, and the result does not depend on timing
//    (ops/layer_matmul.py:layer_matmul_stream_plain mirrors this order on
//    the CPU).
//
// The body takes the weight type and the number of weights a stage (NW = 2:
// a SwiGLU's gate and up, two boxes a stage, silu(gate) * up in the
// epilogue) as template parameters: H is (bf16, 1), I8 (int8, 2), whose
// finisher puts each column's scales on its summed gate and up. I, J, H8
// and J8 stay on layer_matmul.cu's cp.async body, where I8's earlier form
// stays callable (gar_layer_swiglu_q8_ring) for chip_smoke.py's side-by-
// side timing. Gate and up at GAR-1B: 2 x 16 KB a stage, three stages,
// one CTA an SM (two, each with half an SM's shared memory, measured
// slower: ops/layer_matmul.py:STREAM_CTAS_PER_SM_Q8).
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
constexpr int kWsXPitch = kWsBK * 2 + 16;  // bytes between a stage's x rows: no bank conflicts
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
};

struct StreamArgs {
  const bf16* x;  // (rows, din)
  bf16* out;      // (rows, dout)
  int layer, rows, din, dout;
  int k_split;    // weight rows a CTA of a cluster: a multiple of kWsBK
  int stages;     // of the ring, 2 .. kWsStages
  const float* scale[2];  // int8: each weight's column scales at the layer, (dout,)
};

// Bytes of one stage: NW weight boxes and `rows` x rows.
template <int NW>
__host__ __device__ constexpr int ws_stage(int rows) {
  return NW * kWsBox + rows * kWsXPitch;
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
  // (1024-aligned) [stages][NW] weight boxes, [stages] x rows, the
  // barriers, and the partials this CTA receives
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = a.stages, x_stage = a.rows * kWsXPitch;
  uint8_t* xs = sm + stages * NW * kWsBox;
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

  if (warp == kWsConsumers) {  // the producer: one thread
    if (lane == 0) {
      // stage j's bytes: NW boxes (zero-filled past Din, counted whole) and
      // each x row's columns of the stage up to k_end
      auto x_bytes = [&](int j) { return 2 * min(kWsBK, k_end - k_begin - j * kWsBK); };
      auto weights = [&](int j, int s) {
        mbar_arrive_expect_tx(&full[s], NW * kWsBox + a.rows * x_bytes(j));
#pragma unroll
        for (int w = 0; w < NW; ++w)
          tma_load_4d(sm + (s * NW + w) * kWsBox, &maps.w[w], &full[s], n0,
                      k_begin + j * kWsBK, a.layer, 0);
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
        for (int r = 0; r < a.rows; ++r)
          bulk_load(xs + s * x_stage + r * kWsXPitch,
                    a.x + static_cast<size_t>(r) * a.din + k_begin + j * kWsBK, x_bytes(j),
                    &full[s]);
      }
    }
    // the warp whole again before the block barriers below: lanes 1-31
    // reaching __syncthreads while lane 0 still issues copies let them run
    // one barrier ahead (the CTA's sums then read partials not yet written)
    __syncwarp();
  } else {
    // B fragments from ldmatrix.x4.trans of this warp's 16-byte chunks 2 w,
    // 2 w + 1 of 16 rows (weight_tile.cuh:box_frags; chunk c of row r sits
    // at c ^ (r % 8)): bf16 columns 16 w .. 16 w + 7, then + 8 .. + 15; int8
    // the even and the odd columns of 32 w .. 32 w + 15, then of + 16 ..
    // + 31, widened (frag_col says where each sum lands)
    for (int j = 0; j < n_stages; ++j) {
      const int s = j % stages;
      const int k_left = k_end - k_begin - j * kWsBK;  // x columns of this stage, from 0
      mbar_wait(&full[s], (j / stages) & 1);
      const uint8_t* xrow = xs + s * x_stage;
#pragma unroll
      for (int h = 0; h < kWsBK / 16; ++h) {
        // x as the A fragments of k-step h: for row tile i, a[0] = x[16 i +
        // g][16 h + 2t ..], a[1] = row + 8, a[2] = column + 8, a[3] both;
        // rows past B and columns past k_end are zeros
        uint32_t xa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * i + g + 8 * (e & 1), k = 16 * h + 2 * t + 8 * (e >> 1);
            xa[i][e] = r < a.rows && k < k_left
                           ? *reinterpret_cast<const uint32_t*>(xrow + r * kWsXPitch + 2 * k)
                           : 0u;
          }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t raw[4], b[NT][2];
          box_frags(raw, sm + (s * NW + w) * kWsBox, 16 * h, 2 * warp, lane);
          b_frags<W, NT>(b, raw);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[w][i][n], xa[i], b[n][0], b[n][1]);
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
  cluster_wait();          // every CTA of the cluster has started

  // CTA q finishes columns [q BN / S, (q + 1) BN / S) of the tile: each
  // warp stores its columns of this CTA's partial into their finisher's
  // shared memory (a partial never waits for a remote load), the cluster
  // syncs once, and each CTA sums what it received in rank order
  const int cols = BN / splits;
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
            if (row < a.rows)
              cluster.map_shared_rank(recv, col / cols)[((w * splits + rank) * a.rows + row) *
                                                            cols + col % cols] = acc[w][i][j][e];
          }
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
    if constexpr (Q8) {  // the column scales on the summed gate and up
      v[0] *= a.scale[0][n0 + rank * cols + c];
      if (NW == 2) v[NW - 1] *= a.scale[NW - 1][n0 + rank * cols + c];
    }
    // a SwiGLU: silu(gate) * up in fp32, one rounding
    const float o = NW == 2 ? v[0] / (1.f + expf(-v[0])) * v[NW - 1] : v[0];
    a.out[static_cast<size_t>(row) * a.dout + n0 + rank * cols + c] = __float2bfloat16(o);
  }
}

// One launch with a cluster of `splits` and programmatic stream
// serialization, the ring as deep as the CTA's share of an SM allows: a
// grid of at most one CTA an SM (I8 at GAR-1B) may take a whole SM's
// shared memory (I8's three stages of gate and up at B = 24), a larger one
// half (two stages at least: one CTA an SM where two leave less); the
// first opts the kernel in to the most shared memory and to clusters of
// 16.
template <typename W, int NW, int MT>
int launch_stream(const StreamMaps& maps, StreamArgs a, int tiles, int splits,
                  cudaStream_t stream) {
  const auto kernel = weight_stream_kernel<W, NW, MT>;
  static bool opted_in = false;
  if (const int err = opt_in(kernel, kWsSmemMax, true, opted_in)) return err;
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
// multiples of 8, rows 1-32, bases 16-byte aligned (x's rows too: 16-byte
// bulk copies).
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
