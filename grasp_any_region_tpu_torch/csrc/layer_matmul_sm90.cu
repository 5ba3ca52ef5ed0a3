// Kernel H for Hopper: x (B <= 32, Din) @ w_all[layer] for the stacked
// (L, Din, Dout) bf16 weight read in place, fp32 sums rounded once to bf16.
// Replaces grasp_any_region_tpu/ops/layer_matmul.py:layer_matmul
// (_mm_kernel); the fused decode step calls it twice a layer (wo, w_down).
//
// What bounds it: at B = 1 each weight byte feeds one FLOP, so the time is
// the time to stream the weight from HBM (GAR-1B: 8.4 MB for wo, 33.6 MB
// for w_down, 2.5 and 10 us at 3.35 TB/s). A call of 10-26 us is as much
// fixed cost (launch, ramp, the reduction at the end) as streaming, so the
// design streams fast from the first microsecond and keeps the end short:
//
//  * The weight comes in by TMA: one tensor map over the (Dout, Din, L)
//    view, boxes of 64 columns x 128 rows (16 KB, 128-byte swizzle), the
//    layer a coordinate, so one map serves every layer. Rows past Din and
//    columns past Dout are outside the map and land as zeros. The map is
//    encoded once per weight tensor (sm90.cuh:stacked_weight_map caches it
//    by base and shape), so a call costs the host no more than the
//    cp.async form did.
//  * A CTA owns 64 output columns (a tile) and a K range of k_split rows, a
//    multiple of the box; the S CTAs of a tile form a thread-block cluster.
//    S (ops/layer_matmul.py:stream_splits) doubles while the grid stays
//    within two CTAs an SM (w_down and wo: 32 tiles x 8 = 256 CTAs).
//  * One producer thread keeps a ring of three stages in flight: each stage
//    one weight box by TMA and the matching 128 columns of every x row by
//    1D bulk copies (no tensor map), on one mbarrier. Three stages (50-75
//    KB a CTA) let three or four CTAs share an SM, so all 32 clusters of 8
//    are resident at once; rings of 4-12 stages measured slower where that
//    no longer held (ab_kernels.py). The producer issues the first weight
//    boxes before waiting on the kernel before this one (programmatic
//    dependent launch: the weights never depend on it); x is copied, and
//    out written, only after griddepcontrol.wait.
//  * Four consumer warps own 16 of the tile's columns each, over every row
//    of a stage: mma.sync m16n8k16 with x as the A operand (rows past B
//    zero, 16 or 32 rows) read from the stage's x rows (at a pitch of 272
//    bytes: no bank conflicts), and the weight as B through ldmatrix.trans
//    of the swizzled rows (conflict-free). At B = 1 the tensor cores idle
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
// a SwiGLU's gate and up, silu(gate) * up in the epilogue) as template
// parameters, so kernels I, J and the int8 H8-J8 can move onto it; only H
// (bf16, one weight) is instantiated here, and they stay on
// layer_matmul.cu's cp.async body.
#include <cooperative_groups.h>

#include <algorithm>

#include "sm90.cuh"
#include "weight_tile.cuh"  // opt_in

namespace gar {

namespace cg = cooperative_groups;

constexpr int kWsN = 64;          // output columns a tile: one 128-byte swizzle row
constexpr int kWsBK = 128;        // weight rows (and x columns) a stage: 16 KB a weight
constexpr int kWsStages = 3;      // the ring (fewer only where a stage would not fit kWsCtaSmem)
constexpr int kWsConsumers = 4;   // warp w multiplies columns 16 w .. 16 w + 15
constexpr int kWsThreads = 32 * (kWsConsumers + 1);  // and one producer warp
constexpr int kWsMaxSplits = 16;  // Hopper's largest (non-portable) cluster
constexpr int kWsMaxRows = 32;
constexpr int kWsBox = kWsBK * kWsN * 2;  // bytes of one weight's stage
constexpr int kWsXPitch = kWsBK * 2 + 16;  // bytes between a stage's x rows: no bank conflicts
constexpr int kWsCtaSmem = 232448 / 2 - 1024;  // two CTAs an SM, each with its 1 KB reserve
constexpr int kWsFixed = 1024 + 2 * kWsStages * 8;  // the alignment slack and the barriers

struct StreamMaps {
  CUtensorMap w[2];  // each weight as (Dout, Din, L, 1), box (64, 128, 1, 1)
};

struct StreamArgs {
  const bf16* x;  // (rows, din)
  bf16* out;      // (rows, dout)
  int layer, rows, din, dout;
  int k_split;    // weight rows a CTA of a cluster: a multiple of kWsBK
  int stages;     // of the ring, 2 .. kWsStages
};

// Bytes of one stage: NW weight boxes and `rows` x rows.
template <int NW>
__host__ __device__ constexpr int ws_stage(int rows) {
  return NW * kWsBox + rows * kWsXPitch;
}

// Bytes of the partials a CTA receives: NW x (rows, 64) fp32, from every CTA
// of its cluster its columns of the tile.
template <int NW>
__host__ __device__ constexpr int ws_recv(int rows) {
  return NW * rows * kWsN * 4;
}

// Grid (S, tiles), cluster (S, 1, 1).
template <typename W, int NW, int MT>
__global__ void __launch_bounds__(kWsThreads)
    weight_stream_kernel(const __grid_constant__ StreamMaps maps, const StreamArgs a) {
  using namespace sm90;
  static_assert(sizeof(W) == 2,
                "bf16 weights: int8 ones need widen_i8x4 (weight_tile.cuh) and column scales");
  static_assert(NW == 1 || NW == 2, "one weight, or a SwiGLU's gate and up");
  extern __shared__ uint8_t smem_raw[];
  // (1024-aligned) [stages][NW] weight boxes, [stages] x rows, the
  // barriers, and the partials this CTA receives
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = a.stages, x_stage = a.rows * kWsXPitch;
  uint8_t* xs = sm + stages * NW * kWsBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * ws_stage<NW>(a.rows));
  uint64_t* empty = full + kWsStages;
  float* recv = reinterpret_cast<float*>(empty + kWsStages);  // [NW][splits][rows][64 / S]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * kWsN;
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

  float acc[NW][MT][2][4];  // this warp's (16 MT, 16) partial of each weight
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
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
    // ldmatrix.x4.trans: lane l addresses row l % 8 of matrix l / 8 = (k half,
    // 8-column chunk): b[0], b[1] the B fragment of this warp's columns
    // 16 w .. 16 w + 7, b[2], b[3] of + 8 .. + 15; chunk c of row r sits at
    // c ^ (r % 8)
    const int kr = ((lane >> 3) & 1) * 8 + (lane & 7), ch = 2 * warp + (lane >> 4);
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
        const int r = kr + 16 * h;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(sm + (s * NW + w) * kWsBox +
                                                             r * 128 + ((ch ^ (r & 7)) << 4)));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16_16816(acc[w][i][0], xa[i], b[0], b[1]);
            mma_bf16_16816(acc[w][i][1], xa[i], b[2], b[3]);
          }
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

  // CTA q finishes columns [q 64 / S, (q + 1) 64 / S) of the tile: each warp
  // stores its columns of this CTA's partial into their finisher's shared
  // memory (a partial never waits for a remote load), the cluster syncs
  // once, and each CTA sums what it received in rank order
  const int cols = kWsN / splits;
  if (warp < kWsConsumers) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * i + g + 8 * (e >> 1), col = 16 * warp + 8 * j + 2 * t + (e & 1);
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
    // a SwiGLU: silu(gate) * up in fp32, one rounding
    const float o = NW == 2 ? v[0] / (1.f + expf(-v[0])) * v[NW - 1] : v[0];
    a.out[static_cast<size_t>(row) * a.dout + n0 + rank * cols + c] = __float2bfloat16(o);
  }
}

// One launch with a cluster of `splits` and programmatic stream
// serialization, the ring as deep as two CTAs an SM allow; the first opts
// the kernel in to its shared memory and to clusters of 16.
template <typename W, int NW, int MT>
int launch_stream(const StreamMaps& maps, StreamArgs a, int tiles, int splits,
                  cudaStream_t stream) {
  const auto kernel = weight_stream_kernel<W, NW, MT>;
  static bool opted_in = false;
  if (const int err = opt_in(kernel, kWsCtaSmem, true, opted_in)) return err;
  a.stages = std::min(kWsStages,
                      (kWsCtaSmem - kWsFixed - ws_recv<NW>(a.rows)) / ws_stage<NW>(a.rows));
  if (a.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kWsThreads, 1, 1);
  cfg.dynamicSmemBytes = a.stages * ws_stage<NW>(a.rows) + kWsFixed + ws_recv<NW>(a.rows);
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
                     dout, (per + kWsBK - 1) / kWsBK * kWsBK, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 16) return launch_stream<bf16, 1, 1>(maps, a, tiles, splits, s);
  return launch_stream<bf16, 1, 2>(maps, a, tiles, splits, s);
}
