// Kernels 23 and 21 for Hopper: one token's MLP of a decoder layer with its
// RMSNorm and residual, x + (SiLU(xn Wg) * (xn Wu)) Wd with xn = RMSNorm(x),
// the stacked (L, d, m) gate and up and (L, m, d) down weights read in place
// at a layer.
//
// 23 replaces grasp_any_region_tpu/ops/decode_megakernel.py:
//    layer_mlp_residual (_mlp_kernel): bf16 weights; xn and the activation
//    rounded to bf16, the sum over m in fp32, one rounding after the
//    residual.
// 21 replaces layer_mlp_residual_q8 (_mlp_q8_kernel): int8 weights with fp32
//    column scales on the fp32 sums; xn rounded, the activation kept fp32 as
//    a bf16 high half and low half (hi = bf16(v), lo = bf16(v - hi)), two
//    products with each w_down fragment.
//
// What bounds them: at B = 1 each weight byte feeds one multiply-add, so the
// time is the time to stream the weights (GAR-1B: 100.7 MB bf16, 50.3 MB
// int8; 30 and 15 us at 3.35 TB/s). The design is kernel H's weight stream
// (layer_matmul_sm90.cu) spread over every SM:
//
//  * A tile is 128 of the m MLP columns. Its S CTAs form a cluster and split
//    gate and up over K (ops/decode_megakernel.py:mlp_splits; GAR-1B: 64
//    tiles x 4 = 256 CTAs, two an SM, and the chooser asks
//    cudaOccupancyMaxActiveClusters that every cluster fits in one wave).
//  * One producer warp keeps a ring of three 16 KB stages in flight by TMA
//    from one cached tensor map per weight over the stack (the layer a
//    coordinate; 128-byte boxes: 128 int8 or 64 bf16 columns): first the
//    CTA's gate and up boxes over its K range, then its boxes of w_down,
//    with an L2 evict-first policy (read once: the workspace stays in the
//    L2). The first stages go out before griddepcontrol.wait (programmatic
//    dependent launch: the weights never depend on the kernel before); the
//    producer never reads x.
//  * Four consumer warps, after the wait: the RMSNorm of the x rows (whole
//    rows, fp32 squares) and xn over the CTA's K range into shared memory,
//    once, rounded to bf16 as both TPU kernels round it. Each warp then owns
//    32 of the tile's columns over every row of a stage: mma.sync m16n8k16
//    with xn as A and the weight as B through ldmatrix.trans of the swizzled
//    rows, int8 widened exactly to bf16 in registers (widen_i8x4). A stage
//    goes back one stage late behind fence.proxy.async.
//  * Gate and up meet in the cluster: each CTA leaves its partials in its
//    own shared memory, the cluster syncs, and CTA r sums columns [r 128 / S,
//    (r + 1) 128 / S) over the ranks in rank order (distributed shared
//    memory), puts the int8 scales on, forms SiLU(gate) * up (23: rounded;
//    21: hi and lo) and stores it into every CTA of the cluster, which syncs
//    again.
//  * CTA r then streams the tile's 128 rows of w_down for its share of the
//    d output columns, one 128-row box a column block (blocks c with (c +
//    tile) % S == r), and writes each block's (B, columns) fp32 partial (21:
//    times the column scale) to the tile's workspace slot.
//  * The sum over tiles needs no cooperative launch: after its last block,
//    the CTA fences once and arrives at each of its blocks' ordered
//    last-arriver sums (ordered_sum.cuh), which add the tiles in groups of 8
//    in tile order, then the groups, plus x, rounded once; the counters are
//    0 between launches. (A fence and an arrival a block cost 9-22 us a
//    launch; at B = 24 the CTA that arrives last in a group still sums its 8
//    blocks' groups, PERF.md.)
//
// Limits: B <= 32 rows, d and m multiples of 128, clusters of 1-16.
#include <cooperative_groups.h>

#include "ordered_sum.cuh"
#include "rms_prologue.cuh"  // rms_rstd, rms_pair
#include "sm90.cuh"
#include "weight_tile.cuh"  // box_frags, b_frags, frag_col, opt_in, launch_ex

namespace gar {

namespace cg = cooperative_groups;

constexpr int kMlpBN = 128;             // MLP columns a tile
constexpr int kMlpStage = 16384;        // bytes a stage: gate and up boxes, or one w_down box
constexpr int kMlpStages = 3;
constexpr int kMlpConsumers = 4;        // warp w multiplies columns 32 w .. 32 w + 31 of a tile
constexpr int kMlpThreads = 32 * (kMlpConsumers + 1);  // and one producer warp
constexpr int kMlpMaxSplits = 16;       // Hopper's largest (non-portable) cluster
constexpr int kMlpMaxRows = 32;
constexpr int kMlpMaxCounters = 3072;   // the ordered sums' counters: blocks x (groups + 1)
constexpr int kMlpMaxBoxes = 64;        // w_down column blocks a CTA
constexpr int kMlpSlotPad = 64;         // floats between workspace slots: a slot's same column
                                        // lands in another part of the L2 than the last's
constexpr int kMlpSmemCap = 220 * 1024;  // the kernel's opt-in (227 KB less its static memory)

template <typename W>
struct MlpShape {
  static constexpr bool Q8 = sizeof(W) == 1;
  static constexpr int CPB = 128 / sizeof(W);  // columns a box row: 128 int8, 64 bf16
  static constexpr int R1 = kMlpStage / (2 * kMlpBN * static_cast<int>(sizeof(W)));  // K rows a gate / up stage
  static constexpr int BOXES = kMlpBN / CPB;   // boxes across a tile: 1 int8, 2 bf16
  static constexpr int BOX1 = R1 * 128;        // bytes of a gate or up box
  static constexpr int NT2 = CPB / 32;         // w_down: n-tiles of a warp's CPB / 4 columns
  static_assert(2 * BOXES * BOX1 == kMlpStage && CPB * sizeof(W) * kMlpBN == kMlpStage,
                "a stage is 16 KB either way");
};

struct MlpMaps {
  CUtensorMap gate, up;  // (m, d, L, 1), boxes (CPB, R1)
  CUtensorMap down;      // (d, m, L, 1), boxes (CPB, 128)
};

struct MlpArgs {
  const bf16* x;     // (rows, d)
  const bf16* norm;  // (d,) the layer's RMSNorm weight
  const float* sg;   // int8: the column scales at the layer, (m,), (m,), (d,)
  const float* su;
  const float* sd;
  bf16* out;           // (rows, d)
  float* ws;           // (tiles + groups) slots of rows x d + kMlpSlotPad: the tiles', the group sums'
  unsigned* counters;  // (d / CPB) x (groups + 1), 0 between launches
  int layer, rows, d, m;
  int k_split;  // K rows a CTA of a cluster: a multiple of R1
  int xpitch;   // bf16 elements between xn's rows in shared memory
  float eps;
};

// Bytes of the (1024-aligned) dynamic shared memory: the ring, xn (which the
// gate and up partials then take over) and the activation.
template <typename W, int MT>
__host__ __device__ constexpr int mlp_region(int xpitch) {
  return 16 * MT * xpitch * 2 > 2 * 16 * MT * kMlpBN * 4 ? 16 * MT * xpitch * 2
                                                         : 2 * 16 * MT * kMlpBN * 4;
}

template <typename W, int MT>
__host__ __device__ constexpr int mlp_act_bytes() {
  return 16 * MT * (kMlpBN + 8) * 2 * (sizeof(W) == 1 ? 2 : 1);
}

template <typename W, int MT>
constexpr int mlp_smem(int xpitch) {
  return 1024 + kMlpStages * kMlpStage + mlp_region<W, MT>(xpitch) + mlp_act_bytes<W, MT>();
}

// The A fragments of row tiles 0 .. MT - 1 at columns k0 .. k0 + 15 of a
// bf16 [rows][pitch] matrix in shared memory; rows past `rows` are zeros.
template <int MT>
__device__ __forceinline__ void a_frags(uint32_t (&xa)[MT][4], const bf16* m, int pitch, int rows,
                                        int k0, int g, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * i + g + 8 * (e & 1), k = k0 + 2 * t + 8 * (e >> 1);
      xa[i][e] = r < rows ? ld_u32(m + r * pitch + k) : 0u;
    }
}

__device__ __forceinline__ void consumer_sync() { sm90::bar_sync(1, 32 * kMlpConsumers); }

// Grid (S, tiles), cluster (S, 1, 1).
template <typename W, int MT>
__global__ void __launch_bounds__(kMlpThreads, MT == 1 ? 3 : 2)  // the CTAs an SM holds
    mlp_stream_kernel(const __grid_constant__ MlpMaps maps, const MlpArgs a) {
  using namespace sm90;
  using Sh = MlpShape<W>;
  constexpr bool Q8 = Sh::Q8;
  constexpr int ROWS = 16 * MT, LDA = kMlpBN + 8, NT2 = Sh::NT2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kMlpStages], empty[kMlpStages];
  __shared__ float rstd[ROWS];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* xn = reinterpret_cast<bf16*>(ring + kMlpStages * kMlpStage);  // [rows][xpitch]
  float* part = reinterpret_cast<float*>(xn);  // then [2][ROWS][128], then the sums' lists
  bf16* act = reinterpret_cast<bf16*>(ring + kMlpStages * kMlpStage +
                                      mlp_region<W, MT>(a.xpitch));   // [ROWS][LDA]
  bf16* act_lo = act + ROWS * LDA;                                     // int8: the low half
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.y, tiles = gridDim.y, m0 = tile * kMlpBN;
  const int k_begin = rank * a.k_split, k_end = min(a.d, k_begin + a.k_split);
  const int n1 = k_end > k_begin ? (k_end - k_begin + Sh::R1 - 1) / Sh::R1 : 0;
  // w_down's column blocks: CTA `rank` of tile t takes the blocks c with (c +
  // t) % S == rank, so the CTAs that finish a block's sum differ from block
  // to block (ordered_sum.cuh)
  const int blocks = a.d / Sh::CPB, blk0 = ((rank - tile) % splits + splits) % splits;
  const int n2 = blk0 < blocks ? (blocks - blk0 + splits - 1) / splits : 0;
  auto block_of = [&](int j) { return blk0 + j * splits; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMlpStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMlpConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kMlpConsumers) {  // the producer: lane 0 issues, the warp keeps together
    // the weights are read once: evict them first, so the workspace the
    // ordered sums read back stays in the L2
    const uint64_t policy = l2_evict_first();
    auto issue = [&](int j, int s) {
      uint8_t* st = ring + s * kMlpStage;
      mbar_arrive_expect_tx(&full[s], kMlpStage);  // boxes count whole, zero fill included
      if (j < n1) {
        const int k = k_begin + j * Sh::R1;
#pragma unroll
        for (int bx = 0; bx < Sh::BOXES; ++bx) {
          tma_load_4d_hint(st + bx * Sh::BOX1, &maps.gate, &full[s], m0 + bx * Sh::CPB, k,
                           a.layer, 0, policy);
          tma_load_4d_hint(st + kMlpStage / 2 + bx * Sh::BOX1, &maps.up, &full[s],
                           m0 + bx * Sh::CPB, k, a.layer, 0, policy);
        }
      } else {
        tma_load_4d_hint(st, &maps.down, &full[s], block_of(j - n1) * Sh::CPB, m0, a.layer, 0,
                         policy);
      }
    };
    // a stage past n1 + kMlpStages reuses one that w_down's products free,
    // which the consumers start only after the cluster's two syncs: the
    // producer joins them first
    const int n = n1 + n2;
    bool synced = false;
    for (int j = 0; j < n; ++j) {
      if (j == n1 + kMlpStages) {
        cluster.sync();
        cluster.sync();
        synced = true;
      }
      if (lane == 0) {
        const int s = j % kMlpStages;
        if (j >= kMlpStages) mbar_wait(&empty[s], ((j / kMlpStages) - 1) & 1);
        issue(j, s);
      }
      __syncwarp();
    }
    if (!synced) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // ---- consumers: xn over [k_begin, k_begin + xpitch - 8), once
  const int tid = threadIdx.x;
  grid_dependency_wait();  // x is the kernel before's output
  rms_rstd(rstd, a.x, a.rows, a.d, a.eps, warp, kMlpConsumers, lane);
  consumer_sync();
  const int half = (a.xpitch - 8) / 2;  // column pairs a row
#pragma unroll 4
  for (int e = tid; e < a.rows * half; e += 32 * kMlpConsumers) {
    const int r = e / half, c = 2 * (e % half), k = k_begin + c;
    float2 v = make_float2(0.f, 0.f);
    if (k < k_end) v = rms_pair(a.x + r * a.d, a.norm, rstd[r], k);
    *reinterpret_cast<__nv_bfloat162*>(xn + r * a.xpitch + c) = __floats2bfloat162_rn(v.x, v.y);
  }
  consumer_sync();

  auto release = [&](int j) {  // stage j's products are issued, so its reads are done
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kMlpStages]);
  };

  // ---- gate and up over this CTA's K range
  float acc[2][MT][4][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[w][i][n][0] = acc[w][i][n][1] = acc[w][i][n][2] = acc[w][i][n][3] = 0.f;
  for (int j = 0; j < n1; ++j) {
    const int s = j % kMlpStages;
    mbar_wait(&full[s], (j / kMlpStages) & 1);
    const uint8_t* st = ring + s * kMlpStage;
#pragma unroll
    for (int h = 0; h < Sh::R1 / 16; ++h) {
      uint32_t xa[MT][4];
      a_frags<MT>(xa, xn, a.xpitch, a.rows, j * Sh::R1 + 16 * h, g, t);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint8_t* box = st + w * (kMlpStage / 2);
        uint32_t bfr[4][2];
        if constexpr (Q8) {
          uint32_t raw[4];
          box_frags(raw, box, 16 * h, 2 * warp, lane);
          b_frags<W, 4>(bfr, raw);
        } else {  // warp w's 32 columns: box w / 2, chunks (w % 2) 4 .. + 3
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t raw[4];
            box_frags(raw, box + (warp >> 1) * Sh::BOX1, 16 * h, (warp & 1) * 4 + 2 * p, lane);
            bfr[2 * p][0] = raw[0], bfr[2 * p][1] = raw[1];
            bfr[2 * p + 1][0] = raw[2], bfr[2 * p + 1][1] = raw[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16_16816(acc[w][i][n], xa[i], bfr[n][0], bfr[n][1]);
      }
    }
    if (j > 0) release(j - 1);
  }
  if (n1 > 0) release(n1 - 1);  // w_down's first boxes may follow at once

  // ---- gate and up meet in the cluster
  consumer_sync();  // every warp is done with xn: its memory takes the partials
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1);
          const int col = frag_col<W>(n, e & 1, 32 * warp, t);
          if (row < a.rows) part[(w * ROWS + row) * kMlpBN + col] = acc[w][i][n][e];
        }
  cluster.sync();  // every CTA's partials are in its shared memory
  {
    const int cols = kMlpBN / splits, c0 = rank * cols;
    for (int e = tid; e < a.rows * cols; e += 32 * kMlpConsumers) {
      const int row = e / cols, col = c0 + e % cols;
      float gv[kMlpMaxSplits], uv[kMlpMaxSplits];
#pragma unroll
      for (int r = 0; r < kMlpMaxSplits; ++r)  // every remote load issued before the first is used
        if (r < splits) {
          const float* peer = cluster.map_shared_rank(part, r);
          gv[r] = peer[row * kMlpBN + col];
          uv[r] = peer[(ROWS + row) * kMlpBN + col];
        }
      float gs = 0.f, us = 0.f;
#pragma unroll
      for (int r = 0; r < kMlpMaxSplits; ++r)
        if (r < splits) gs += gv[r], us += uv[r];
      if constexpr (Q8) {
        gs *= a.sg[m0 + col];
        us *= a.su[m0 + col];
      }
      const float v = gs / (1.f + expf(-gs)) * us;  // SiLU(gate) * up in fp32
      const bf16 hi = __float2bfloat16(v);
      const bf16 lo = __float2bfloat16(v - __bfloat162float(hi));
      for (int r = 0; r < splits; ++r) {
        cluster.map_shared_rank(act, r)[row * LDA + col] = hi;
        if constexpr (Q8) cluster.map_shared_rank(act_lo, r)[row * LDA + col] = lo;
      }
    }
  }
  cluster.sync();  // the activation is whole in every CTA; no shared memory is read remotely again

  // ---- this CTA's w_down column blocks: act @ the tile's 128 rows, each
  // block's partial into the tile's slot; then one release fence and the
  // arrivals at every block's ordered sum at once (a fence a block measured
  // 9-22 us a launch), and the sums of the groups this CTA completed
  const long long slot_stride = static_cast<long long>(a.rows) * a.d + kMlpSlotPad;
  const SumPlan plan{a.ws, slot_stride, a.d, tiles, a.rows, a.x, a.out, a.d, a.counters};
  int* list = reinterpret_cast<int*>(part);  // the sums' list and flags
  int* flags = list + kMlpMaxBoxes;
  float* slot = a.ws + tile * slot_stride;
  const int wn = warp * (Sh::CPB / 4);
  for (int j = 0; j < n2; ++j) {
    const int jj = n1 + j, s = jj % kMlpStages;
    mbar_wait(&full[s], (jj / kMlpStages) & 1);
    const uint8_t* box = ring + s * kMlpStage;
    float acc2[MT][NT2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT2; ++n) acc2[i][n][0] = acc2[i][n][1] = acc2[i][n][2] = acc2[i][n][3] = 0.f;
#pragma unroll
    for (int h = 0; h < kMlpBN / 16; ++h) {
      uint32_t raw[4], bfr[NT2][2];
      box_frags(raw, box, 16 * h, 2 * warp, lane);
      b_frags<W, NT2>(bfr, raw);
#pragma unroll
      for (int half_ = 0; half_ < (Q8 ? 2 : 1); ++half_) {
        uint32_t xa[MT][4];
        a_frags<MT>(xa, half_ ? act_lo : act, LDA, a.rows, 16 * h, g, t);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT2; ++n) mma_bf16_16816(acc2[i][n], xa[i], bfr[n][0], bfr[n][1]);
      }
    }
    if (j > 0) release(jj - 1);
    const int blk = block_of(j), c0 = blk * Sh::CPB;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1), col = c0 + frag_col<W>(n, e & 1, wn, t);
          if (row < a.rows) {
            float v = acc2[i][n][e];
            if constexpr (Q8) v *= a.sd[col];
            slot[static_cast<size_t>(row) * a.d + col] = v;
          }
        }
  }
  consumer_sync();  // every warp's stores are issued
  if (warp == 0)
    for (int j = lane; j < n2; j += 32)
      flags[j] = sum_completed(plan, block_of(j), tile, sum_arrive(plan, block_of(j), tile));
  consumer_sync();
  if (tid == 0) {  // the blocks whose group this CTA completed
    int m = 0;
    for (int j = 0; j < n2; ++j)
      if (flags[j]) list[m++] = block_of(j);
    flags[kMlpMaxBoxes - 1] = m;
  }
  consumer_sync();
  const int m = flags[kMlpMaxBoxes - 1];
  consumer_sync();
  if (m > 0)
    sum_finish<32 * kMlpConsumers, MT == 1 ? 2 : 4>(plan, tile, Sh::CPB, list, m, flags,
                                   [](int blk) { return blk * Sh::CPB; }, tid, consumer_sync);
}

// K rows a CTA and xn's pitch, for d split over `splits`.
template <typename W>
void mlp_plan(int d, int splits, int* k_split, int* xpitch) {
  constexpr int R1 = MlpShape<W>::R1;
  *k_split = ((d + splits - 1) / splits + R1 - 1) / R1 * R1;
  *xpitch = (*k_split + 63) / 64 * 64 + 8;  // 16-byte rows, no bank conflicts
}

template <typename W, int MT>
int mlp_opt_in() {
  static bool done = false;
  return opt_in(mlp_stream_kernel<W, MT>, kMlpSmemCap, true, done);
}

template <typename W, int MT>
int launch_mlp(const MlpMaps& maps, const MlpArgs& a, int splits, cudaStream_t stream) {
  const int smem = mlp_smem<W, MT>(a.xpitch);
  if (smem > kMlpSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = mlp_opt_in<W, MT>()) return err;
  return launch_ex(mlp_stream_kernel<W, MT>, dim3(splits, a.m / kMlpBN, 1), kMlpThreads, smem,
                   splits, true, stream, maps, a);
}

template <typename W, int MT>
int max_clusters(int d, int splits) {
  int k_split, xpitch;
  mlp_plan<W>(d, splits, &k_split, &xpitch);
  const int smem = mlp_smem<W, MT>(xpitch);
  if (smem > kMlpSmemCap) return 0;
  if (const int err = mlp_opt_in<W, MT>()) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(kMlpThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, mlp_stream_kernel<W, MT>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename W>
int mlp_residual(const void* x, const void* norm_all, const void* const* w,
                 const void* const* s, void* out, void* ws, void* counters, int layer,
                 int n_layers, int rows, int d, int m, int splits, float eps, void* stream) {
  using Sh = MlpShape<W>;
  if (rows < 1 || rows > kMlpMaxRows || d <= 0 || m <= 0 || d % kMlpBN || m % kMlpBN ||
      layer < 0 || layer >= n_layers || splits < 1 || splits > kMlpMaxSplits ||
      (splits & (splits - 1)) || m / kMlpBN > 65535 ||
      (d / Sh::CPB + splits - 1) / splits > kMlpMaxBoxes - 1 ||
      d / Sh::CPB * ((m / kMlpBN + kSumGroup - 1) / kSumGroup + 1) > kMlpMaxCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpMaps maps;
  constexpr int eb = sizeof(W);
  if (int err = stacked_weight_map(&maps.gate, w[0], eb, n_layers, d, m, Sh::CPB, Sh::R1))
    return err;
  if (int err = stacked_weight_map(&maps.up, w[1], eb, n_layers, d, m, Sh::CPB, Sh::R1))
    return err;
  if (int err = stacked_weight_map(&maps.down, w[2], eb, n_layers, m, d, Sh::CPB, kMlpBN))
    return err;
  MlpArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.norm = static_cast<const bf16*>(norm_all) + static_cast<size_t>(layer) * d;
  if (s) {
    a.sg = static_cast<const float*>(s[0]) + static_cast<size_t>(layer) * m;
    a.su = static_cast<const float*>(s[1]) + static_cast<size_t>(layer) * m;
    a.sd = static_cast<const float*>(s[2]) + static_cast<size_t>(layer) * d;
  }
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned*>(counters);
  a.layer = layer;
  a.rows = rows;
  a.d = d;
  a.m = m;
  a.eps = eps;
  mlp_plan<W>(d, splits, &a.k_split, &a.xpitch);
  auto st = static_cast<cudaStream_t>(stream);
  return rows <= 16 ? launch_mlp<W, 1>(maps, a, splits, st) : launch_mlp<W, 2>(maps, a, splits, st);
}

}  // namespace gar

using gar::bf16;

// Kernel 23: x (rows, d) + the MLP of layer `layer` of the stacked bf16 wg,
// wu (n_layers, d, m) and wd (n_layers, m, d), over clusters of `splits`
// CTAs (a power of two up to 16). ws: T + ceil(T / 8) slots of rows x d +
// 64 fp32, T = m / 128 tiles; counters: d / 64 x (ceil(T / 8) + 1)
// unsigned, 0 (and left at 0). Bases 16-byte aligned.
extern "C" int gar_mlp_residual(const void* x, const void* norm_all, const void* wg,
                                const void* wu, const void* wd, void* out, void* ws,
                                void* counters, int layer, int n_layers, int rows, int d, int m,
                                int splits, float eps, void* stream) {
  const void* w[3] = {wg, wu, wd};
  return gar::mlp_residual<bf16>(x, norm_all, w, nullptr, out, ws, counters, layer, n_layers,
                                 rows, d, m, splits, eps, stream);
}

// Kernel 21: kernel 23 over int8 weights with fp32 (n_layers, 1, N) column
// scales; counters: d / 128 x (ceil(T / 8) + 1).
extern "C" int gar_mlp_residual_q8(const void* x, const void* norm_all, const void* wg,
                                   const void* sg, const void* wu, const void* su,
                                   const void* wd, const void* sd, void* out, void* ws,
                                   void* counters, int layer, int n_layers, int rows, int d,
                                   int m, int splits, float eps, void* stream) {
  const void* w[3] = {wg, wu, wd};
  const void* s[3] = {sg, su, sd};
  return gar::mlp_residual<int8_t>(x, norm_all, w, s, out, ws, counters, layer, n_layers, rows, d,
                                   m, splits, eps, stream);
}

// How many clusters of `splits` CTAs of kernel 21 (q8) or 23 fit on the
// current card at once for `rows` rows and width d (0 if a CTA would not
// fit; a negative CUDA error).
extern "C" int gar_mlp_max_clusters(int q8, int rows, int d, int splits) {
  if (rows < 1 || rows > gar::kMlpMaxRows || d <= 0 || splits < 1 || splits > gar::kMlpMaxSplits)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (q8) return rows <= 16 ? gar::max_clusters<int8_t, 1>(d, splits)
                            : gar::max_clusters<int8_t, 2>(d, splits);
  return rows <= 16 ? gar::max_clusters<bf16, 1>(d, splits) : gar::max_clusters<bf16, 2>(d, splits);
}
