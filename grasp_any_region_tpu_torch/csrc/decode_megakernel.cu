// Kernels 19-23: the mega decode step, one token of a decoder layer in three
// launches (grasp_any_region_tpu/ops/decode_megakernel.py).
//
// 19 replaces layer_qkv_norm_rope (_qkv_kernel): RMSNorm(x) rounded to bf16,
//    its q, k, v products with wq/wk/wv[l] as fp32 sums, rotate-half rope on
//    the q and k sums in fp32, one rounding each.
// 20 replaces layer_qkv_norm_rope_q8 (_qkv_q8_kernel): 19 over int8 weights
//    with fp32 column scales; xn stays fp32.
// 23 replaces layer_mlp_residual (_mlp_kernel): x + (SiLU(xn @ wg[l]) *
//    (xn @ wu[l])) @ wd[l], xn and the activation rounded to bf16, the sum
//    over M in fp32 and one rounding after the residual.
// 21 replaces layer_mlp_residual_q8 (_mlp_q8_kernel): 23 over int8 weights;
//    the activation stays fp32, w_down's column scale on its fp32 sums.
// 22 replaces decode_attention_wo (_attn_wo_kernel): kernel C's attention
//    (with the KV append at write_pos), then a @ the kv head's rows of
//    wo[l] (bf16, or int8 with fp32 column scales), summed over the kv heads
//    in head order, plus the residual, rounded once.
//
// What bounds them: at B = 1 every weight byte feeds one multiply-add, so
// the time is the time to stream the weights (GAR-1B: 12.6 MB of q/k/v,
// 100.7 MB of MLP, 8.4 MB of wo; half of each in int8) and, for 22, the
// cache. The designs keep bytes in flight:
//
//  * 19 / 20 are kernel J's design (layer_matmul.cu): a block owns 64 bf16
//    or 128 int8 output columns and a slice of K, K split over a cluster
//    whose partials meet in distributed shared memory, weights streamed
//    through a four-slab cp.async ring, mma.sync on the tensor cores. The
//    RMSNorm prologue: each block takes the sum of squares of whole x rows
//    (B x 2048, small) and turns each x slab into xn in shared memory as it
//    lands. The rope epilogue: a 64-column head lies in one column tile, so
//    the rank that finishes column c also sums its partner c +- 32 over the
//    cluster's partials.
//  * 23 / 21: a block owns 64 bf16 (128 int8) columns of M. It streams its
//    gate and up columns over all of K through an eight-slab ring (one
//    block an SM, so it keeps seven slabs in flight), keeps SiLU(gate) * up
//    in shared memory, then streams its rows of w_down, which it asked the
//    L2 to fetch during the first phase, one 64-column (128) output tile at
//    a time into a workspace slot of its own. A cooperative launch keeps
//    every block resident (M / 64 or M / 128 blocks, at most one an SM), so
//    all meet at a grid barrier; then each block sums its share of the
//    output over the slots in a fixed order (the bits do not depend on
//    timing), adds the residual and rounds once. The barrier's count is
//    back at 0 after the launch, so a launch can be replayed.
//  * 22: a cluster of the K kv-head blocks of one batch row. Each asks the
//    L2 to fetch its G * 64 rows of wo, runs kernel C's one-block body
//    (decode_tile.cuh) meanwhile, rounds a to bf16 and multiplies it by
//    those rows with 16-byte loads on the CUDA cores; the K partials meet
//    in distributed shared memory in rank order. At B = 1 the grid has K
//    blocks, each streaming its cache slab and 1 MB of wo (GAR-1B): the
//    grid, not the bytes, sets the time (split-KV and wo tiling are later
//    work).
//
// The fp32 operands of 20 (xn) and 21 (the activation) meet the tensor cores
// as a bf16 high half and low half (hi = bf16(v), lo = bf16(v - hi)), two
// products with each weight fragment: 16 significant bits, where one bf16
// rounding would keep 8.
//
// Limits, as H-J and C: B <= 32 rows, head_dim 64, 1, 2, 4 or 8 query heads
// per kv head and at most 8 kv heads (22); D and M multiples of 128 (21,
// 23); column counts whole heads (19, 20).
#include <cooperative_groups.h>

#include "decode_tile.cuh"
#include "weight_tile.cuh"

namespace cg = cooperative_groups;

namespace gar {

int lm_splits(int tiles, int din, int max_splits);  // layer_matmul.cu

constexpr int kMkThreads = 128;  // four warps, a quarter of a weight tile's columns each
constexpr int kMkStages = 4;     // slabs in 19 / 20's ring: three loads in flight
constexpr int kMlpStages = 8;    // in 21 / 23's: seven (one block a column slice, one per SM)
constexpr int kMkMaxRows = 32;

// rstd[r] = rsqrt(mean(x[r]^2) + eps) over the whole row (d a multiple of 8;
// fp32 squares), 0 for the zero-filled rows r >= rows. One warp a row.
__device__ __forceinline__ void row_rstd(float* rstd, const bf16* x, int rows, int rows_pad,
                                         int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows_pad; r += kMkThreads / 32) {
    float s = 0.f;
    if (r < rows) {
      const bf16* row = x + static_cast<long long>(r) * d;
      for (int c = lane * 8; c < d; c += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          s += f.x * f.x + f.y * f.y;
        }
      }
    }
    s = warp_sum(s);
    if (lane == 0) rstd[r] = r < rows ? rsqrtf(s / static_cast<float>(d) + eps) : 0.f;
  }
}

// In place: each element of a landed x slab (K offset kb) becomes xn =
// x * rstd[row] * w[k] in fp32 (JAX's order), rounded to bf16; with lo,
// the remainder bf16(xn - bf16(xn)) goes to lo's slab.
template <int ROWS>
__device__ __forceinline__ void norm_slab(bf16* sx, bf16* lo, const float* rstd, const bf16* w,
                                          int kb, int k_end) {
  for (int e = threadIdx.x; e < ROWS * (kWBK / 2); e += kMkThreads) {
    const int r = e / (kWBK / 2), c = (e % (kWBK / 2)) * 2, k = kb + c;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sx + r * kXLd + c);
    const float2 v = __bfloat1622float2(*p);
    const float2 wf = k < k_end ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k))
                                : make_float2(0.f, 0.f);
    const float a = v.x * rstd[r] * wf.x, b = v.y * rstd[r] * wf.y;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
    *p = hi;
    if (lo) {
      const float2 h = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(lo + r * kXLd + c) = __floats2bfloat162_rn(a - h.x, b - h.y);
    }
  }
}

// All blocks of a cooperative launch meet here. sync[0] counts arrivals
// and is back at 0 when the barrier opens (a launch can be replayed);
// sync[1] is bumped to open it.
__device__ __forceinline__ void grid_barrier(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;  // read before arriving: it cannot move until this block arrives
    __threadfence();          // this block's writes are visible before its arrival
    if (atomicAdd(sync, 1u) == gridDim.x * gridDim.y * gridDim.z - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Ask the L2 to fetch `bytes` from p and keep them (evict_last), one
// 128-byte line a thread at a time: for weights a block reads only after
// a first phase, so their loads then hit the L2.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = static_cast<size_t>(threadIdx.x) * 128; off < bytes;
       off += static_cast<size_t>(blockDim.x) * 128)
    asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(c + off));
}

// ---------------------------------------------------------------- 19 / 20

template <typename W>
struct QkvSeg {
  const W* w;        // (din, n) at the layer
  const float* s;    // int8: the column scales (n,) at the layer
  const float* cos;  // q and k: the rope tables (rows, cos_width); v: null
  const float* sin;
  bf16* out;         // (rows, n)
  int n, tiles, cos_width;
};

template <typename W>
struct QkvParams {
  const bf16* x;     // (rows, din)
  const bf16* norm;  // (din,) the layer's RMSNorm weight
  QkvSeg<W> seg[3];  // q, k, v
  int rows, din, k_split;
  float eps;
};

template <typename W, int MT>
struct QkvShape {
  static constexpr int ROWS = 16 * MT;
  static constexpr int X_BYTES = ROWS * kXLd * 2;
  static constexpr int STAGE = WTile<W>::BYTES + X_BYTES * (WTile<W>::Q8 ? 2 : 1);
  static constexpr int SMEM = kMkStages * STAGE;
  static_assert(ROWS * WTile<W>::BN * 4 <= SMEM, "the partials reuse the ring");
  static_assert(STAGE % 16 == 0 && X_BYTES % 16 == 0, "16-byte aligned slabs");
};

// Grid (S, tiles), cluster (S, 1, 1): the S blocks of a cluster share one
// column tile and split its K, as kernel J.
template <typename W, int MT>
__global__ void __launch_bounds__(kMkThreads) qkv_norm_rope_kernel(const QkvParams<W> p) {
  using T = WTile<W>;
  using Sh = QkvShape<W, MT>;
  constexpr bool Q8 = T::Q8;
  constexpr int ROWS = Sh::ROWS, BN = T::BN, NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float rstd[ROWS];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;
  int tile = blockIdx.y;
  int si = 0;
  while (si < 2 && tile >= p.seg[si].tiles) tile -= p.seg[si++].tiles;
  const QkvSeg<W> seg = p.seg[si];
  const int n0 = tile * BN;
  const int k_begin = split * p.k_split, k_end = min(p.din, k_begin + p.k_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + kWBK - 1) / kWBK : 0;
  const int tid = threadIdx.x, lane = tid & 31, wn = (tid >> 5) * T::WN;
  auto w_slab = [&](int st) { return reinterpret_cast<W*>(smem_raw + st * Sh::STAGE); };
  auto x_slab = [&](int st, int h) {
    return reinterpret_cast<bf16*>(smem_raw + st * Sh::STAGE + T::BYTES + h * Sh::X_BYTES);
  };

  row_rstd(rstd, p.x, p.rows, ROWS, p.din, p.eps);  // read after the ring's first barrier
  float acc[MT][NT][4];
  zero(acc);
  ring<kMkStages>(nk, [&](int kt) {
    const int st = kt % kMkStages, kb = k_begin + kt * kWBK;
    load_weight_slab<W, kMkThreads>(w_slab(st), seg.w + static_cast<long long>(kb) * seg.n + n0,
                                    seg.n, k_end - kb, seg.n - n0, tid);
    load_x_slab<ROWS, kMkThreads>(x_slab(st, 0), p.x, p.rows, p.din, kb, k_end);
  }, [&](int kt) {
    const int st = kt % kMkStages, kb = k_begin + kt * kWBK;
    norm_slab<ROWS>(x_slab(st, 0), Q8 ? x_slab(st, 1) : nullptr, rstd, p.norm, kb, k_end);
    __syncthreads();
    mma_slab<W, MT, Q8>(acc, x_slab(st, 0), x_slab(st, 1), kXLd, w_slab(st), wn, lane);
  });

  float* part = reinterpret_cast<float*>(smem_raw);  // [ROWS][BN] fp32, in the free ring
  each_sum<W, MT>(acc, wn, lane, [&](int row, int col, float v) { part[row * BN + col] = v; });
  cluster.sync();  // every block's partials are in its shared memory

  // Block `split` finishes columns [c0, c0 + cols) of the tile: the S
  // partials in rank order, the int8 scales, then rope from the column's
  // sum and its rotate-half partner's (c + 32 in the first half of a head,
  // c - 32 in the second).
  const int cols = BN / splits, c0 = split * cols;
  for (int e = tid; e < p.rows * cols; e += kMkThreads) {
    const int row = e / cols, col = c0 + e % cols, gc = n0 + col;
    if (gc >= seg.n) continue;
    const bool second = col & 32;
    const int pc = second ? col - 32 : col + 32;
    float v = 0.f, pv = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* peer = cluster.map_shared_rank(part, r);
      v += peer[row * BN + col];
      if (seg.cos) pv += peer[row * BN + pc];
    }
    if constexpr (Q8) {
      v *= seg.s[gc];
      pv *= seg.s[n0 + pc];
    }
    if (seg.cos) {
      const int ti = row * seg.cos_width + gc % seg.cos_width;
      v = v * seg.cos[ti] + (second ? pv : -pv) * seg.sin[ti];
    }
    seg.out[static_cast<long long>(row) * seg.n + gc] = __float2bfloat16(v);
  }
  cluster.sync();  // no block leaves while a peer may still read its partials
}

template <typename W, int MT>
int launch_qkv_mt(QkvParams<W> p, int tiles, cudaStream_t stream) {
  using Sh = QkvShape<W, MT>;
  auto kernel = qkv_norm_rope_kernel<W, MT>;
  static bool done = false;
  if (const int err = opt_in(kernel, Sh::SMEM, WTile<W>::Q8, done)) return err;
  const int splits = lm_splits(tiles, p.din, WTile<W>::Q8 ? 16 : 8);
  p.k_split = ((p.din + splits - 1) / splits + 15) / 16 * 16;
  return launch_ex(kernel, dim3(splits, tiles, 1), kMkThreads, Sh::SMEM, splits, stream, p);
}

template <typename W>
int qkv_norm_rope(const void* x, const void* norm_all, const void* const* w,
                  const void* const* s, const void* const* tables, void* const* out, int layer,
                  int rows, int d, int hq, int hk, int cw_q, int cw_k, float eps, void* stream) {
  if (rows < 1 || rows > kMkMaxRows || d <= 0 || d % 8 || hq % 64 || hk % 64 || hq <= 0 ||
      hk <= 0 || cw_q <= 0 || cw_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  QkvParams<W> p{};
  p.x = static_cast<const bf16*>(x);
  p.norm = static_cast<const bf16*>(norm_all) + static_cast<long long>(layer) * d;
  p.rows = rows;
  p.din = d;
  p.eps = eps;
  const int ns[3] = {hq, hk, hk}, cws[3] = {cw_q, cw_k, 0};
  int tiles = 0;
  for (int i = 0; i < 3; ++i) {
    QkvSeg<W>& g = p.seg[i];
    g.w = static_cast<const W*>(w[i]) + static_cast<long long>(layer) * d * ns[i];
    g.s = s ? static_cast<const float*>(s[i]) + static_cast<long long>(layer) * ns[i] : nullptr;
    g.cos = i < 2 ? static_cast<const float*>(tables[2 * i]) : nullptr;
    g.sin = i < 2 ? static_cast<const float*>(tables[2 * i + 1]) : nullptr;
    g.out = static_cast<bf16*>(out[i]);
    g.n = ns[i];
    g.cos_width = cws[i];
    g.tiles = (ns[i] + WTile<W>::BN - 1) / WTile<W>::BN;
    tiles += g.tiles;
  }
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return rows <= 16 ? launch_qkv_mt<W, 1>(p, tiles, st) : launch_qkv_mt<W, 2>(p, tiles, st);
}

// ---------------------------------------------------------------- 23 / 21

template <typename W>
struct MlpParams {
  const bf16* x;               // (rows, d)
  const bf16* norm;            // (d,) the layer's RMSNorm weight
  const W* wg;                 // (d, m) at the layer
  const W* wu;
  const W* wd;                 // (m, d) at the layer
  const float* sg;             // int8: column scales (m,), (m,), (d,) at the layer
  const float* su;
  const float* sd;
  bf16* out;                   // (rows, d)
  float* ws;                   // (blocks, rows, d) fp32 partials, one slot a block
  unsigned* sync;              // (2,) grid_barrier's words, sync[0] = 0 between launches
  int rows, d, m;
  float eps;
};

template <typename W, int MT>
struct MlpShape {
  static constexpr int ROWS = 16 * MT;
  static constexpr int LDA = WTile<W>::BN + kGemmPad;  // activation pitch
  static constexpr int STAGE = 2 * WTile<W>::BYTES + ROWS * kXLd * 2;
  static constexpr int RING = kMlpStages * STAGE;
  static constexpr int ACT = ROWS * LDA * 2;  // bytes of one bf16 half of the activation
  static constexpr int SMEM = RING + ACT * (WTile<W>::Q8 ? 2 : 1);
  static_assert(STAGE % 16 == 0 && ACT % 16 == 0, "16-byte aligned slabs");
};

// Grid (m / BN): block j owns columns [j BN, (j + 1) BN) of the MLP.
template <typename W, int MT>
__global__ void __launch_bounds__(kMkThreads) mlp_residual_kernel(const MlpParams<W> p) {
  using T = WTile<W>;
  using Sh = MlpShape<W, MT>;
  constexpr bool Q8 = T::Q8;
  constexpr int ROWS = Sh::ROWS, BN = T::BN, NT = T::NT, LDA = Sh::LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float rstd[ROWS];
  __shared__ float4 sums[kMkThreads];  // the reduction's partial sums
  const int blk = blockIdx.x, nblk = gridDim.x, m0 = blk * BN;
  const int tid = threadIdx.x, lane = tid & 31, wn = (tid >> 5) * T::WN;
  auto w_slab = [&](int st, int w) {
    return reinterpret_cast<W*>(smem_raw + st * Sh::STAGE + w * T::BYTES);
  };
  auto x_slab = [&](int st) {
    return reinterpret_cast<bf16*>(smem_raw + st * Sh::STAGE + 2 * T::BYTES);
  };
  bf16* act = reinterpret_cast<bf16*>(smem_raw + Sh::RING);
  bf16* act_lo = act + ROWS * LDA;  // int8 only

  // gate and up of this block's columns over all of K = d, w_down's rows on
  // their way to the L2 meanwhile
  prefetch_l2(p.wd + static_cast<long long>(m0) * p.d, static_cast<size_t>(BN) * p.d * sizeof(W));
  row_rstd(rstd, p.x, p.rows, ROWS, p.d, p.eps);  // read after the ring's first barrier
  float acc[2][MT][NT][4];
  zero(acc[0]);
  zero(acc[1]);
  ring<kMlpStages>((p.d + kWBK - 1) / kWBK, [&](int kt) {
    const int st = kt % kMlpStages, kb = kt * kWBK;
    const long long at = static_cast<long long>(kb) * p.m + m0;
    load_weight_slab<W, kMkThreads>(w_slab(st, 0), p.wg + at, p.m, p.d - kb, BN, tid);
    load_weight_slab<W, kMkThreads>(w_slab(st, 1), p.wu + at, p.m, p.d - kb, BN, tid);
    load_x_slab<ROWS, kMkThreads>(x_slab(st), p.x, p.rows, p.d, kb, p.d);
  }, [&](int kt) {
    const int st = kt % kMlpStages;
    norm_slab<ROWS>(x_slab(st), nullptr, rstd, p.norm, kt * kWBK, p.d);
    __syncthreads();
    mma_slab<W, MT, false>(acc[0], x_slab(st), nullptr, kXLd, w_slab(st, 0), wn, lane);
    mma_slab<W, MT, false>(acc[1], x_slab(st), nullptr, kXLd, w_slab(st, 1), wn, lane);
  });

  // act = SiLU(gate) * up in fp32 (silu(g) = g * sigmoid(g)): 23 rounds it
  // to bf16, 21 keeps it as bf16 hi + lo
  float(&up)[MT][NT][4] = acc[1];
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = i * 16 + g + 8 * (q >> 1), col = frag_col<W>(j, q & 1, wn, t);
        float gt = acc[0][i][j][q], u = up[i][j][q];
        if constexpr (Q8) {
          gt *= p.sg[m0 + col];
          u *= p.su[m0 + col];
        }
        const float a = gt / (1.f + expf(-gt)) * u;
        const bf16 hi = __float2bfloat16(a);
        act[row * LDA + col] = hi;
        if constexpr (Q8) act_lo[row * LDA + col] = __float2bfloat16(a - __bfloat162float(hi));
      }
  __syncthreads();

  // act @ this block's BN rows of w_down, one BN-column output tile at a
  // time (kWBK rows a slab, BN / kWBK slabs a tile), tiles in a staggered
  // order; each tile's sums go to this block's workspace slot.
  const int tiles = p.d / BN, spt = BN / kWBK;
  float(&acc2)[MT][NT][4] = acc[0];
  zero(acc2);
  ring<kMlpStages>(tiles * spt, [&](int kt) {
    const int st = kt % kMlpStages, s = kt % spt, c = (blk + kt / spt) % tiles;
    load_weight_slab<W, kMkThreads>(
        w_slab(st, 0), p.wd + static_cast<long long>(m0 + s * kWBK) * p.d + c * BN, p.d, kWBK,
        BN, tid);
  }, [&](int kt) {
    const int st = kt % kMlpStages, s = kt % spt;
    mma_slab<W, MT, Q8>(acc2, act + s * kWBK, act_lo + s * kWBK, LDA, w_slab(st, 0), wn, lane);
    if (s != spt - 1) return;
    const int c = (blk + kt / spt) % tiles;
    float* slot = p.ws + static_cast<long long>(blk) * p.rows * p.d + c * BN;
    each_sum<W, MT>(acc2, wn, lane, [&](int row, int col, float v) {
      if (row < p.rows) slot[static_cast<long long>(row) * p.d + col] = Q8 ? v * p.sd[c * BN + col] : v;
    });
    zero(acc2);
  });

  // Every block's slot is full once all have met; then block j sums the
  // slots of its share of the (rows, d) output, 4 columns (a float4) a
  // unit, up to 128 units a round: `ways` threads a unit each add a
  // contiguous run of slots in block order, and one adds their sums in
  // order (a fixed order: the bits do not depend on timing). Then the
  // residual, and one rounding.
  grid_barrier(p.sync);
  const int units = p.rows * p.d / 4, per = (units + nblk - 1) / nblk;
  const long long stride = static_cast<long long>(p.rows) * p.d / 4;
  const float4* ws4 = reinterpret_cast<const float4*>(p.ws);
  for (int u0 = blk * per; u0 < min(units, (blk + 1) * per); u0 += kMkThreads) {
    const int nu = min(kMkThreads, min(units, (blk + 1) * per) - u0);  // units this round
    int ways = 1;
    while (ways * 2 * nu <= kMkThreads && ways * 2 <= nblk) ways *= 2;
    const int run = (nblk + ways - 1) / ways;
    if (tid < nu * ways) {
      const int u = u0 + tid / ways, b0 = (tid % ways) * run, b1 = min(nblk, b0 + run);
      float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
      int b = b0;
      for (; b + 8 <= b1; b += 8) {  // eight loads in flight, added in order
        float4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __ldcg(ws4 + (b + k) * stride + u);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc4.x += v[k].x, acc4.y += v[k].y, acc4.z += v[k].z, acc4.w += v[k].w;
      }
      for (; b < b1; ++b) {
        const float4 v = __ldcg(ws4 + b * stride + u);
        acc4.x += v.x, acc4.y += v.y, acc4.z += v.z, acc4.w += v.w;
      }
      sums[tid] = acc4;
    }
    __syncthreads();
    if (tid < nu) {
      float4 total = sums[tid * ways];
      for (int k = 1; k < ways; ++k) {
        const float4 v = sums[tid * ways + k];
        total.x += v.x, total.y += v.y, total.z += v.z, total.w += v.w;
      }
      const long long at = static_cast<long long>(u0 + tid) * 4;
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + at));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + at + 2));
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p.out + at);
      o[0] = __floats2bfloat162_rn(x01.x + total.x, x01.y + total.y);
      o[1] = __floats2bfloat162_rn(x23.x + total.z, x23.y + total.w);
    }
    __syncthreads();  // `sums` is free for the next round
  }
}

template <typename W, int MT>
int launch_mlp_mt(const MlpParams<W>& p, cudaStream_t stream) {
  using Sh = MlpShape<W, MT>;
  auto kernel = mlp_residual_kernel<W, MT>;
  static bool done = false;
  if (const int err = opt_in(kernel, Sh::SMEM, false, done)) return err;
  return launch_ex(kernel, dim3(p.m / WTile<W>::BN, 1, 1), kMkThreads, Sh::SMEM, 0, stream, p);
}

template <typename W>
int mlp_residual(const void* x, const void* norm_all, const void* const* w,
                 const void* const* s, void* out, void* ws, void* sync, int layer, int rows,
                 int d, int m, float eps, void* stream) {
  if (rows < 1 || rows > kMkMaxRows || d <= 0 || m <= 0 || d % 128 || m % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpParams<W> p{};
  const long long lw = static_cast<long long>(layer) * d * m;
  p.x = static_cast<const bf16*>(x);
  p.norm = static_cast<const bf16*>(norm_all) + static_cast<long long>(layer) * d;
  p.wg = static_cast<const W*>(w[0]) + lw;
  p.wu = static_cast<const W*>(w[1]) + lw;
  p.wd = static_cast<const W*>(w[2]) + lw;
  if (s) {
    p.sg = static_cast<const float*>(s[0]) + static_cast<long long>(layer) * m;
    p.su = static_cast<const float*>(s[1]) + static_cast<long long>(layer) * m;
    p.sd = static_cast<const float*>(s[2]) + static_cast<long long>(layer) * d;
  }
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.sync = static_cast<unsigned*>(sync);
  p.rows = rows;
  p.d = d;
  p.m = m;
  p.eps = eps;
  auto st = static_cast<cudaStream_t>(stream);
  return rows <= 16 ? launch_mlp_mt<W, 1>(p, st) : launch_mlp_mt<W, 2>(p, st);
}

// ---------------------------------------------------------------- 22

struct AttnWoArgs {
  const bf16* q;  // (B, H, 64)
  bf16* k_all;    // (L, B, K, S, 64), written at write_pos
  bf16* v_all;
  const bf16* k_new;  // (B, K, 64)
  const bf16* v_new;
  const void* wo;         // (L, H * 64, dm) bf16 or int8
  const float* wo_scale;  // int8: (L, 1, dm)
  const bf16* x;          // (B, dm)
  bf16* out;
  const int* prompt_lens;
  const int* write_pos;
  int layer, batch, heads, kv_heads, seq, dm, prompt_pad;
  float scale;
};

// Grid (K, B), cluster (K, 1, 1): the K kv-head blocks of one batch row.
template <typename W, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32) attention_wo_kernel(const AttnWoArgs a) {
  constexpr int D = 64, NT = kDecodeWarps * 32, CH = 16 / sizeof(W);
  __shared__ DecodeShared<G, D> sh;
  __shared__ float sa[G * D];  // a, rounded to bf16
  extern __shared__ __align__(16) float part[];  // [rg][dm] sums; row 0 then the block's partial
  cg::cluster_group cluster = cg::this_cluster();
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // this kv head's G * D rows of wo[layer], on their way to the L2 while
  // the attention streams the cache
  const W* w = static_cast<const W*>(a.wo) +
               (static_cast<size_t>(a.layer) * a.heads * D + static_cast<size_t>(kh) * G * D) * a.dm;
  prefetch_l2(w, static_cast<size_t>(G) * D * a.dm * sizeof(W));
  const size_t slab = ((static_cast<size_t>(a.layer) * a.batch + b) * a.kv_heads + kh) *
                      static_cast<size_t>(a.seq) * D;
  const size_t head0 = static_cast<size_t>(b) * a.heads + static_cast<size_t>(kh) * G;
  const size_t row = static_cast<size_t>(b) * a.kv_heads + kh;
  decode_attend<bf16, D, G>(sh, a.q + head0 * D, a.k_all + slab, a.v_all + slab,
                            a.k_new + row * D, a.v_new + row * D, a.prompt_lens[b],
                            a.write_pos[0], a.seq, a.prompt_pad, 1.f, 1.f, a.scale,
                            [&](int gg, int d, float v) {
                              sa[gg * D + d] = __bfloat162float(__float2bfloat16(v));
                            });
  __syncthreads();

  // a @ this kv head's G * D rows of wo[layer]: thread (c, r0) takes the CH
  // columns of chunk c and the rows r0, r0 + rg, ...
  const int chunks = a.dm / CH, rg = NT / chunks;
  if (tid < chunks * rg) {
    const int c = tid % chunks, r0 = tid / chunks;
    float acc[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int r = r0; r < G * D; r += rg) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(r) * a.dm + c * CH));
      const float ar = sa[r];
      if constexpr (sizeof(W) == 1) {
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[e] += ar * static_cast<float>(v[e]);
      } else {
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < CH / 2; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          acc[2 * e] += ar * f.x;
          acc[2 * e + 1] += ar * f.y;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) part[r0 * a.dm + c * CH + e] = acc[e];
  }
  __syncthreads();
  for (int col = tid; col < a.dm; col += NT) {  // the row groups in order, then the int8 scale
    float s = part[col];
    for (int r = 1; r < rg; ++r) s += part[r * a.dm + col];
    if (a.wo_scale) s *= a.wo_scale[static_cast<size_t>(a.layer) * a.dm + col];
    part[col] = s;
  }
  cluster.sync();  // every kv head's partial is in its shared memory

  // rank kh finishes its slice of columns: x + the K partials in head order
  const int per = (a.dm + a.kv_heads - 1) / a.kv_heads;
  const int end = min(a.dm, (kh + 1) * per);
  for (int col = kh * per + tid; col < end; col += NT) {
    float s = 0.f;
    for (int r = 0; r < a.kv_heads; ++r) s += cluster.map_shared_rank(part, r)[col];
    const size_t at = static_cast<size_t>(b) * a.dm + col;
    a.out[at] = __float2bfloat16(__bfloat162float(a.x[at]) + s);
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

template <typename W, int G>
int launch_attention_wo(const AttnWoArgs& a, cudaStream_t stream) {
  constexpr int NT = kDecodeWarps * 32, CH = 16 / sizeof(W);
  const int chunks = a.dm / CH;
  if (a.dm % CH || chunks > NT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_wo_kernel<W, G>;
  static bool done = false;
  if (const int err = opt_in(kernel, NT * CH * 4, false, done)) return err;
  return launch_ex(kernel, dim3(a.kv_heads, a.batch, 1), NT, NT / chunks * a.dm * 4,
                   a.kv_heads, stream, a);
}

template <typename W>
int attention_wo(const AttnWoArgs& a, int head_dim, cudaStream_t stream) {
  if (head_dim != 64 || a.kv_heads <= 0 || a.kv_heads > 8 || a.heads % a.kv_heads ||
      a.batch < 1 || a.batch > kMkMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.heads / a.kv_heads) {
    case 1: return launch_attention_wo<W, 1>(a, stream);
    case 2: return launch_attention_wo<W, 2>(a, stream);
    case 4: return launch_attention_wo<W, 4>(a, stream);
    case 8: return launch_attention_wo<W, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gar

using gar::bf16;

extern "C" int gar_qkv_norm_rope(const void* x, const void* norm_all, const void* wq,
                                 const void* wk, const void* wv, const void* cos_q,
                                 const void* sin_q, const void* cos_k, const void* sin_k, void* q,
                                 void* k, void* v, int layer, int rows, int d, int hq, int hk,
                                 int cw_q, int cw_k, float eps, void* stream) {
  const void* w[3] = {wq, wk, wv};
  const void* tables[4] = {cos_q, sin_q, cos_k, sin_k};
  void* out[3] = {q, k, v};
  return gar::qkv_norm_rope<bf16>(x, norm_all, w, nullptr, tables, out, layer, rows, d, hq, hk,
                                  cw_q, cw_k, eps, stream);
}

extern "C" int gar_qkv_norm_rope_q8(const void* x, const void* norm_all, const void* wq,
                                    const void* sq, const void* wk, const void* sk,
                                    const void* wv, const void* sv, const void* cos_q,
                                    const void* sin_q, const void* cos_k, const void* sin_k,
                                    void* q, void* k, void* v, int layer, int rows, int d, int hq,
                                    int hk, int cw_q, int cw_k, float eps, void* stream) {
  const void* w[3] = {wq, wk, wv};
  const void* s[3] = {sq, sk, sv};
  const void* tables[4] = {cos_q, sin_q, cos_k, sin_k};
  void* out[3] = {q, k, v};
  return gar::qkv_norm_rope<int8_t>(x, norm_all, w, s, tables, out, layer, rows, d, hq, hk, cw_q,
                                    cw_k, eps, stream);
}

extern "C" int gar_mlp_residual(const void* x, const void* norm_all, const void* wg,
                                const void* wu, const void* wd, void* out, void* ws,
                                void* sync, int layer, int rows, int d, int m, float eps,
                                void* stream) {
  const void* w[3] = {wg, wu, wd};
  return gar::mlp_residual<bf16>(x, norm_all, w, nullptr, out, ws, sync, layer, rows, d, m, eps,
                                 stream);
}

extern "C" int gar_mlp_residual_q8(const void* x, const void* norm_all, const void* wg,
                                   const void* sg, const void* wu, const void* su,
                                   const void* wd, const void* sd, void* out, void* ws,
                                   void* sync, int layer, int rows, int d, int m, float eps,
                                   void* stream) {
  const void* w[3] = {wg, wu, wd};
  const void* s[3] = {sg, su, sd};
  return gar::mlp_residual<int8_t>(x, norm_all, w, s, out, ws, sync, layer, rows, d, m, eps,
                                   stream);
}

extern "C" int gar_decode_attention_wo(const void* q, void* k_all, void* v_all, const void* k_new,
                                       const void* v_new, const void* wo, const void* wo_scale,
                                       const void* x, void* out, const void* prompt_lens,
                                       const void* write_pos, int layer, int batch, int heads,
                                       int kv_heads, int seq, int head_dim, int dm,
                                       int prompt_pad, int wo_int8, float scale, void* stream) {
  const gar::AttnWoArgs a{static_cast<const bf16*>(q), static_cast<bf16*>(k_all),
                          static_cast<bf16*>(v_all), static_cast<const bf16*>(k_new),
                          static_cast<const bf16*>(v_new), wo,
                          static_cast<const float*>(wo_scale), static_cast<const bf16*>(x),
                          static_cast<bf16*>(out), static_cast<const int*>(prompt_lens),
                          static_cast<const int*>(write_pos), layer, batch, heads, kv_heads, seq,
                          dm, prompt_pad, scale};
  auto st = static_cast<cudaStream_t>(stream);
  return wo_int8 ? gar::attention_wo<int8_t>(a, head_dim, st)
                 : gar::attention_wo<bf16>(a, head_dim, st);
}
