// Kernels 19 and 20: the q, k, v projections of the mega decode step, one
// token of a decoder layer (grasp_any_region_tpu/ops/decode_megakernel.py).
// The step's other two launches, 21 / 23 (the MLP and its residual) and 22
// (attention, wo and the residual), are decode_mlp_sm90.cu and
// decode_attn_wo_sm90.cu.
//
// 19 replaces layer_qkv_norm_rope (_qkv_kernel): RMSNorm(x) rounded to bf16,
//    its q, k, v products with wq/wk/wv[l] as fp32 sums, rotate-half rope on
//    the q and k sums in fp32, one rounding each.
// 20 replaces layer_qkv_norm_rope_q8 (_qkv_q8_kernel): 19 over int8 weights
//    with fp32 column scales; xn stays fp32.
//
// What bounds them: at B = 1 every weight byte feeds one multiply-add, so
// the time is the time to stream the weights (GAR-1B: 12.6 MB of q/k/v, half
// of it in int8). They are kernel J's design (layer_matmul.cu): a block owns
// 64 bf16 or 128 int8 output columns and a slice of K, K split over a
// cluster whose partials meet in distributed shared memory, weights streamed
// through a four-slab cp.async ring, mma.sync on the tensor cores. The
// RMSNorm prologue: each block takes the sum of squares of whole x rows (B x
// 2048, small) and turns each x slab into xn in shared memory as it lands.
// The rope epilogue: a 64-column head lies in one column tile, so the rank
// that finishes column c also sums its partner c +- 32 over the cluster's
// partials.
//
// 20's fp32 xn meets the tensor cores as a bf16 high half and low half (hi =
// bf16(v), lo = bf16(v - hi)), two products with each weight fragment: 16
// significant bits, where one bf16 rounding would keep 8.
//
// Limits, as H-J: B <= 32 rows, head_dim 64, column counts whole heads.
#include <cooperative_groups.h>

#include "weight_tile.cuh"

namespace cg = cooperative_groups;

namespace gar {

int lm_splits(int tiles, int din, int max_splits);  // layer_matmul.cu

constexpr int kMkThreads = 128;  // four warps, a quarter of a weight tile's columns each
constexpr int kMkStages = 4;     // slabs in 19 / 20's ring: three loads in flight
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
  return launch_ex(kernel, dim3(splits, tiles, 1), kMkThreads, Sh::SMEM, splits, false, stream,
                   p);
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
