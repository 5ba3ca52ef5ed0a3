// Kernels H, I and J: the layer-indexed decode matmuls, (B, Din) @ w_all[l]
// for a batch of B <= 32 rows, the weight read in place from the stacked
// (L, Din, Dout) array at layer l.
//
// H  replaces grasp_any_region_tpu/ops/layer_matmul.py:layer_matmul
//    (_mm_kernel): x @ w_all[l], fp32 sums, rounded to bf16.
// I  replaces layer_matmul.py:layer_swiglu (_swiglu_kernel):
//    silu(x @ wg[l]) * (x @ wu[l]), both sums fp32, SiLU and the product in
//    fp32, one rounding to bf16.
// J  replaces layer_matmul.py:layer_qkv (_qkv_kernel): the q, k and v
//    products of one x, each column tile writing to the output it belongs
//    to. The TPU kernel's single whole-weight block (grid (1,)) is a VMEM
//    artefact; here the three weights are column tiles of one grid.
//
// What bounds them: at B = 1 each weight byte feeds 1 FLOP (24 at B = 24),
// so the time is the time to stream the weights from HBM (GAR-1B: 8.4 MB
// for wo, 33.6 MB for w_down, 67.1 MB for gate + up, 12.6 MB for qkv).
// The design is about bytes in flight and enough blocks:
//
//  * A block owns 64 output columns (128-byte weight rows, coalesced) and a
//    slice of K. The column tiles alone would give 16-48 blocks on 132 SMs,
//    so K is split over a thread-block cluster of S = 1, 2, 4 or 8 blocks,
//    picked at launch so that the grid has at least two blocks per SM.
//  * Each block streams its (K/S, 64) weight slice through a ring of four
//    64-row slabs with cp.async (three in flight while one is consumed),
//    beside the matching (rows, 64) slab of x, so no block holds all of x
//    (B = 24, Din = 8192 would be 384 KB).
//  * The products run on the tensor cores, mma.sync m16n8k16 with the x
//    rows as the A operand (zero-filled to 16 or 32 rows) and the weight
//    slab as B through ldmatrix.trans: at B = 24 the CUDA cores' fp32 FMAs
//    could not keep up with HBM, and at B = 1 the padding costs nothing
//    that shows (the tensor cores idle either way).
//  * The split-K partial sums meet in the same launch: each block leaves
//    its (rows, 64) fp32 partial in shared memory, the cluster syncs, and
//    block r sums columns [r * 64/S, (r + 1) * 64/S) over the S blocks'
//    shared memory (distributed shared memory), in rank order, so the
//    result does not depend on timing; then it runs the epilogue (SiLU *
//    up for I) and stores bf16. No workspace, no atomics, no second launch
//    (decode is host-bound, and every launch costs host time).
//  * Ragged edges are bounded and masked: Din and Dout need only be
//    multiples of 8 (16-byte rows), not of the tile; rows, columns and K
//    past the edge are zero-filled by cp.async's src-size operand.
//
// The int8 slice (W8A16, one fp32 scale per output column: layer_matmul_q8
// and friends) reuses this body: the slab loader takes int8 rows and the B
// fragments widen them to bf16, and the column scale applies in the
// epilogue, since it commutes with the sum over K.
#include <cooperative_groups.h>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace gar {

constexpr int kLmBN = 64;        // output columns per block: 128-byte weight rows
constexpr int kLmBK = 64;        // weight rows per slab
constexpr int kLmStages = 4;     // slabs in the ring: three loads in flight
constexpr int kLmThreads = 128;  // 4 warps, 16 columns each
constexpr int kLmMaxSplits = 8;  // the portable cluster size
constexpr int kLmMaxRows = 32;

struct LmSegment {
  const bf16* w;   // (Din, n) at layer l
  const bf16* w2;  // I only: the up weight, (Din, n)
  bf16* out;       // (rows, n)
  int n;
  int tiles;       // column tiles of kLmBN
};

struct LmParams {
  const bf16* x;  // (rows, Din)
  LmSegment seg[3];  // H and I use seg[0]; J q, k, v. Unused segments have 0 tiles.
  int rows, din;
  int k_split;    // rows of K per block of a cluster, a multiple of 16
};

// The segment that column tile `tile` (the grid's y index) falls in; `tile`
// becomes the index within that segment.
__device__ __forceinline__ LmSegment pick_segment(const LmParams& p, int& tile) {
  if (tile < p.seg[0].tiles) return p.seg[0];
  tile -= p.seg[0].tiles;
  if (tile < p.seg[1].tiles) return p.seg[1];
  tile -= p.seg[1].tiles;
  return p.seg[2];
}

template <bool SWIGLU, int MT>
struct LmShape {
  static constexpr int NW = SWIGLU ? 2 : 1;      // weights per tile
  static constexpr int ROWS = 16 * MT;           // x rows, zero-filled past B
  static constexpr int LDB = kLmBN + kGemmPad;   // weight slab pitch
  static constexpr int LDX = kLmBK + kGemmPad;   // x slab pitch
  static constexpr int W_ELEMS = kLmBK * LDB;
  static constexpr int STAGE = NW * W_ELEMS + ROWS * LDX;
  static constexpr int SMEM_BYTES = kLmStages * STAGE * 2;
  static_assert(NW * ROWS * kLmBN * 4 <= SMEM_BYTES, "the partials reuse the ring");
  static_assert((STAGE * 2) % 16 == 0 && (W_ELEMS * 2) % 16 == 0, "16-byte aligned slabs");
};

// Grid (S, tiles), cluster (S, 1, 1): the S blocks of a cluster share one
// column tile and split its K.
template <bool SWIGLU, int MT>
__global__ void __launch_bounds__(kLmThreads) layer_mm_kernel(const LmParams p) {
  using Sh = LmShape<SWIGLU, MT>;
  constexpr int NW = Sh::NW, ROWS = Sh::ROWS, LDB = Sh::LDB, LDX = Sh::LDX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;  // the cluster spans the grid's x
  int tile = blockIdx.y;
  const LmSegment seg = pick_segment(p, tile);
  const int n0 = tile * kLmBN;
  const int k_begin = split * p.k_split;
  const int k_end = min(p.din, k_begin + p.k_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + kLmBK - 1) / kLmBK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Slab kt: kLmBK weight rows x kLmBN columns of each weight, and the
  // matching ROWS x kLmBK block of x. Chunks past an edge read nothing and
  // land as zeros (n and Din are multiples of 8, so a chunk is in or out).
  auto load_slab = [&](int kt) {
    bf16* st = ring + (kt % kLmStages) * Sh::STAGE;
    const int kb = k_begin + kt * kLmBK;
    for (int c = tid; c < kLmBK * (kLmBN / 8); c += kLmThreads) {
      const int r = c / (kLmBN / 8), cc = (c % (kLmBN / 8)) * 8;
      const bool ok = kb + r < k_end && n0 + cc < seg.n;
      const long long off = ok ? static_cast<long long>(kb + r) * seg.n + n0 + cc : 0;
      cp_async16(st + r * LDB + cc, seg.w + off, ok ? 16 : 0);
      if (SWIGLU) cp_async16(st + Sh::W_ELEMS + r * LDB + cc, seg.w2 + off, ok ? 16 : 0);
    }
    bf16* sx = st + NW * Sh::W_ELEMS;
    for (int c = tid; c < ROWS * (kLmBK / 8); c += kLmThreads) {
      const int r = c / (kLmBK / 8), cc = (c % (kLmBK / 8)) * 8;
      const bool ok = r < p.rows && kb + cc < k_end;
      const long long off = ok ? static_cast<long long>(r) * p.din + kb + cc : 0;
      cp_async16(sx + r * LDX + cc, p.x + off, ok ? 16 : 0);
    }
  };

  float acc[NW][MT][2][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[w][i][j][0] = acc[w][i][j][1] = acc[w][i][j][2] = acc[w][i][j][3] = 0.f;

  const int wn = warp * 16;  // this warp's 16 columns of the tile
#pragma unroll
  for (int s = 0; s < kLmStages - 1; ++s) {
    if (s < nk) load_slab(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kLmStages - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();                 // ... every thread's part; slab kt-1 is free
    if (kt + kLmStages - 1 < nk) load_slab(kt + kLmStages - 1);
    cp_async_commit();

    const bf16* st = ring + (kt % kLmStages) * Sh::STAGE;
    const bf16* sx = st + NW * Sh::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kLmBK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sx + (i * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t bfr[4];  // b0, b1 of columns wn..wn+7, then of wn+8..wn+15
        ldmatrix_x4_trans(bfr, st + w * Sh::W_ELEMS + (kk + (lane & 15)) * LDB + wn +
                                   (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(acc[w][i][0], af[i], bfr[0], bfr[1]);
          mma_bf16_16816(acc[w][i][1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds this block's partials

  float* part = reinterpret_cast<float*>(smem_raw);  // [NW][ROWS][kLmBN] fp32
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = i * 16 + g + hf * 8, col = wn + j * 8 + 2 * t;
          *reinterpret_cast<float2*>(part + (w * ROWS + row) * kLmBN + col) =
              make_float2(acc[w][i][j][2 * hf], acc[w][i][j][2 * hf + 1]);
        }
  cluster.sync();  // every block's partials are in its shared memory

  // Block `split` finishes columns [c0, c0 + cols) of the tile: the sum of
  // the S partials in rank order, then the epilogue.
  const int cols = kLmBN / splits, c0 = split * cols;
  for (int e = tid; e < p.rows * cols; e += kLmThreads) {
    const int row = e / cols, col = c0 + e % cols;
    if (n0 + col >= seg.n) continue;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int w = 0; w < NW; ++w) v[w] += peer[(w * ROWS + row) * kLmBN + col];
    }
    // I: silu(gate) * up in fp32 (silu(g) = g * sigmoid(g)), one rounding
    const float o = SWIGLU ? v[0] / (1.f + expf(-v[0])) * v[NW - 1] : v[0];
    seg.out[static_cast<long long>(row) * seg.n + n0 + col] = __float2bfloat16(o);
  }
  cluster.sync();  // no block leaves while a peer may still read its partials
}

int lm_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// Split K in two until the grid has two blocks per SM, S reaches the
// cluster limit, or a block would get less than one 64-row slab.
int lm_splits(int tiles, int din) {
  const int target = 2 * lm_sm_count();
  int s = 1;
  while (s < kLmMaxSplits && tiles * s < target && din >= 2 * s * kLmBK) s *= 2;
  return s;
}

template <bool SWIGLU, int MT>
int launch_lm_mt(LmParams p, int tiles, cudaStream_t stream) {
  constexpr int smem = LmShape<SWIGLU, MT>::SMEM_BYTES;
  auto kernel = layer_mm_kernel<SWIGLU, MT>;
  static bool opted_in = false;  // the attribute is per kernel: set it once
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int splits = lm_splits(tiles, p.din);
  p.k_split = ((p.din + splits - 1) / splits + 15) / 16 * 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kLmThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Fill in the tiles, check the shapes, pick the row tile (16 or 32 rows).
template <bool SWIGLU>
int launch_lm(LmParams p, cudaStream_t stream) {
  if (p.rows < 1 || p.rows > kLmMaxRows || p.din <= 0 || p.din % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0;
  for (LmSegment& s : p.seg) {
    if (s.n < 0 || s.n % 8) return static_cast<int>(cudaErrorInvalidValue);
    s.tiles = (s.n + kLmBN - 1) / kLmBN;
    tiles += s.tiles;
  }
  if (tiles == 0 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows <= 16) return launch_lm_mt<SWIGLU, 1>(p, tiles, stream);
  return launch_lm_mt<SWIGLU, 2>(p, tiles, stream);
}

const bf16* at_layer(const void* w_all, int layer, int din, int n) {
  return static_cast<const bf16*>(w_all) + static_cast<long long>(layer) * din * n;
}

}  // namespace gar

using gar::bf16;

extern "C" int gar_layer_matmul(const void* x, const void* w_all, void* out, int layer,
                                int rows, int din, int dout, void* stream) {
  gar::LmParams p{};
  p.x = static_cast<const bf16*>(x);
  p.seg[0] = {gar::at_layer(w_all, layer, din, dout), nullptr, static_cast<bf16*>(out), dout, 0};
  p.rows = rows;
  p.din = din;
  return gar::launch_lm<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int gar_layer_swiglu(const void* x, const void* wg_all, const void* wu_all, void* out,
                                int layer, int rows, int din, int m, void* stream) {
  gar::LmParams p{};
  p.x = static_cast<const bf16*>(x);
  p.seg[0] = {gar::at_layer(wg_all, layer, din, m), gar::at_layer(wu_all, layer, din, m),
              static_cast<bf16*>(out), m, 0};
  p.rows = rows;
  p.din = din;
  return gar::launch_lm<true>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int gar_layer_qkv(const void* x, const void* wq_all, const void* wk_all,
                             const void* wv_all, void* q, void* k, void* v, int layer, int rows,
                             int d, int hq, int hk, void* stream) {
  gar::LmParams p{};
  p.x = static_cast<const bf16*>(x);
  p.seg[0] = {gar::at_layer(wq_all, layer, d, hq), nullptr, static_cast<bf16*>(q), hq, 0};
  p.seg[1] = {gar::at_layer(wk_all, layer, d, hk), nullptr, static_cast<bf16*>(k), hk, 0};
  p.seg[2] = {gar::at_layer(wv_all, layer, d, hk), nullptr, static_cast<bf16*>(v), hk, 0};
  p.rows = rows;
  p.din = d;
  return gar::launch_lm<false>(p, static_cast<cudaStream_t>(stream));
}
