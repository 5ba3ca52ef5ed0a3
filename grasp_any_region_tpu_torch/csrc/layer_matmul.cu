// Kernel J and its int8 form J8: the layer-indexed q, k and v products of
// the decode step, (B, Din) @ w_all[l] for a batch of B <= 32 rows, the
// weight read in place from the stacked (L, Din, Dout) array at layer l.
// Kernels H (layer_matmul: x @ w_all[l]), I (layer_swiglu: silu(x @ wg[l])
// * (x @ wu[l])), their int8 forms H8 and I8, and the mega step's 19 and 20
// ran on this body until they moved to the TMA-fed weight stream of
// layer_matmul_sm90.cu.
//
// J  replaces grasp_any_region_tpu/ops/layer_matmul.py:layer_qkv
//    (_qkv_kernel): the q, k and v products of one x, each column tile
//    writing to the output it belongs to. The TPU kernel's single
//    whole-weight block (grid (1,)) is a VMEM artefact; here the three
//    weights are column tiles of one grid.
//
// What bounds them: at B = 1 each weight byte feeds 1 FLOP (24 at B = 24),
// so the time is the time to stream the weights from HBM (GAR-1B: 8.4 MB
// for qkv).
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
//    result does not depend on timing; then it stores bf16. No workspace, no atomics, no second launch
//    (decode is host-bound, and every launch costs host time).
//  * Ragged edges are bounded and masked: Din and Dout need only be
//    multiples of 8 (16-byte rows), not of the tile; rows, columns and K
//    past the edge are zero-filled by cp.async's src-size operand.
//
// J8 replaces layer_qkv_q8 (_qkv_q8_kernel) of the same file: W8A16, int8
// weights with one fp32 scale per output column. It is this body
// instantiated over the weight type W = int8_t, and it streams half the
// bytes of J, which is the whole point: GAR-1B at B = 1 bounds it at 6.3 MB
// of int8 weights. What changes with the type:
//
//  * A block owns 128 int8 columns, so weight rows stay 128 bytes and a
//    64-row slab stays 8 KB, as in bf16: the shared-memory layout, the
//    cp.async loads and the bytes in flight are the same. (64 int8
//    columns, 64-byte rows, were slower in one call on J8.) Twice-wide
//    tiles halve the column tiles, so K is split over clusters of up to 16
//    blocks (Hopper's non-portable size) to keep two blocks per SM.
//  * One ldmatrix.x4.trans over pairs of bytes gives each thread two
//    adjacent columns of two adjacent K rows; widen_i8x4 turns them into
//    bf16 B fragments in registers (exact: an int8 is its own bf16), the
//    even columns as one n-tile and the odd as another, which the epilogue
//    puts back in order.
//  * The column scale multiplies the fp32 sum in the epilogue, after the
//    split-K reduction, since it is constant along K.
//
// Their Dout must be a multiple of 16 (rows of whole 16-byte chunks).
#include <cooperative_groups.h>

#include "weight_tile.cuh"

namespace cg = cooperative_groups;

namespace gar {

constexpr int kLmBK = kWBK;      // weight rows per slab
constexpr int kLmStages = 4;     // slabs in the ring: three loads in flight
constexpr int kLmThreads = 128;  // 4 warps, a quarter of the block's columns each
constexpr int kLmMaxSplits = 8;  // the portable cluster size (bf16)
constexpr int kLmMaxSplitsQ8 = 16;  // int8 tiles are twice as wide: half as many to split
constexpr int kLmMaxRows = 32;

template <typename W>
struct LmSegment {
  const W* w;          // (Din, n) at layer l
  const float* s;      // int8 only: the column scales of w, (n,) at layer l
  bf16* out;           // (rows, n)
  int n;
  int tiles;           // column tiles of LmShape::BN
};

template <typename W>
struct LmParams {
  const bf16* x;  // (rows, Din)
  LmSegment<W> seg[3];  // q, k, v
  int rows, din;
  int k_split;    // rows of K per block of a cluster, a multiple of 16
};

// The segment that column tile `tile` (the grid's y index) falls in; `tile`
// becomes the index within that segment.
template <typename W>
__device__ __forceinline__ LmSegment<W> pick_segment(const LmParams<W>& p, int& tile) {
  if (tile < p.seg[0].tiles) return p.seg[0];
  tile -= p.seg[0].tiles;
  if (tile < p.seg[1].tiles) return p.seg[1];
  tile -= p.seg[1].tiles;
  return p.seg[2];
}

// Output columns per block: 128-byte weight rows in either type.
template <typename W>
constexpr int lm_bn() { return WTile<W>::BN; }

template <typename W, int MT>
struct LmShape {
  static constexpr bool Q8 = sizeof(W) == 1;
  static constexpr int BN = WTile<W>::BN;        // 64 bf16 or 128 int8 columns
  static constexpr int WN = WTile<W>::WN;        // columns per warp
  static constexpr int NT = WTile<W>::NT;        // mma n-tiles per warp: 2 bf16, 4 int8
  static constexpr int BK = kLmBK;
  static constexpr int ROWS = 16 * MT;           // x rows, zero-filled past B
  static constexpr int W_BYTES = WTile<W>::BYTES;
  static constexpr int STAGE = W_BYTES + ROWS * kXLd * 2;  // bytes
  static constexpr int SMEM_BYTES = kLmStages * STAGE;
  static_assert(ROWS * BN * 4 <= SMEM_BYTES, "the partials reuse the ring");
  static_assert(STAGE % 16 == 0 && W_BYTES % 16 == 0, "16-byte aligned slabs");
};

// Grid (S, tiles), cluster (S, 1, 1): the S blocks of a cluster share one
// column tile and split its K.
template <typename W, int MT>
__global__ void __launch_bounds__(kLmThreads) layer_mm_kernel(const LmParams<W> p) {
  using Sh = LmShape<W, MT>;
  constexpr int ROWS = Sh::ROWS, BK = Sh::BK;
  constexpr int BN = Sh::BN, NT = Sh::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;  // the cluster spans the grid's x
  int tile = blockIdx.y;
  const LmSegment<W> seg = pick_segment(p, tile);
  const int n0 = tile * BN;
  const int k_begin = split * p.k_split;
  const int k_end = min(p.din, k_begin + p.k_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto w_slab = [&](int stage) { return reinterpret_cast<W*>(smem_raw + stage * Sh::STAGE); };
  auto x_slab = [&](int stage) {
    return reinterpret_cast<bf16*>(smem_raw + stage * Sh::STAGE + Sh::W_BYTES);
  };

  // Slab kt: BK weight rows x BN columns of the weight, and the matching
  // ROWS x BK block of x; chunks past an edge land as zeros.
  float acc[MT][NT][4];
  zero(acc);
  const int wn = warp * Sh::WN;  // this warp's columns of the tile
  ring<kLmStages>(nk, [&](int kt) {
    const int stage = kt % kLmStages, kb = k_begin + kt * BK;
    const long long at = static_cast<long long>(kb) * seg.n + n0;
    load_weight_slab<W, kLmThreads>(w_slab(stage), seg.w + at, seg.n, k_end - kb, seg.n - n0,
                                    tid);
    load_x_slab<ROWS, kLmThreads>(x_slab(stage), p.x, p.rows, p.din, kb, k_end);
  }, [&](int kt) {
    const int stage = kt % kLmStages;
    mma_slab<W, MT>(acc, x_slab(stage), kXLd, w_slab(stage), wn, lane);
  });

  // the ring is free: it now holds this block's partials, [ROWS][BN] fp32
  float* part = reinterpret_cast<float*>(smem_raw);
  each_sum<W, MT>(acc, wn, lane, [&](int row, int col, float v) { part[row * BN + col] = v; });
  cluster.sync();  // every block's partials are in its shared memory

  // Block `split` finishes columns [c0, c0 + cols) of the tile: the sum of
  // the S partials in rank order, then the int8 column scales.
  const int cols = BN / splits, c0 = split * cols;
  for (int e = tid; e < p.rows * cols; e += kLmThreads) {
    const int row = e / cols, col = c0 + e % cols;
    if (n0 + col >= seg.n) continue;
    float v = 0.f;
    for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(part, r)[row * BN + col];
    if constexpr (Sh::Q8) v *= seg.s[n0 + col];
    seg.out[static_cast<long long>(row) * seg.n + n0 + col] = __float2bfloat16(v);
  }
  cluster.sync();  // no block leaves while a peer may still read its partials
}

// Split K in two until the grid has two blocks per SM, S reaches the
// cluster limit, or a block would get less than one 64-row slab.
int lm_splits(int tiles, int din, int max_splits) {
  const int target = 2 * card_sm_count();
  int s = 1;
  while (s < max_splits && tiles * s < target && din >= 2 * s * kLmBK) s *= 2;
  return s;
}

template <typename W, int MT>
int launch_lm_mt(LmParams<W> p, int tiles, cudaStream_t stream) {
  using Sh = LmShape<W, MT>;
  auto kernel = layer_mm_kernel<W, MT>;
  static bool done = false;  // the attribute is per kernel: set it once
  // clusters of 16 for int8: past the portable 8, Hopper has them
  if (const int err = opt_in(kernel, Sh::SMEM_BYTES, Sh::Q8, done)) return err;
  const int splits = lm_splits(tiles, p.din, Sh::Q8 ? kLmMaxSplitsQ8 : kLmMaxSplits);
  p.k_split = ((p.din + splits - 1) / splits + 15) / 16 * 16;
  return launch_ex(kernel, dim3(splits, tiles, 1), kLmThreads, Sh::SMEM_BYTES, splits, false,
                   stream, p);
}

// Fill in the tiles, check the shapes, pick the row tile (16 or 32 rows).
template <typename W>
int launch_lm(LmParams<W> p, cudaStream_t stream) {
  constexpr int chunk = 16 / sizeof(W);
  if (p.rows < 1 || p.rows > kLmMaxRows || p.din <= 0 || p.din % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0;
  for (LmSegment<W>& s : p.seg) {
    if (s.n < 0 || s.n % chunk) return static_cast<int>(cudaErrorInvalidValue);
    s.tiles = (s.n + lm_bn<W>() - 1) / lm_bn<W>();
    tiles += s.tiles;
  }
  if (tiles == 0 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows <= 16) return launch_lm_mt<W, 1>(p, tiles, stream);
  return launch_lm_mt<W, 2>(p, tiles, stream);
}

template <typename W>
const W* at_layer(const void* w_all, int layer, int din, int n) {
  return static_cast<const W*>(w_all) + static_cast<long long>(layer) * din * n;
}

// A weight's segment at `layer`: (L, din, n) values, (L, 1, n) scales.
template <typename W>
LmSegment<W> segment(const void* w_all, const void* s_all, void* out, int layer, int din,
                     int n) {
  const float* s = s_all ? static_cast<const float*>(s_all) + static_cast<long long>(layer) * n
                         : nullptr;
  return {at_layer<W>(w_all, layer, din, n), s, static_cast<bf16*>(out), n, 0};
}

template <typename W>
int qkv(const void* x, const void* wq_all, const void* sq_all, const void* wk_all,
        const void* sk_all, const void* wv_all, const void* sv_all, void* q, void* k, void* v,
        int layer, int rows, int d, int hq, int hk, void* stream) {
  LmParams<W> p{};
  p.x = static_cast<const bf16*>(x);
  p.seg[0] = segment<W>(wq_all, sq_all, q, layer, d, hq);
  p.seg[1] = segment<W>(wk_all, sk_all, k, layer, d, hk);
  p.seg[2] = segment<W>(wv_all, sv_all, v, layer, d, hk);
  p.rows = rows;
  p.din = d;
  return launch_lm<W>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace gar

using gar::bf16;

extern "C" int gar_layer_qkv(const void* x, const void* wq_all, const void* wk_all,
                             const void* wv_all, void* q, void* k, void* v, int layer, int rows,
                             int d, int hq, int hk, void* stream) {
  return gar::qkv<bf16>(x, wq_all, nullptr, wk_all, nullptr, wv_all, nullptr, q, k, v, layer,
                        rows, d, hq, hk, stream);
}

extern "C" int gar_layer_qkv_q8(const void* x, const void* wq_all, const void* sq_all,
                                const void* wk_all, const void* sk_all, const void* wv_all,
                                const void* sv_all, void* q, void* k, void* v, int layer, int rows,
                                int d, int hq, int hk, void* stream) {
  return gar::qkv<int8_t>(x, wq_all, sq_all, wk_all, sk_all, wv_all, sv_all, q, k, v, layer, rows,
                          d, hq, hk, stream);
}
