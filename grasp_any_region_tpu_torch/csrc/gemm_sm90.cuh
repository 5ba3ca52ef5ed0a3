// A Hopper GEMM main loop, C (rows x N, fp32 in registers) = A B, for
// bf16 A (rows, K) row-major and B (K, N) row-major (a weight as the JAX
// package stores it), on the helpers of sm90.cuh. The GEMMs of the fused
// ViT block run on it (gemm_sm90.cu): kernel F, D's qkv, and G's fc1 and
// fc2, each with its own epilogue (`Epilogue`).
//
// A persistent CTA (one an SM) walks output tiles of 128 x BN, tile =
// blockIdx.x + i * gridDim.x with N fastest, so the CTAs in flight share
// A's rows and each reads them from the L2 after the first. BN is 128, or
// 256 for the wide products that read no residual (D's qkv, G's fc1),
// where each A slab then serves twice the columns, with three stages
// instead of five beside the wider epilogue tile. (128 x 256 tiles ran
// kernel F slower: 8.3 waves of 128 x 128 tiles on 132 SMs quantise better
// than 4.15 of 128 x 256.) Three warpgroups:
// - the producer (one thread working) keeps a ring of (A, B) K-slabs in
//   flight by TMA with 128-byte swizzle: A as a (128 rows, 64) box, B as
//   a (64 rows, 64 columns, BN / 64 atoms) box, one 64-column swizzle
//   atom after the other. It runs ahead across tile boundaries, so the
//   next tile's first slabs load while the consumers run an epilogue; a
//   kernel may give another thread of the producer warpgroup its
//   epilogue's copies;
// - consumer warpgroup w owns rows 64 w .. 64 w + 63 of the tile: per
//   slab, four k-steps of BN / 128 wgmma m64n128k16 (A K-major, B
//   MN-major; the descriptor's LBO steps from one 64-column atom of B to
//   the next), then it waits for the previous slab's products and hands
//   that stage back. The accumulator is BN / 128 m64n128 layouts: thread
//   (warp wi, lane g * 4 + t) holds acc[h][4 j + 2 r + c] =
//   C[16 wi + g + 8 r][128 h + 8 j + 2 t + c].
// Rows past `rows` are zero-filled by TMA; the epilogue must not store
// them. K is any multiple of 64 and N of 128: A, B and the (rows, N)
// matrices each have their own tensor map (`encode_matrix`).
#pragma once

#include "sm90.cuh"

namespace gar {
namespace gemm90 {

constexpr int kBM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int kBK = 64;        // K a slab: one 128-byte row of bf16
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kASlab = kBM * kBK * 2;  // bytes of an A slab (16 KB)
constexpr int kAtom = kBK * 128;       // bytes of one 64-column atom of a B slab

// A tile BN columns wide (128, or 256 for the wide products that read no
// residual): the ring's stages of (A, B) slabs, as many as fit beside a
// 128 x BN bf16 epilogue tile, and that tile.
template <int BN>
struct Tile {
  static constexpr int kBSlab = kBK * BN * 2;        // bytes of a B slab (16 or 32 KB)
  static constexpr int kStages = BN == 128 ? 5 : 3;  // 32 or 48 KB each
  static constexpr int kRingBytes =  // the ring and its barriers, a multiple of 1024 bytes
      (kStages * (kASlab + kBSlab) + 2 * kStages * 8 + 1023) / 1024 * 1024;
  static constexpr int kOut = kBM * BN * 2;  // bytes of the epilogue tile
};

// What the epilogue makes of C + bias (fp32), rounded once to bf16.
enum Epilogue : int {
  kResidual = 0,     // x + ls * (C + bias): kernel F, and G's fc2
  kBias = 1,         // C + bias: D's qkv
  kBiasGelu = 2,     // gelu(C + bias), the tanh form: G's fc1 at fast_gelu
  kBiasGeluErf = 3,  // gelu(C + bias), the exact erf form
};

struct Maps {
  CUtensorMap a;    // (64, rows, K / 64, 1), box (64, 128, 1, 1)
  CUtensorMap b;    // (64, K, N / 64, 1), box (64, 64, BN / 64, 1)
  CUtensorMap c;    // an epilogue's (rows, N) input: (64, rows, N / 64, 1),
                    // box (64, 128, BN / 64, 1)
  CUtensorMap out;  // the (rows, N) output, as c
};

// The persistent walk over output tiles.
struct Walk {
  int m_tiles, n_tiles, k_slabs;
  __device__ int tiles() const { return m_tiles * n_tiles; }
};

// The ring in shared memory (from a 1024-byte-aligned base): the A slabs,
// the B slabs, then the full and empty barriers of each stage.
template <int BN>
struct Ring {
  static constexpr int kStages = Tile<BN>::kStages, kBSlab = Tile<BN>::kBSlab;
  uint8_t* a;
  uint8_t* b;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Ring(uint8_t* sm)
      : a(sm),
        b(sm + kStages * kASlab),
        full(reinterpret_cast<uint64_t*>(sm + kStages * (kASlab + kBSlab))),
        empty(full + kStages) {}

  // Thread 0, before mbar_fence_init and the block-wide barrier: the
  // producer's one arrival (with the TMA bytes) fills a stage, every
  // consumer thread empties it.
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
  }
};

// The producer: one thread loads every slab of every tile of this CTA.
template <int BN>
__device__ inline void produce(const Maps& maps, const Ring<BN>& ring, const Walk& walk) {
  using namespace sm90;
  constexpr int kStages = Ring<BN>::kStages, kBSlab = Ring<BN>::kBSlab;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < walk.tiles(); tile += gridDim.x) {
    const int m0 = tile / walk.n_tiles * kBM, atom0 = tile % walk.n_tiles * (BN / 64);
    for (int kb = 0; kb < walk.k_slabs; ++kb) {
      mbar_wait(&ring.empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&ring.full[stage], kASlab + kBSlab);
      tma_load_4d(ring.a + stage * kASlab, &maps.a, &ring.full[stage], 0, m0, kb, 0);
      tma_load_4d(ring.b + stage * kBSlab, &maps.b, &ring.full[stage], 0, kb * kBK, atom0, 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's main loop over one tile's K slabs; (stage, phase)
// carry over from tile to tile. On return acc[h] holds columns 128 h ..
// 128 h + 127 of the tile's rows 64 w .. 64 w + 63, and every stage it
// read is handed back.
template <int BN>
__device__ __forceinline__ void consume(float (&acc)[BN / 128][64], const Ring<BN>& ring,
                                        int k_slabs, int w, int& stage, uint32_t& phase) {
  using namespace sm90;
  constexpr int kStages = Ring<BN>::kStages, kBSlab = Ring<BN>::kBSlab;
  const uint64_t da = desc_sw128(ring.a + w * (kASlab / 2), 16, 1024);
  const uint64_t db = desc_sw128(ring.b, kAtom, 1024);
  int prev = 0;
  for (int kb = 0; kb < k_slabs; ++kb) {
    mbar_wait(&ring.full[stage], phase);
    const uint64_t a = da + stage * (kASlab >> 4), b = db + stage * (kBSlab >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes along the row; B: 16 rows down
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)  // B's atoms 2 h, 2 h + 1
        wgmma_m64n128k16_ss<0, 1>(acc[h], a + 2 * kk, b + h * (2 * kAtom >> 4) + 128 * kk,
                                  kb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous slab's products are done: its stage is free
    if (kb > 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < BN / 128; ++h) fence_regs(acc[h]);
  mbar_arrive(&ring.empty[prev]);
}

// A (n_rows, cols) row-major bf16 matrix as (64 columns, n_rows, cols / 64
// column blocks 128 bytes apart, 1): boxes of box_rows rows and box_atoms
// blocks. Returns 0 or encode_4d's negative code.
inline int encode_matrix(CUtensorMap* map, const void* base, int n_rows, int cols, int box_rows,
                         int box_atoms) {
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(cols / 64), 1};
  const cuuint64_t strides[3] = {row_bytes, 128, row_bytes * n_rows};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_atoms), 1};
  return encode_4d(map, base, false, dims, strides, box);
}

// out (rows, n) = epilogue(a (rows, k) @ b (k, n)) on `stream` (gemm_sm90.cu):
// a, b, out and c (the residual's x, (rows, n), read by kResidual only)
// contiguous bf16 with 16-byte aligned bases; bias and ls (n,) fp32 (ls
// read by kResidual only). n a multiple of 128, k of 64. Tiles are 128 x
// 256 where n allows and no residual is read, else 128 x 128. Returns a
// CUDA error code, or encode_4d's negative one.
int gemm(int epi, const void* a, const void* b, const void* c, const float* bias,
         const float* ls, void* out, int rows, int n, int k, cudaStream_t stream);

}  // namespace gemm90
}  // namespace gar
