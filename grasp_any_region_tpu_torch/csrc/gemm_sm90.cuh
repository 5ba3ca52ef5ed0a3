// A Hopper GEMM main loop, C (rows x N, fp32 in registers) = A B, for
// bf16 A (rows, K) row-major and B (K, N) row-major (a weight as the JAX
// package stores it), on the helpers of sm90.cuh. Kernel F
// (gemm_sm90.cu) runs on it; the other GEMMs of the ViT block can take it
// up with their own prologue and epilogue.
//
// A persistent CTA (one an SM) walks output tiles of 128 x 128, tile =
// blockIdx.x + i * gridDim.x with N fastest, so the CTAs in flight share
// A's rows and each reads them from the L2 after the first. (128 x 256
// tiles, with three stages beside the epilogue tile, ran kernel F slower:
// 8.3 waves of 128 x 128 tiles on 132 SMs quantise better than 4.15 of
// 128 x 256.) Three warpgroups:
// - the producer (one thread working) keeps a ring of kStages (A, B)
//   K-slabs in flight by TMA with 128-byte swizzle: A as a (128 rows, 64)
//   box, B as a (64 rows, 64 columns, 2 atoms) box, one 64-column
//   swizzle atom after the other. It runs ahead across tile boundaries, so
//   the next tile's first slabs load while the consumers run an epilogue;
//   a kernel may give another thread of the producer warpgroup its
//   epilogue's copies;
// - consumer warpgroup w owns rows 64 w .. 64 w + 63 of the tile: per
//   slab, four k-steps of wgmma m64n128k16 (A K-major, B MN-major; the
//   descriptor's LBO steps from one 64-column atom of B to the next), then
//   it waits for the previous slab's products and hands that stage back.
//   The accumulator is the m64n128 layout: thread (warp wi, lane g * 4 + t)
//   holds acc[4 j + 2 r + c] = C[16 wi + g + 8 r][8 j + 2 t + c].
// Rows past `rows` are zero-filled by TMA; the epilogue must not store
// them.
#pragma once

#include "sm90.cuh"

namespace gar {
namespace gemm90 {

constexpr int kBM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int kBN = 128;       // columns a tile
constexpr int kBK = 64;        // K a slab: one 128-byte row of bf16
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kASlab = kBM * kBK * 2;  // bytes of an A slab (16 KB)
constexpr int kBSlab = kBK * kBN * 2;  // bytes of a B slab (16 KB)
constexpr int kAtom = kBK * 128;       // bytes of one 64-column atom of a B slab
// Stages of the ring (32 KB each), leaving room for a 128 x 128 bf16
// epilogue tile beside them.
constexpr int kStages = 5;
constexpr int kRingBytes =  // the ring and its barriers, a multiple of 1024 bytes
    (kStages * (kASlab + kBSlab) + 2 * kStages * 8 + 1023) / 1024 * 1024;

struct Maps {
  CUtensorMap a;    // (64, rows, K / 64, 1), box (64, 128, 1, 1)
  CUtensorMap b;    // (64, K, N / 64, 1), box (64, 64, 2, 1)
  CUtensorMap c;    // an epilogue's (rows, N) input: (64, rows, N / 64, 1),
                    // box (64, 128, 2, 1)
  CUtensorMap out;  // the (rows, N) output, as c
};

// The persistent walk over output tiles.
struct Walk {
  int m_tiles, n_tiles, k_slabs;
  __device__ int tiles() const { return m_tiles * n_tiles; }
};

// The ring in shared memory (from a 1024-byte-aligned base): the A slabs,
// the B slabs, then the full and empty barriers of each stage.
struct Ring {
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
__device__ inline void produce(const Maps& maps, const Ring& ring, const Walk& walk) {
  using namespace sm90;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < walk.tiles(); tile += gridDim.x) {
    const int m0 = tile / walk.n_tiles * kBM, atom0 = tile % walk.n_tiles * (kBN / 64);
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
// carry over from tile to tile. On return acc holds the tile's rows
// 64 w .. 64 w + 63 and every stage it read is handed back.
__device__ __forceinline__ void consume(float (&acc)[kBN / 2], const Ring& ring, int k_slabs,
                                        int w, int& stage, uint32_t& phase) {
  using namespace sm90;
  const uint64_t da = desc_sw128(ring.a + w * (kASlab / 2), 16, 1024);
  const uint64_t db = desc_sw128(ring.b, kAtom, 1024);
  int prev = 0;
  for (int kb = 0; kb < k_slabs; ++kb) {
    mbar_wait(&ring.full[stage], phase);
    const uint64_t a = da + stage * (kASlab >> 4), b = db + stage * (kBSlab >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes along the row; B: 16 rows down
      wgmma_m64n128k16_ss<0, 1>(acc, a + 2 * kk, b + 128 * kk, kb > 0 || kk > 0);
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
  fence_regs(acc);
  mbar_arrive(&ring.empty[prev]);
}

}  // namespace gemm90
}  // namespace gar
