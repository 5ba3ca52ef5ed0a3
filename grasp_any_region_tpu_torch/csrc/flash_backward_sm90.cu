// Kernels 17 and 18: the flash attention backward (FA-2 recurrences) for
// Hopper. Replaces grasp_any_region_tpu/ops/flash_backward.py:
// flash_attention_bwd, whose TPU form splits the work in two passes
// (_dq_kernel, _dkv_kernel) because a TPU core has no atomics; each pass
// recomputes S = Q K^T and dP = dO V^T, seven products a tile pair.
//
// 18 (flash_bwd_sm90_kernel): one pass, five wgmma products a pair. One CTA
//   per (128-key tile, kv head, batch), launched heaviest first (the causal
//   band's longest key tiles get the lowest block indices). It walks the
//   kv head's group of query heads and, for each, the band of 64-row query
//   tiles (from max(0, k0 - (Sk - Sq)) / 64), so dk and dv stay summed over
//   the group in registers: deterministic, no workspace. Three warpgroups:
//   - the producer (one warp working) loads K and V once, then keeps a
//     two-stage ring of (Q, dO) tiles in flight with TMA (128-byte
//     swizzle), plus each tile's LSE, delta and segment ids by plain loads;
//     it hands its registers to the consumers (setmaxnreg);
//   - consumer warpgroup w owns keys [64 w, 64 w + 64) of the tile. Per
//     query tile: S^T = K Q^T and dP^T = V dO^T (shared-memory operands),
//     p = exp2(S^T scale log2e - lse log2e) (masked on diagonal and ragged
//     tiles only; query rows past Sq have lse = +inf, so p = 0 there),
//     dS^T = p (dP^T - delta); P^T and dS^T are rounded to bf16 into A
//     fragments in registers for dV += P^T dO and dK += dS^T Q (dO, Q read
//     MN-major), and dS^T is stored transposed (stmatrix) as dS[q][key];
//   - after a named barrier over both consumers, warpgroup w computes
//     dQ^T = K^T dS^T for its 32 of the 64 query rows over all 128 keys,
//     stages it in shared memory (two 128B-swizzled 32 x 32 fp32 boxes,
//     double-buffered) and adds it into the zeroed fp32 (B, Sq, H, 64)
//     workspace with TMA reduce-adds (the L2 does the fp32 adds; rows past
//     Sq are skipped): one 64 x 64 partial per (query tile, key tile)
//     pair, as FA-2 adds it (320 flops a byte). dq is not bit-reproducible
//     (the order of the adds varies); dk and dv are.
//   Bound: the five products, 10 D flops per kept (query, key) pair and
//   query head.
//   TAIL (non-causal, no segment ids; kernel 5, the ViT backward at S =
//   1025 = 8 x 128 + 1): the <= 16 keys past the last full key tile are
//   folded into that tile's CTA, which is launched first, instead of a CTA
//   of their own that would run every query tile's five 64-key products
//   for one key. Its warpgroup 1 takes them at the end of each step with
//   queries as the wgmma rows: S_t = Q K_t^T and dP_t = dO V_t^T (m64n16),
//   P_t^T and dS_t^T stored [key][q] for dV_t^T += dO^T P_t and dK_t^T +=
//   Q^T dS_t (64 d x 16 keys, summed in shared memory between steps so
//   that they hold no registers through the main products: more would
//   spill, and ptxas then serialises every wgmma), and dQ_t = dS_t K_t
//   (one RS product) added by four more TMA reduce-adds.
// 17 (flash_bwd_prep_kernel, flash_bwd_dq_cast_kernel): the launches
//   around 18. Prep reads O and dO once and writes delta = rowsum(dO O)
//   (fp32 (B, H, Sq)) and zeroes the dq workspace; cast writes
//   dq = bf16(workspace * scale). Bound: bytes.
//
// Head dims: 64 here (GAR-1B); 96 and 128 (GAR-8B) in the wide instance
// below (flash_bwd_wide_sm90_kernel), which says how it differs.
//
// Conventions as kernel B's: right-aligned causal offset Sk - Sq, keys
// past Sk masked, GQA, segment ids (Sq == Sk) with (64-row query tile,
// 128-key tile) pairs of disjoint [min, max] id ranges skipped (exact);
// p and dS rounded to bf16 before their products; dq and dk scaled once.
#include "sm90.cuh"

namespace gar {

constexpr int kBwdQ = 64;     // query rows per step
constexpr int kBwdK = 128;    // keys per CTA
constexpr int kBwdD = 64;     // head dim
constexpr int kBwdStages = 2;
constexpr int kBwdThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte-aligned base (128B-swizzled tiles).
constexpr int kOffK = 0;                                 // [128 keys][64] bf16
constexpr int kOffV = kOffK + kBwdK * kBwdD * 2;         // [128 keys][64]
constexpr int kOffQ = kOffV + kBwdK * kBwdD * 2;         // 2 x [64 q][64]
constexpr int kOffO = kOffQ + kBwdStages * kBwdQ * kBwdD * 2;  // 2 x [64 q][64] dO
constexpr int kOffS = kOffO + kBwdStages * kBwdQ * kBwdD * 2;  // 2 x 2 x [64 q][64 keys] dS
constexpr int kOffDQ = kOffS + 2 * 2 * kBwdQ * 64 * 2;  // 2 WG x 2 x [32 q][64] fp32 dQ^T
constexpr int kDQTile = 32 * kBwdD * 4;                  // one warpgroup's, two 32-column boxes
constexpr int kOffLse = kOffDQ + 2 * 2 * kDQTile;        // 2 x 64 fp32 (lse * log2e)
constexpr int kOffDelta = kOffLse + kBwdStages * kBwdQ * 4;
constexpr int kOffSeg = kOffDelta + kBwdStages * kBwdQ * 4;
constexpr int kOffBar = kOffSeg + kBwdStages * kBwdQ * 4;  // full[2], empty[2], kv
constexpr int kBwdSmem = kOffBar + 5 * 8 + 1024;  // + alignment slack
constexpr uint32_t kTileBytes = kBwdQ * kBwdD * 2;
// The folded tail (TAIL only): the <= 16 keys past the last full key tile,
// taken by the CTA of that tile, queries as the wgmma rows.
constexpr int kTailMax = 16;
constexpr int kOffKt = (kOffBar + 5 * 8 + 1023) / 1024 * 1024;  // one 128-row K box
constexpr int kOffVt = kOffKt + kBwdK * kBwdD * 2;               // one 128-row V box
constexpr int kOffPt = kOffVt + kBwdK * kBwdD * 2;  // [16 tail keys][64 q] P^T
constexpr int kOffDSt = kOffPt + kTailMax * 128;     // [16 tail keys][64 q] dS^T
// warpgroup 1's dV_t^T, dK_t^T sums, 16 fp32 a thread, kept here between
// steps so that they hold no registers through the main products
constexpr int kOffTailAcc = kOffDSt + kTailMax * 128;
// the tail's dQ (64 q x 64 d fp32) as four 128B-swizzled [32 q][32 d] boxes
// for the TMA reduce-adds
constexpr int kOffDqt = kOffTailAcc + 128 * 16 * 4;
constexpr int kBwdSmemTail = kOffDqt + kBwdQ * kBwdD * 4 + 1024;

struct BwdMaps {
  CUtensorMap q, k, v, dout;  // bf16 4D (D, S, head, batch), 128B swizzle
  CUtensorMap dq;             // fp32 workspace, boxes of 32 x 32, 128B swizzle
};

struct BwdArgs {
  const float* lse;      // (batch, head, sq) fp32
  const float* delta;    // (batch, head, sq) fp32
  const int* seg;        // (batch, s) int32 or nullptr
  const int* q_tiles;    // with seg: (batch, ceil(s / query tile rows), 2) [min, max] ids
  const int* k_tiles;    // with seg: (batch, ceil(s / 128), 2)
  bf16* dk;              // (batch, sk, kv_head, head dim), contiguous
  bf16* dv;
  int batch, sq, sk, heads, kv_heads, q_offset;  // q_offset = Sk - Sq
  int tail;       // TAIL (head dim 64): the keys past the last full 128-key tile (1 .. kTailMax)
  float scale;
};

// True when query tile qt (of `rows` rows, the q_tiles table's) and 128-key
// tile kt share no segment id.
__device__ __forceinline__ bool bwd_pair_skipped_rows(const BwdArgs& a, int b, int qt, int kt,
                                                      int rows) {
  const int* qtab = a.q_tiles + 2LL * b * ((a.sq + rows - 1) / rows);
  const int* ktab = a.k_tiles + 2LL * b * ((a.sk + kBwdK - 1) / kBwdK);
  return ktab[2 * kt + 1] < qtab[2 * qt] || ktab[2 * kt] > qtab[2 * qt + 1];
}

// The same for kernel 18's 64-row query tiles at head dim 64.
__device__ __forceinline__ bool bwd_pair_skipped(const BwdArgs& a, int b, int qt, int kt) {
  return bwd_pair_skipped_rows(a, b, qt, kt, kBwdQ);
}

template <bool CAUSAL, bool SEG, bool TAIL>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  static_assert(!TAIL || (!CAUSAL && !SEG), "the tail is folded without masks only");
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(sm + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(sm + kOffV);
  bf16* sQ = reinterpret_cast<bf16*>(sm + kOffQ);
  bf16* sO = reinterpret_cast<bf16*>(sm + kOffO);
  float* sLse = reinterpret_cast<float*>(sm + kOffLse);
  float* sDelta = reinterpret_cast<float*>(sm + kOffDelta);
  int* sSeg = reinterpret_cast<int*>(sm + kOffSeg);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  uint64_t* empty = full + 2;
  uint64_t* kv_bar = full + 4;

  // heaviest first: the key tile is the slowest-varying part of the index
  const int pairs = a.kv_heads * a.batch;
  // (TAIL: the last key tile, the heavier one with the tail, first)
  const int kt = TAIL ? gridDim.x / pairs - 1 - blockIdx.x / pairs : blockIdx.x / pairs;
  const int kvh = blockIdx.x % pairs % a.kv_heads, b = blockIdx.x % pairs / a.kv_heads;
  const int k0 = kt * kBwdK;
  const int group = a.heads / a.kv_heads;
  const int n_qt = (a.sq + kBwdQ - 1) / kBwdQ;
  const int qt0 = CAUSAL ? max(0, k0 - a.q_offset) / kBwdQ : 0;
  // the CTA of the last full key tile also takes the a.tail keys after it
  const bool has_tail = TAIL && k0 + kBwdK + a.tail == a.sk;

  if (threadIdx.x == 0) {
    mbar_init(&full[0], 32);  // the producer warp's lanes (one with the TMA bytes)
    mbar_init(&full[1], 32);
    mbar_init(&empty[0], 256);  // every consumer thread
    mbar_init(&empty[1], 256);
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    regs_dealloc<40>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, (has_tail ? 4 : 2) * kBwdK * kBwdD * 2);
      tma_load_4d(sK, &maps.k, kv_bar, 0, k0, kvh, b);
      tma_load_4d(sV, &maps.v, kv_bar, 0, k0, kvh, b);
      if (has_tail) {  // rows past Sk are zero-filled
        tma_load_4d(sm + kOffKt, &maps.k, kv_bar, 0, k0 + kBwdK, kvh, b);
        tma_load_4d(sm + kOffVt, &maps.v, kv_bar, 0, k0 + kBwdK, kvh, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int hh = 0; hh < group; ++hh) {
      const int h = kvh * group + hh;
      const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
      for (int qt = qt0; qt < n_qt; ++qt) {
        if (SEG && bwd_pair_skipped(a, b, qt, kt)) continue;
        const int q0 = qt * kBwdQ;
        float l2[2], dl[2];
        int sg[2] = {-1, -1};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + lane + 32 * r;
          const bool in = q < a.sq;
          l2[r] = in ? a.lse[row_base + q] * kLog2e : __int_as_float(0x7f800000);
          dl[r] = in ? a.delta[row_base + q] : 0.f;
          if (SEG && in) sg[r] = a.seg[static_cast<long long>(b) * a.sq + q];
        }
        mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sLse[stage * kBwdQ + lane + 32 * r] = l2[r];
          sDelta[stage * kBwdQ + lane + 32 * r] = dl[r];
          if (SEG) sSeg[stage * kBwdQ + lane + 32 * r] = sg[r];
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * kTileBytes);
          tma_load_4d(sQ + stage * kBwdQ * kBwdD, &maps.q, &full[stage], 0, q0, h, b);
          tma_load_4d(sO + stage * kBwdQ * kBwdD, &maps.dout, &full[stage], 0, q0, h, b);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == kBwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys k0 + 64 w + [0, 64)
  regs_alloc<232>();
  const int w = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + 64 * w + 16 * wi + g;  // this thread's keys: key_lo, key_lo + 8
  const float sl2 = a.scale * kLog2e;
  int kseg[2] = {0, 0};
  if (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kseg[r] = key_lo + 8 * r < a.sk ? a.seg[static_cast<long long>(b) * a.sk + key_lo + 8 * r]
                                      : -2;
  }
  const bool key_edge = k0 + 64 * w + 64 > a.sk;
  const bf16* sKw = sK + 64 * w * kBwdD;
  const bf16* sVw = sV + 64 * w * kBwdD;
  // stmatrix row addresses: lane (m, i) = (lane / 8, lane % 8) gives memory
  // row i of matrix m of a k-step's four: query 16 kk + 8 (m >> 1) + i,
  // keys 16 wi + 8 (m & 1) .. + 7 (one 16-byte chunk, swizzled by q % 8)
  const int st_m = lane >> 3, st_i = lane & 7;
  const uint32_t st_off = static_cast<uint32_t>(
      (8 * (st_m >> 1) + st_i) * 128 + (((2 * wi + (st_m & 1)) ^ st_i) << 4));
  const uint32_t sS_base = smem_addr(sm + kOffS);
  // this thread's dQ^T values in the warpgroup's [32 q][64 d] fp32 tile
  // (double-buffered by step), as two 128B-swizzled [32 q][32 d] boxes:
  // d = 16 wi + g + 8 r lies in box wi / 2, chunk 4 (wi % 2) + 2 r + g / 4,
  // word g % 4; row q = 8 j + 2 t + c
  const uint8_t* dq_tiles = sm + kOffDQ + w * 2 * kDQTile;
  const uint32_t dq_box = smem_addr(dq_tiles) + (wi >> 1) * (kDQTile / 2) + (g & 3) * 4;
  const int dq_chunk = 4 * (wi & 1) + (g >> 2);
  const bool issuer = (threadIdx.x & 127) == 0;  // issues this warpgroup's reduce-adds
  const uint64_t dKw = desc_sw128(sKw, 16, 1024), dVw = desc_sw128(sVw, 16, 1024);
  const uint64_t dKt = desc_sw128(sK, kBwdK * kBwdD * 2, 1024);
  const uint64_t dQk = desc_sw128(sQ, 16, 1024), dOk = desc_sw128(sO, 16, 1024);
  const uint64_t dQm = desc_sw128(sQ, kTileBytes, 1024), dOm = desc_sw128(sO, kTileBytes, 1024);
  const uint64_t dS = desc_sw128(sm + kOffS + 32 * w * 128, 16, 1024);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  // warpgroup 1 of the tail's CTA: dV_t^T, dK_t^T (64 d x 16 tail keys), 8 + 8 a thread
  float4* tail_acc = reinterpret_cast<float4*>(sm + kOffTailAcc) + 4 * (threadIdx.x & 127);
  auto tail_load = [&](float (&v)[8], float (&k)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 x = tail_acc[i], y = tail_acc[2 + i];
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z, v[4 * i + 3] = x.w;
      k[4 * i] = y.x, k[4 * i + 1] = y.y, k[4 * i + 2] = y.z, k[4 * i + 3] = y.w;
    }
  };
  auto tail_store = [&](const float (&v)[8], const float (&k)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tail_acc[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      tail_acc[2 + i] = make_float4(k[4 * i], k[4 * i + 1], k[4 * i + 2], k[4 * i + 3]);
    }
  };
  if (TAIL && has_tail && w == 1) {
    const float zero[8] = {};
    tail_store(zero, zero);
  }

  mbar_wait(kv_bar, 0);
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      if (SEG && bwd_pair_skipped(a, b, qt, kt)) continue;
      const int q0 = qt * kBwdQ;
      const uint32_t su = stage * (kTileBytes >> 4);
      mbar_wait(&full[stage], phase);

      // S^T = K_w Q^T, dP^T = V_w dO^T: (64 keys x 64 queries), K-major both
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdD / 16; ++kk)
        wgmma_m64n64k16_ss<0, 0>(s, dKw + 2 * kk, dQk + su + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kBwdD / 16; ++kk)
        wgmma_m64n64k16_ss<0, 0>(dp, dVw + 2 * kk, dOk + su + 2 * kk, kk);
      wgmma_commit();

      const float* lse2 = sLse + stage * kBwdQ;
      const float* dl = sDelta + stage * kBwdQ;
      const int* qseg = sSeg + stage * kBwdQ;
      const bool masked = key_edge || SEG || (CAUSAL && q0 + a.q_offset < k0 + 64 * w + 63);

      wgmma_wait<1>();
      fence_regs(s);
      // p, then P^T as bf16 A fragments: k-step kk's fragment is the C
      // fragment of accumulator columns 16 kk .. 16 kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = exp2f(s[4 * j + i] * sl2 - ((i & 1) ? l2.y : l2.x));
        if (masked) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ql = 8 * j + 2 * t + (i & 1), key = key_lo + 8 * (i >> 1);
            bool ok = key < a.sk;
            if (CAUSAL) ok = ok && q0 + ql + a.q_offset >= key;
            if (SEG) ok = ok && qseg[ql] == kseg[i >> 1];
            pv[i] = ok ? pv[i] : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[4 * j + i] = pv[i];  // s now holds p (fp32)
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16x2(pv[0], pv[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(pv[2], pv[3]);
      }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = s[4 * j + i] * (dp[4 * j + i] - ((i & 1) ? d2.y : d2.x));
        da[j >> 1][(j & 1) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      // dS[q][key] for dQ (this warpgroup's 64 keys are column block w)
      const uint32_t sS = sS_base + (it & 1) * (2 * kBwdQ * 64 * 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        stmatrix_x4_trans(sS + w * (kBwdQ * 64 * 2) + st_off + kk * 16 * 128, da[kk]);

      // dV += P^T dO, dK += dS^T Q; B = dO, Q read MN-major, k-step = 16 rows
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dv, pa[kk], dOm + su + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dk, da[kk], dQm + su + 128 * kk);
      wgmma_commit();

      // both halves of dS are in place: dQ^T (64 d x 32 q) = K^T dS^T
      fence_proxy_async();
      bar_sync(1, 256);
      float dq[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdK / 16; ++kk) {
        wgmma_m64n32k16_ss<1, 0>(dq, dKt + 128 * kk,
                                 dS + (it & 1) * 1024 + (kk >> 2) * 512 + 2 * (kk & 3), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      if (!(has_tail && w == 1)) mbar_arrive(&empty[stage]);  // the tail reads Q, dO below

      // dQ^T into the warpgroup's tile, then one TMA reduce-add a box into
      // the workspace rows q0 + 32 w .. + 31 (rows past Sq are skipped)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = 8 * j + 2 * t + (i & 1);
          const uint32_t addr = dq_box + (it & 1) * kDQTile + ql * 128 +
                                (((dq_chunk + 2 * (i >> 1)) ^ (ql & 7)) << 4);
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(dq[4 * j + i]) : "memory");
        }
      fence_proxy_async();
      bar_sync(2 + w, 128);
      if (issuer) {
        const uint8_t* tile = dq_tiles + (it & 1) * kDQTile;
        tma_reduce_add_4d(&maps.dq, tile, 0, q0 + 32 * w, h, b);
        tma_reduce_add_4d(&maps.dq, tile + kDQTile / 2, 32, q0 + 32 * w, h, b);
        bulk_commit();
        // the other buffer, written next step (after the next 256-thread
        // barrier), is free once the previous step's reduce-adds have read it
        bulk_wait_read<1>();
      }
      if (TAIL && has_tail && w == 1) {
        // the tail keys, queries as the wgmma rows: S_t = Q K_t^T, dP_t = dO V_t^T
        // (64 q x 16 keys: d[4 j + 2 r + c] = q 16 wi + g + 8 r, key 8 j + 2 t + c)
        // (made here, so that they hold no registers through the main products)
        const uint64_t dKtl = desc_sw128(sm + kOffKt, 16, 1024);
        const uint64_t dVtl = desc_sw128(sm + kOffVt, 16, 1024);
        const uint64_t dKtlm = desc_sw128(sm + kOffKt, kBwdK * kBwdD * 2, 1024);
        const uint64_t dPtl = desc_sw128(sm + kOffPt, 16, 1024);
        const uint64_t dDStl = desc_sw128(sm + kOffDSt, 16, 1024);
        // stmatrix row addresses of P_t^T, dS_t^T [16 keys][64 q]: lane (m, i)
        // gives key i + 8 (m >> 1), the 16-byte chunk of queries
        // 16 wi + 8 (m & 1) .. + 7, swizzled by key % 8
        const uint32_t tail_st = static_cast<uint32_t>(
            (st_i + 8 * (st_m >> 1)) * 128 + (((2 * wi + (st_m & 1)) ^ st_i) << 4));
        float st[8], dpt[8];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdD / 16; ++kk)
          wgmma_m64n16k16_ss<0, 0>(st, dQk + su + 2 * kk, dKtl + 2 * kk, kk);
#pragma unroll
        for (int kk = 0; kk < kBwdD / 16; ++kk)
          wgmma_m64n16k16_ss<0, 0>(dpt, dOk + su + 2 * kk, dVtl + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        uint32_t pf[4], df[4];  // A fragments of P_t, dS_t: (j, r) = (0, 0), (0, 1), (1, 0), (1, 1)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ql = 16 * wi + g + 8 * r;
            float pv[2], ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 4 * j + 2 * r + c;
              pv[c] = 8 * j + 2 * t + c < a.tail ? exp2f(st[i] * sl2 - lse2[ql]) : 0.f;
              ds[c] = pv[c] * (dpt[i] - dl[ql]);
            }
            pf[2 * j + r] = pack_bf16x2(pv[0], pv[1]);
            df[2 * j + r] = pack_bf16x2(ds[0], ds[1]);
          }
        // P_t^T, dS_t^T as [16 keys][64 q], the B operands of dV_t^T and dK_t^T
        stmatrix_x4_trans(smem_addr(sm + kOffPt) + tail_st, pf);
        stmatrix_x4_trans(smem_addr(sm + kOffDSt) + tail_st, df);
        fence_proxy_async();
        bar_sync(4, 128);
        // dV_t^T += dO^T P_t, dK_t^T += Q^T dS_t (64 d x 16 keys; dO, Q MN-major);
        // dQ_t = dS_t K_t (64 q x 64 d; K_t MN-major)
        float dqt[32], dvt[8], dkt[8];
#pragma unroll
        for (int i = 0; i < 32; ++i) dqt[i] = 0.f;
        tail_load(dvt, dkt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n16k16_ss<1, 0>(dvt, dOm + su + 128 * kk, dPtl + 2 * kk, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n16k16_ss<1, 0>(dkt, dQm + su + 128 * kk, dDStl + 2 * kk, 1);
        wgmma_m64n64k16_rs<1>(dqt, df, dKtlm);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dvt);
        fence_regs(dkt);
        fence_regs(dqt);
        mbar_arrive(&empty[stage]);
        tail_store(dvt, dkt);
        // dQ_t into its four boxes (q half, d half), then one TMA reduce-add
        // a box into the workspace rows q0 .. q0 + 63 (rows past Sq skipped).
        // The previous step's adds have read the boxes: the issuer waited
        // for them before the barrier above.
        const uint32_t dqt_base = smem_addr(sm + kOffDqt);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ql = 16 * wi + g + 8 * r, dl = 8 * j + 2 * t;
            const uint32_t addr = dqt_base + ((ql >> 5) * 2 + (dl >> 5)) * 4096 + (ql & 31) * 128 +
                                  ((((dl & 31) >> 2) ^ (ql & 7)) << 4) + (dl & 3) * 4;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                         "f"(dqt[4 * j + 2 * r]), "f"(dqt[4 * j + 2 * r + 1])
                         : "memory");
          }
        fence_proxy_async();
        bar_sync(4, 128);
        if (issuer) {
#pragma unroll
          for (int box = 0; box < 4; ++box)
            tma_reduce_add_4d(&maps.dq, sm + kOffDqt + box * 4096, 32 * (box & 1),
                              q0 + 32 * (box >> 1), h, b);
          bulk_commit();
        }
      }
      if (++stage == kBwdStages) {
        stage = 0;
        phase ^= 1;
      }
      ++it;
    }
  }

  if (issuer) bulk_wait<0>();

  // dk (scaled once) and dv: rows key_lo + 8 r, columns 8 j + 2 t + c
  const long long kv_ss = static_cast<long long>(a.kv_heads) * kBwdD;
  const long long base = static_cast<long long>(b) * a.sk * kv_ss + kvh * kBwdD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long o = base + key * kv_ss + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(a.dk + o) =
          pack_bf16x2(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + o) = pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
  if (TAIL && has_tail && w == 1) {  // the tail keys: dK_t^T, dV_t^T rows d, columns key
    float dvt[8], dkt[8];
    tail_load(dvt, dkt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + kBwdK + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= a.sk) continue;
      const long long o = base + key * kv_ss + 16 * wi + g + 8 * ((i >> 1) & 1);
      a.dk[o] = __float2bfloat16(dkt[i] * a.scale);
      a.dv[o] = __float2bfloat16(dvt[i]);
    }
  }
}

// Kernel 18 above head dim 64 (flash_bwd_wide_sm90_kernel): 128 (GAR-8B's
// decoder, every mask) and 96 (GAR-8B's PE-G tower, kernel 5: full
// attention, no segment ids). A key row is two 128-byte swizzle atoms,
// each its own 64-column TMA box; 96 rides on 128's layout (the maps' inner
// dim is 96, TMA zero-fills columns 96-127 of every box; S^T and dP^T take
// D / 16 k-steps, exact; the dV / dK products run at n128 over zero columns
// that are never stored; the dq workspace's 32-column boxes past D are not
// added). A consumer thread holds dK and dV for 64 keys x 128 columns, 128
// fp32 registers, and ptxas holds a 384-thread block at 168 registers a
// thread whatever setmaxnreg hands over (the first build of this kernel in
// that form spilled 250-400 bytes and serialised every wgmma), so:
//   - the CTA is the two consumer warpgroups alone, 256 threads (255
//     registers a thread); thread 0 also issues the TMA loads: K and V
//     once, then a four-stage ring of (Q, dO) tiles whose stage is refilled
//     once both warpgroups have passed the next step's named barrier (they
//     have then finished the step that read it), and each thread reads its
//     queries' LSE, delta and segment ids from memory itself;
//   - a step takes 32 query rows (S^T and dP^T m64n32, 16 registers each;
//     their bf16 A fragments 8; dV += P^T dO and dK += dS^T Q at m64n128k16
//     over two k-steps, dO and Q read MN-major with LBO = one atom);
//   - warpgroup w computes dQ^T for its head-dim atom (rows 64 w .. 64 w +
//     63) over all 32 queries: the same m64n32 product and staged [32 q][64
//     d] fp32 tile (two boxes) as at 64, where it takes queries 32 w .. 32
//     w + 31 over the one atom.
// Keys past the last full 128-key tile (S = 1025) get a CTA of their own,
// masked as any ragged tile: the folded tail's two more 128-row K / V boxes
// do not fit beside the 32 KB tiles.
template <int D>
struct WideShape {
  static_assert(D == 96 || D == 128, "the wide instances: head dims 96 and 128");
  static constexpr int kQ = 32;  // query rows a step
  static constexpr int kStages = 4;
  static constexpr int kKSteps = D / 16;  // of S^T and dP^T
  static constexpr int kKAtom = kBwdK * 128;  // bytes of a 128-row K or V atom
  static constexpr int kQAtom = kQ * 128;     // bytes of a Q or dO atom
  static constexpr uint32_t kTileBytes = 2 * kQAtom;
  static constexpr int kSHalf = kQ * 128;  // dS [32 q][64 keys] of one warpgroup
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + 2 * kKAtom;
  static constexpr int kOffQ = kOffV + 2 * kKAtom;             // stages x Q tile
  static constexpr int kOffO = kOffQ + kStages * kTileBytes;     // stages x dO tile
  static constexpr int kOffS = kOffO + kStages * kTileBytes;     // 2 steps x 2 halves of dS
  static constexpr int kOffDQ = kOffS + 2 * 2 * kSHalf;          // 2 WG x 2 staged dQ tiles
  static constexpr int kOffBar = kOffDQ + 2 * 2 * kDQTile;       // full[stages], kv
  static constexpr int kSmem = kOffBar + (kStages + 1) * 8 + 1024;  // + alignment slack
  static_assert(kSmem <= 232448, "over the 227 KB a Hopper block can use");
};

template <int D, bool CAUSAL, bool SEG>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_wide_sm90_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using namespace sm90;
  using Sh = WideShape<D>;
  constexpr int NQ = Sh::kQ, kStages = Sh::kStages;
  constexpr uint32_t kTileBytes = Sh::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sm + Sh::kOffK;
  uint8_t* sV = sm + Sh::kOffV;
  uint8_t* sQ = sm + Sh::kOffQ;
  uint8_t* sO = sm + Sh::kOffO;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sh::kOffBar);
  uint64_t* kv_bar = full + kStages;

  // heaviest first: the key tile is the slowest-varying part of the index
  const int pairs = a.kv_heads * a.batch;
  const int kt = blockIdx.x / pairs;
  const int kvh = blockIdx.x % pairs % a.kv_heads, b = blockIdx.x % pairs / a.kv_heads;
  const int k0 = kt * kBwdK;
  const int group = a.heads / a.kv_heads;
  const int n_qt = (a.sq + NQ - 1) / NQ;
  const int qt0 = CAUSAL ? max(0, k0 - a.q_offset) / NQ : 0;
  // the walk: every query head of the group, each over its kept query tiles;
  // settle moves (hh, qt) to the first kept pair at or after it
  auto settle = [&](int& hh, int& qt) {
    while (hh < group) {
      if (qt >= n_qt) {
        ++hh;
        qt = qt0;
      } else if (SEG && bwd_pair_skipped_rows(a, b, qt, kt, NQ)) {
        ++qt;
      } else {
        return;
      }
    }
  };
  const bool loader = threadIdx.x == 0;
  int lh = 0, lq = qt0;  // the loader's next pair
  auto load_next = [&](int stage) {  // (Q, dO) of the loader's next pair into `stage`
    settle(lh, lq);
    if (lh >= group) return;
    const int h = kvh * group + lh;
    mbar_arrive_expect_tx(&full[stage], 2 * kTileBytes);
#pragma unroll
    for (int at = 0; at < 2; ++at) {
      tma_load_4d(sQ + stage * kTileBytes + at * Sh::kQAtom, &maps.q, &full[stage], 64 * at,
                  lq * NQ, h, b);
      tma_load_4d(sO + stage * kTileBytes + at * Sh::kQAtom, &maps.dout, &full[stage], 64 * at,
                  lq * NQ, h, b);
    }
    ++lq;
  };

  if (loader) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);  // the loader's arrival + bytes
    mbar_init(kv_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(kv_bar, 4 * Sh::kKAtom);  // zero-filled past D and Sk
#pragma unroll
    for (int at = 0; at < 2; ++at) {
      tma_load_4d(sK + at * Sh::kKAtom, &maps.k, kv_bar, 64 * at, k0, kvh, b);
      tma_load_4d(sV + at * Sh::kKAtom, &maps.v, kv_bar, 64 * at, k0, kvh, b);
    }
    for (int s = 0; s < kStages; ++s) load_next(s);
  }
  __syncthreads();

  // warpgroup w owns keys k0 + 64 w + [0, 64)
  const int w = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + 64 * w + 16 * wi + g;  // this thread's keys: key_lo, key_lo + 8
  const float sl2 = a.scale * kLog2e;
  int kseg[2] = {0, 0};
  if (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kseg[r] = key_lo + 8 * r < a.sk ? a.seg[static_cast<long long>(b) * a.sk + key_lo + 8 * r]
                                      : -2;
  }
  const bool key_edge = k0 + 64 * w + 64 > a.sk;
  // stmatrix row addresses: lane (m, i) = (lane / 8, lane % 8) gives memory
  // row i of matrix m of a k-step's four: query 16 kk + 8 (m >> 1) + i,
  // keys 16 wi + 8 (m & 1) .. + 7 (one 16-byte chunk, swizzled by q % 8)
  const int st_m = lane >> 3, st_i = lane & 7;
  const uint32_t st_off = static_cast<uint32_t>(
      (8 * (st_m >> 1) + st_i) * 128 + (((2 * wi + (st_m & 1)) ^ st_i) << 4));
  const uint32_t sS_base = smem_addr(sm + Sh::kOffS);
  // this thread's dQ^T values in the warpgroup's [32 q][64 d] fp32 tile, as
  // at head dim 64: d = 16 wi + g + 8 r of atom w lies in box wi / 2, chunk
  // 4 (wi % 2) + 2 r + g / 4, word g % 4; row q = 8 j + 2 t + c
  const uint8_t* dq_tiles = sm + Sh::kOffDQ + w * 2 * kDQTile;
  const uint32_t dq_box = smem_addr(dq_tiles) + (wi >> 1) * (kDQTile / 2) + (g & 3) * 4;
  const int dq_chunk = 4 * (wi & 1) + (g >> 2);
  const bool issuer = (threadIdx.x & 127) == 0;  // issues this warpgroup's reduce-adds
  // K-major K_w, V_w, Q, dO: k-step kk lies in atom kk / 4, 32 bytes a step into it
  const uint64_t dKw = desc_sw128(sK + 64 * w * 128, 16, 1024);
  const uint64_t dVw = desc_sw128(sV + 64 * w * 128, 16, 1024);
  const uint64_t dQk = desc_sw128(sQ, 16, 1024), dOk = desc_sw128(sO, 16, 1024);
  // MN-major: atom w of K^T for dQ^T; Q and dO (N = 128 columns, LBO = one atom)
  const uint64_t dKt = desc_sw128(sK + w * Sh::kKAtom, Sh::kKAtom, 1024);
  const uint64_t dQm = desc_sw128(sQ, Sh::kQAtom, 1024), dOm = desc_sw128(sO, Sh::kQAtom, 1024);
  const uint64_t dS = desc_sw128(sm + Sh::kOffS, 16, 1024);  // dS^T as dQ^T's B

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  int ch = 0, cq = qt0;  // the consumers' pair
  settle(ch, cq);
  for (int it = 0; ch < group; ++it) {
    const int h = kvh * group + ch;
    const int q0 = cq * NQ;
    const int stage = it % kStages;
    const uint32_t su = stage * (kTileBytes >> 4);
    // this thread's queries q0 + 8 j + 2 t + c: LSE (log2 units), delta, ids
    const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
    float l2[8], dl[8];
    int qseg[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + 8 * (i >> 1) + 2 * t + (i & 1);
      const bool in = q < a.sq;
      l2[i] = in ? a.lse[row_base + q] * kLog2e : __int_as_float(0x7f800000);
      dl[i] = in ? a.delta[row_base + q] : 0.f;
      qseg[i] = SEG && in ? a.seg[static_cast<long long>(b) * a.sq + q] : -1;
    }
    mbar_wait(&full[stage], (it / kStages) & 1);

    // S^T = K_w Q^T, dP^T = V_w dO^T: (64 keys x 32 queries), K-major both
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::kKSteps; ++kk)
      wgmma_m64n32k16_ss<0, 0>(s, dKw + (kk >> 2) * (Sh::kKAtom >> 4) + 2 * (kk & 3),
                               dQk + su + (kk >> 2) * (Sh::kQAtom >> 4) + 2 * (kk & 3), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < Sh::kKSteps; ++kk)
      wgmma_m64n32k16_ss<0, 0>(dp, dVw + (kk >> 2) * (Sh::kKAtom >> 4) + 2 * (kk & 3),
                               dOk + su + (kk >> 2) * (Sh::kQAtom >> 4) + 2 * (kk & 3), kk);
    wgmma_commit();

    const bool masked = key_edge || SEG || (CAUSAL && q0 + a.q_offset < k0 + 64 * w + 63);
    wgmma_wait<1>();
    fence_regs(s);
    // p, then P^T as bf16 A fragments: k-step kk's fragment is the C
    // fragment of accumulator columns 16 kk .. 16 kk + 15
    uint32_t pa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = exp2f(s[4 * j + i] * sl2 - l2[2 * j + (i & 1)]);
      if (masked) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = 8 * j + 2 * t + (i & 1), key = key_lo + 8 * (i >> 1);
          bool ok = key < a.sk;
          if (CAUSAL) ok = ok && q0 + ql + a.q_offset >= key;
          if (SEG) ok = ok && qseg[2 * j + (i & 1)] == kseg[i >> 1];
          pv[i] = ok ? pv[i] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[4 * j + i] = pv[i];  // s now holds p (fp32)
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16x2(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(pv[2], pv[3]);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = s[4 * j + i] * (dp[4 * j + i] - dl[2 * j + (i & 1)]);
      da[j >> 1][(j & 1) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
    // dS[q][key] for dQ (this warpgroup's 64 keys are column block w)
    const uint32_t sS = sS_base + (it & 1) * (2 * Sh::kSHalf);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      stmatrix_x4_trans(sS + w * Sh::kSHalf + st_off + kk * 16 * 128, da[kk]);

    // dV += P^T dO, dK += dS^T Q (64 keys x 128 columns); dO, Q MN-major
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_m64n128k16_rs<1>(dv, pa[kk], dOm + su + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_m64n128k16_rs<1>(dk, da[kk], dQm + su + 128 * kk);
    wgmma_commit();

    // both halves of dS are in place, and both warpgroups are done with the
    // previous step (its products waited for): its stage takes a new pair
    fence_proxy_async();
    bar_sync(1, 256);
    if (loader && it > 0) load_next((it - 1) % kStages);
    // dQ^T (64 d of atom w x 32 q) = K^T dS^T
    float dq[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdK / 16; ++kk) {
      wgmma_m64n32k16_ss<1, 0>(dq, dKt + 128 * kk,
                               dS + (it & 1) * (2 * Sh::kSHalf >> 4) +
                                   (kk >> 2) * (Sh::kSHalf >> 4) + 2 * (kk & 3),
                               kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);

    // dQ^T into the warpgroup's tile, then one TMA reduce-add a box into
    // the workspace rows q0 .. q0 + 31, columns 64 w + 32 x below D (rows
    // past Sq are skipped)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = 8 * j + 2 * t + (i & 1);
        const uint32_t addr = dq_box + (it & 1) * kDQTile + ql * 128 +
                              (((dq_chunk + 2 * (i >> 1)) ^ (ql & 7)) << 4);
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(dq[4 * j + i]) : "memory");
      }
    fence_proxy_async();
    bar_sync(2 + w, 128);
    if (issuer) {
      const uint8_t* tile = dq_tiles + (it & 1) * kDQTile;
      tma_reduce_add_4d(&maps.dq, tile, 64 * w, q0, h, b);
      if (64 * w + 32 < D) tma_reduce_add_4d(&maps.dq, tile + kDQTile / 2, 64 * w + 32, q0, h, b);
      bulk_commit();
      // the other buffer, written next step (after the next 256-thread
      // barrier), is free once the previous step's reduce-adds have read it
      bulk_wait_read<1>();
    }
    ++cq;
    settle(ch, cq);
  }

  if (issuer) bulk_wait<0>();

  // dk (scaled once) and dv: rows key_lo + 8 r, columns 8 j + 2 t + c < D
  const long long kv_ss = static_cast<long long>(a.kv_heads) * D;
  const long long base = static_cast<long long>(b) * a.sk * kv_ss + kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long o = base + key * kv_ss + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(a.dk + o) =
          pack_bf16x2(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + o) = pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// 17, before 18: delta[b, h, q] = sum_d dO O (fp32) and the dq workspace
// zeroed; kLanes threads a (b, q, h) row, each kChunks 8-element chunks
// (64: 8 x 1, 96: 4 x 3, 128: 8 x 2).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout, float* __restrict__ delta,
    float* __restrict__ dq_acc, int sq, int heads, long long rows, long long o_sb,
    long long o_ss, long long o_sh, long long g_sb, long long g_ss, long long g_sh) {
  constexpr int kLanes = D % 64 == 0 ? 8 : 4;
  constexpr int kChunks = D / 8 / kLanes;
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= rows * kLanes) return;  // whole lane groups leave together
  const int c = static_cast<int>(idx % kLanes);
  const long long row = idx / kLanes;
  const int h = static_cast<int>(row % heads);
  const long long bq = row / heads;
  const int q = static_cast<int>(bq % sq);
  const long long b = bq / sq;
  float sum = 0.f;
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const int col = 8 * (c + kLanes * ch);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + b * o_sb + q * o_ss + h * o_sh + col);
    const uint4 gv =
        *reinterpret_cast<const uint4*>(dout + b * g_sb + q * g_ss + h * g_sh + col);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(o2[i]), y = __bfloat1622float2(g2[i]);
      sum += x.x * y.x + x.y * y.y;
    }
  }
  const unsigned lanes = ((1u << kLanes) - 1) << (threadIdx.x & (32 - kLanes));
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1) sum += __shfl_xor_sync(lanes, sum, m);
  if (c == 0) delta[(b * heads + h) * sq + q] = sum;
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    float4* acc = reinterpret_cast<float4*>(dq_acc + row * D + 8 * (c + kLanes * ch));
    acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// 17, after 18: dq = bf16(workspace * scale), 8 elements a thread.
__global__ void __launch_bounds__(256) flash_bwd_dq_cast_kernel(const float* __restrict__ acc,
                                                                bf16* __restrict__ dq,
                                                                long long chunks, float scale) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= chunks) return;
  const float4 x = reinterpret_cast<const float4*>(acc)[2 * idx];
  const float4 y = reinterpret_cast<const float4*>(acc)[2 * idx + 1];
  reinterpret_cast<uint4*>(dq)[idx] =
      make_uint4(pack_bf16x2(x.x * scale, x.y * scale), pack_bf16x2(x.z * scale, x.w * scale),
                 pack_bf16x2(y.x * scale, y.y * scale), pack_bf16x2(y.z * scale, y.w * scale));
}

template <int D>
inline int launch_prep(const void* out, const void* dout, void* delta, void* dq_acc, int sq,
                       int heads, long long rows, const long long (&st)[6], cudaStream_t stream) {
  constexpr int kLanes = D % 64 == 0 ? 8 : 4;
  const long long blocks = (rows * kLanes + 255) / 256;
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      static_cast<float*>(dq_acc), sq, heads, rows, st[0], st[1], st[2], st[3], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAUSAL, bool SEG, bool TAIL = false>
inline int launch_bwd_sm90(const BwdMaps& maps, const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = TAIL ? kBwdSmemTail : kBwdSmem;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_sm90_kernel<CAUSAL, SEG, TAIL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int key_tiles = TAIL ? a.sk / kBwdK : (a.sk + kBwdK - 1) / kBwdK;
  const int grid = key_tiles * a.kv_heads * a.batch;
  flash_bwd_sm90_kernel<CAUSAL, SEG, TAIL><<<grid, kBwdThreads, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL, bool SEG>
inline int launch_bwd_wide(const BwdMaps& maps, const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = WideShape<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_sm90_kernel<D, CAUSAL, SEG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.sk + kBwdK - 1) / kBwdK * a.kv_heads * a.batch;
  flash_bwd_wide_sm90_kernel<D, CAUSAL, SEG><<<grid, 256, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gar

// Kernel 17's first launch. out, dout (batch, sq, heads, head_dim) bf16 with
// element strides; delta (batch, heads, sq) fp32; dq_acc (batch, sq,
// heads, head_dim) fp32 contiguous. head_dim 64, 96 or 128.
extern "C" int gar_flash_bwd_prep(const void* out, const void* dout, void* delta, void* dq_acc,
                                  int batch, int sq, int heads, int head_dim, long long o_sb,
                                  long long o_ss, long long o_sh, long long g_sb, long long g_ss,
                                  long long g_sh, void* stream) {
  const long long rows = static_cast<long long>(batch) * sq * heads;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[6] = {o_sb, o_ss, o_sh, g_sb, g_ss, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return gar::launch_prep<64>(out, dout, delta, dq_acc, sq, heads, rows, st, s);
    case 96: return gar::launch_prep<96>(out, dout, delta, dq_acc, sq, heads, rows, st, s);
    case 128: return gar::launch_prep<128>(out, dout, delta, dq_acc, sq, heads, rows, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel 17's second launch: n elements (a multiple of 8), fp32 -> bf16.
extern "C" int gar_flash_bwd_dq_cast(const void* dq_acc, void* dq, long long n, float scale,
                                     void* stream) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = n / 8;
  gar::flash_bwd_dq_cast_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_acc), static_cast<gar::bf16*>(dq), chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 18. strides: q, k, v, dout element strides (batch, sequence,
// head), 12 values; dk, dv contiguous (batch, sk, kv_heads, head_dim) bf16;
// dq_acc the zeroed workspace (17's prep), which this launch adds into.
// head_dim 64 or 128 (every mask), or 96 (full attention, no segment ids).
extern "C" int gar_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* seg,
                                 const void* q_tiles, const void* k_tiles, void* dq_acc, void* dk,
                                 void* dv, int batch, int sq, int sk, int heads, int kv_heads,
                                 int head_dim, int causal, const long long* strides, float scale,
                                 void* stream) {
  const bool known = head_dim == 64 || head_dim == 128 || (head_dim == 96 && !causal && !seg);
  if (!known || kv_heads <= 0 || heads % kv_heads != 0 || batch <= 0 || sq <= 0 || sk <= 0 ||
      (seg && (sq != sk || !q_tiles || !k_tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  gar::BwdMaps maps;  // inner dim head_dim: a box's columns past it land as zeros
  const int q_rows = head_dim == 64 ? gar::kBwdQ : gar::WideShape<128>::kQ;
  const long long dq_ss = static_cast<long long>(heads) * head_dim;
  int err = gar::encode_rows(&maps.q, q, false, sq, heads, batch, strides[0], strides[1],
                             strides[2], q_rows, head_dim);
  if (!err)
    err = gar::encode_rows(&maps.k, k, false, sk, kv_heads, batch, strides[3], strides[4],
                           strides[5], gar::kBwdK, head_dim);
  if (!err)
    err = gar::encode_rows(&maps.v, v, false, sk, kv_heads, batch, strides[6], strides[7],
                           strides[8], gar::kBwdK, head_dim);
  if (!err)
    err = gar::encode_rows(&maps.dout, dout, false, sq, heads, batch, strides[9], strides[10],
                           strides[11], q_rows, head_dim);
  if (!err)
    err = gar::encode_rows(&maps.dq, dq_acc, true, sq, heads, batch, sq * dq_ss, dq_ss,
                           head_dim, 32, head_dim);
  if (err) return err;
  gar::BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.seg = static_cast<const int*>(seg);
  a.q_tiles = static_cast<const int*>(q_tiles);
  a.k_tiles = static_cast<const int*>(k_tiles);
  a.dk = static_cast<gar::bf16*>(dk);
  a.dv = static_cast<gar::bf16*>(dv);
  a.batch = batch;
  a.sq = sq;
  a.sk = sk;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.q_offset = sk - sq;
  a.scale = scale;
  // at head dim 64 a few keys past the last full tile (S = 1025 in the
  // ViT) are folded into that tile's CTA, not given a CTA of their own that
  // would walk every query tile for them
  const int rem = sk % gar::kBwdK;
  a.tail = head_dim == 64 && !causal && !seg && sk > gar::kBwdK && rem <= gar::kTailMax ? rem : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 96) return gar::launch_bwd_wide<96, false, false>(maps, a, st);
  if (head_dim == 128) {
    if (causal) return seg ? gar::launch_bwd_wide<128, true, true>(maps, a, st)
                           : gar::launch_bwd_wide<128, true, false>(maps, a, st);
    return seg ? gar::launch_bwd_wide<128, false, true>(maps, a, st)
               : gar::launch_bwd_wide<128, false, false>(maps, a, st);
  }
  if (causal) return seg ? gar::launch_bwd_sm90<true, true>(maps, a, st)
                         : gar::launch_bwd_sm90<true, false>(maps, a, st);
  if (seg) return gar::launch_bwd_sm90<false, true>(maps, a, st);
  return a.tail ? gar::launch_bwd_sm90<false, false, true>(maps, a, st)
                : gar::launch_bwd_sm90<false, false>(maps, a, st);
}
