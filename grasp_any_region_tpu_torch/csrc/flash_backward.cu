// Kernels 5, 17 and 18: the attention backward (FA-2 recurrences), bf16
// operands, fp32 sums, mma.sync m16n8k16 on the flash tile's fragment
// layouts (flash_tile.cuh, common.cuh).
//
// Given q, k, v, dO, the forward's per-row log-sum-exp (lse) and
// delta = rowsum(dO * O) (computed by the wrapper, as the JAX package
// computes it outside Pallas), each 64 x 64 block of probabilities is
// recomputed as p = exp(scale * q k^T - lse) and
//   dv += p^T dO,   dp = dO v^T,   ds = p * (dp - delta) (rounded to bf16),
//   dq += ds k,     dk += ds^T q   (dq and dk scaled once at the end).
// p is rounded to bf16 before its product, as the TPU kernels round it.
// Masks: keys past Sk by bounds, query rows past Sq (their dO and lse are
// never read), the right-aligned causal band q + (Sk - Sq) >= key, and
// segment ids (self-attention: equal ids only), where a pair of 64-row
// tiles whose [min, max] id ranges are disjoint is skipped (exact: all its
// p are 0), so packed rows do the work of their documents, not of the band.
//
// 17 (dq, replaces grasp_any_region_tpu/ops/flash_backward.py:_dq_kernel):
//   one block per (64 query rows, head, batch); q and dO stay in registers
//   as A fragments and the block walks the 64-key tiles of its causal band
//   (JAX's clamp_ki), so memory is O(S): nothing (Sq, Sk)-sized is stored.
// 18 (dk, dv, replaces _dkv_kernel): one block per (64 keys, kv head,
//   batch); the block walks the query tiles from the band's start (JAX's
//   clamp_qi) for every query head of its GQA group, so dk and dv leave the
//   block summed over the group, with no per-head fp32 copy and no
//   group-sum pass (the TPU form writes (B*H, S, D) fp32 and sums in XLA).
// 5 (the ViT one-pass backward, replaces
//   grasp_any_region_tpu/ops/vit_attention.py:_vit_bwd_kernel): the TPU
//   kernel holds a whole head's K, V and (S, D) fp32 dk/dv sums in VMEM,
//   about four times the 227 KB of an H100 SM at S = 1025. Here it is 18's
//   loop (non-causal, one head per kv head) with the dq share added too:
//   each 64 x 64 p block is computed once and feeds dv, dp, dk and dq; the
//   block's ds goes through shared memory so each warp multiplies 16 query
//   rows by the block's K, and adds that into an fp32 dq workspace with
//   red.global.add.f32 (the wrapper casts it to bf16 once at the end).
//
// All are bound by the tensor-core products at the shapes of the train
// step (5: 5 x 2 S^2 D per tile-head; 17: 3, 18: 4 products over the
// causal half), not by bytes.
#include "flash_tile.cuh"

namespace gar {

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (batch, head, sq) fp32
  const float* delta;  // (batch, head, sq) fp32
  const int* seg;      // (batch, seq) int32 or nullptr
  const int* seg_tiles;  // with seg: (batch, ceil(seq / 64), 2) [min, max] ids
  bf16* dq;            // (batch, sq, head, D), contiguous
  bf16* dk;            // (batch, sk, kv_head, D), contiguous
  bf16* dv;
  float* dq_acc;       // one-pass only: fp32 (batch, sq, head, D) workspace, zeroed
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int sq, sk, heads, kv_heads;
  int q_offset;  // Sk - Sq
  float scale;
};

constexpr int kBwdBlock = 64;  // query rows and keys per tile
static_assert(kBwdBlock == kSegTile, "seg_tiles rows must match the tiles");
constexpr int kBwdThreads = 128;

// 17: dq for one (64-row query tile, head, batch).
template <int D, bool CAUSAL, bool SEG>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BM = kBwdBlock, BN = kBwdBlock, NT = kBwdThreads, LD = D + kSmemPad;
  __shared__ __align__(16) bf16 sQ[BM * LD];
  __shared__ __align__(16) bf16 sdO[BM * LD];
  __shared__ __align__(16) bf16 sK[BN * LD];
  __shared__ __align__(16) bf16 sV[BN * LD];
  __shared__ int sSeg[SEG ? BN : 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  stage_rows<D, LD, false, NT>(sQ, qb, p.q_ss, q0, BM, p.sq, nullptr, nullptr, tid);
  stage_rows<D, LD, false, NT>(sdO, ob, p.o_ss, q0, BM, p.sq, nullptr, nullptr, tid);
  __syncthreads();

  const int row0 = warp * 16 + g;
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = ld_u32(&sQ[row0 * LD + c]);
    qf[ks][1] = ld_u32(&sQ[(row0 + 8) * LD + c]);
    qf[ks][2] = ld_u32(&sQ[row0 * LD + c + 8]);
    qf[ks][3] = ld_u32(&sQ[(row0 + 8) * LD + c + 8]);
    of[ks][0] = ld_u32(&sdO[row0 * LD + c]);
    of[ks][1] = ld_u32(&sdO[(row0 + 8) * LD + c]);
    of[ks][2] = ld_u32(&sdO[row0 * LD + c + 8]);
    of[ks][3] = ld_u32(&sdO[(row0 + 8) * LD + c + 8]);
  }
  const int r0 = q0 + row0, r1 = r0 + 8;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const bool in0 = r0 < p.sq, in1 = r1 < p.sq;
  const float lse0 = in0 ? p.lse[row_base + r0] : 0.f, lse1 = in1 ? p.lse[row_base + r1] : 0.f;
  const float dl0 = in0 ? p.delta[row_base + r0] : 0.f, dl1 = in1 ? p.delta[row_base + r1] : 0.f;
  const int* segb = SEG ? p.seg + static_cast<long long>(b) * p.sk : nullptr;
  const int seg0 = SEG && in0 ? segb[r0] : -1, seg1 = SEG && in1 ? segb[r1] : -1;
  const int* tiles_b =
      SEG ? p.seg_tiles + 2LL * b * ((p.sk + kSegTile - 1) / kSegTile) : nullptr;
  const int qi0 = r0 + p.q_offset, qi1 = r1 + p.q_offset;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = (p.sk + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (p.q_offset + q0 + BM - 1) / BN + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    if (SEG && segments_disjoint(tiles_b, q0 / kSegTile, j)) continue;  // uniform in the block
    __syncthreads();
    stage_rows<D, LD, false, NT>(sK, kb, p.k_ss, k0, BN, p.sk, nullptr, nullptr, tid);
    stage_rows<D, LD, false, NT>(sV, vb, p.v_ss, k0, BN, p.sk, nullptr, nullptr, tid);
    if (SEG && tid < BN) sSeg[tid] = k0 + tid < p.sk ? segb[k0 + tid] : -2;
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const bf16* krow = &sK[(nt * 8 + g) * LD + 2 * t];
      const bf16* vrow = &sV[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        mma_bf16_16816(s[nt], qf[ks], ld_u32(krow + ks * 16), ld_u32(krow + ks * 16 + 8));
        mma_bf16_16816(dp[nt], of[ks], ld_u32(vrow + ks * 16), ld_u32(vrow + ks * 16 + 8));
      }
    }
    // ds = p (dp - delta), rounded to bf16 into the A fragments of dS K
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        bool ok = key < p.sk && (i < 2 ? in0 : in1);
        if (CAUSAL) ok = ok && ((i < 2 ? qi0 : qi1) >= key);
        if (SEG) ok = ok && (sSeg[key - k0] == (i < 2 ? seg0 : seg1));
        const float pv = ok ? expf(s[nt][i] * p.scale - (i < 2 ? lse0 : lse1)) : 0.f;
        ds[i] = pv * (dp[nt][i] - (i < 2 ? dl0 : dl1));
      }
      da[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
      da[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
    // dQ += dS K; K's B fragments by ldmatrix.trans (key-major in smem)
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &sK[(kk * 16 + (lane & 15)) * LD + jd * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(acc[2 * jd], da[kk], bf[0], bf[1]);
        mma_bf16_16816(acc[2 * jd + 1], da[kk], bf[2], bf[3]);
      }
    }
  }

  const long long dq_ss = static_cast<long long>(p.heads) * D;
  bf16* dqb = p.dq + static_cast<long long>(b) * p.sq * dq_ss + h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<uint32_t*>(dqb + r0 * dq_ss + d) =
          pack_bf16x2(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(dqb + r1 * dq_ss + d) =
          pack_bf16x2(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
  }
}

// 18 (ONEPASS = false): dk, dv for one (64-key tile, kv head, batch),
// summed over the kv head's query heads. 5 (ONEPASS = true): the same with
// the dq share added atomically into p.dq_acc.
template <int D, bool CAUSAL, bool SEG, bool ONEPASS>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BM = kBwdBlock, BN = kBwdBlock, NT = kBwdThreads, LD = D + kSmemPad;
  __shared__ __align__(16) bf16 sK[BN * LD];
  __shared__ __align__(16) bf16 sV[BN * LD];
  __shared__ __align__(16) bf16 sQ[BM * LD];
  __shared__ __align__(16) bf16 sdO[BM * LD];
  __shared__ __align__(16) bf16 sdS[ONEPASS ? BM * LD : 8];  // ds as [query][key]
  __shared__ float sLse[BM], sDelta[BM];
  __shared__ int sSeg[SEG ? BM : 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BN, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  stage_rows<D, LD, false, NT>(sK, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, BN, p.sk,
                               nullptr, nullptr, tid);
  stage_rows<D, LD, false, NT>(sV, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, BN, p.sk,
                               nullptr, nullptr, tid);

  const int row0 = warp * 16 + g;  // this thread's keys in the tile: row0, row0 + 8
  const int key0 = k0 + row0, key1 = key0 + 8;
  const int* segb = SEG ? p.seg + static_cast<long long>(b) * p.sk : nullptr;
  const int kseg0 = SEG && key0 < p.sk ? segb[key0] : -2;
  const int kseg1 = SEG && key1 < p.sk ? segb[key1] : -2;
  const int* tiles_b =
      SEG ? p.seg_tiles + 2LL * b * ((p.sk + kSegTile - 1) / kSegTile) : nullptr;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int n_qt = (p.sq + BM - 1) / BM;
  const int qt0 = CAUSAL ? max(0, k0 - p.q_offset) / BM : 0;  // the causal band's first tile
  const long long dq_ss = static_cast<long long>(p.heads) * D;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* ob = p.dout + b * p.o_sb + h * p.o_sh;
    const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      if (SEG && segments_disjoint(tiles_b, qt, blockIdx.x)) continue;  // uniform in the block
      __syncthreads();  // every warp is done with the previous tile (and sdS)
      stage_rows<D, LD, false, NT>(sQ, qb, p.q_ss, q0, BM, p.sq, nullptr, nullptr, tid);
      stage_rows<D, LD, false, NT>(sdO, ob, p.o_ss, q0, BM, p.sq, nullptr, nullptr, tid);
      if (tid < BM) {
        const bool in = q0 + tid < p.sq;
        sLse[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
        sDelta[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
        if (SEG) sSeg[tid] = in ? segb[q0 + tid] : -1;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries;
      // K and V A fragments come from shared memory per k-step
      float s[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 + 2 * t;
        const uint32_t ka[4] = {ld_u32(&sK[row0 * LD + c]), ld_u32(&sK[(row0 + 8) * LD + c]),
                                ld_u32(&sK[row0 * LD + c + 8]),
                                ld_u32(&sK[(row0 + 8) * LD + c + 8])};
        const uint32_t va[4] = {ld_u32(&sV[row0 * LD + c]), ld_u32(&sV[(row0 + 8) * LD + c]),
                                ld_u32(&sV[row0 * LD + c + 8]),
                                ld_u32(&sV[(row0 + 8) * LD + c + 8])};
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt) {
          const bf16* qrow = &sQ[(nt * 8 + g) * LD + c];
          const bf16* orow = &sdO[(nt * 8 + g) * LD + c];
          mma_bf16_16816(s[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
          mma_bf16_16816(dpt[nt], va, ld_u32(orow), ld_u32(orow + 8));
        }
      }
      // P^T and dS^T into A fragments (rows keys, k = queries)
      uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        float pv[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = nt * 8 + 2 * t + (i & 1);
          const int key = i < 2 ? key0 : key1;
          bool ok = key < p.sk && q0 + ql < p.sq;
          if (CAUSAL) ok = ok && (q0 + ql + p.q_offset >= key);
          if (SEG) ok = ok && (sSeg[ql] == (i < 2 ? kseg0 : kseg1));
          pv[i] = ok ? expf(s[nt][i] * p.scale - sLse[ql]) : 0.f;
          ds[i] = pv[i] * (dpt[nt][i] - sDelta[ql]);
          if (ONEPASS) sdS[ql * LD + row0 + (i < 2 ? 0 : 8)] = __float2bfloat16(ds[i]);
        }
        pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(pv[0], pv[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(pv[2], pv[3]);
        da[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        da[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q; B fragments by ldmatrix.trans
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          uint32_t bo[4], bq[4];
          const int off = (kk * 16 + (lane & 15)) * LD + jd * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bo, &sdO[off]);
          ldmatrix_x4_trans(bq, &sQ[off]);
          mma_bf16_16816(dv[2 * jd], pa[kk], bo[0], bo[1]);
          mma_bf16_16816(dv[2 * jd + 1], pa[kk], bo[2], bo[3]);
          mma_bf16_16816(dk[2 * jd], da[kk], bq[0], bq[1]);
          mma_bf16_16816(dk[2 * jd + 1], da[kk], bq[2], bq[3]);
        }
      }
      if constexpr (ONEPASS) {
        // dQ rows [q0 + 16 warp, +16) += dS K over this block's 64 keys
        __syncthreads();
        float acc[D / 8][4];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const int c = kk * 16 + 2 * t;
          const uint32_t a[4] = {ld_u32(&sdS[row0 * LD + c]), ld_u32(&sdS[(row0 + 8) * LD + c]),
                                 ld_u32(&sdS[row0 * LD + c + 8]),
                                 ld_u32(&sdS[(row0 + 8) * LD + c + 8])};
#pragma unroll
          for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, &sK[(kk * 16 + (lane & 15)) * LD + jd * 16 + (lane >> 4) * 8]);
            mma_bf16_16816(acc[2 * jd], a, bk[0], bk[1]);
            mma_bf16_16816(acc[2 * jd + 1], a, bk[2], bk[3]);
          }
        }
        const int r0 = q0 + row0, r1 = r0 + 8;
        float* qa = p.dq_acc + static_cast<long long>(b) * p.sq * dq_ss + h * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int d = dt * 8 + 2 * t;
          if (r0 < p.sq) {
            atomicAdd(qa + r0 * dq_ss + d, acc[dt][0] * p.scale);
            atomicAdd(qa + r0 * dq_ss + d + 1, acc[dt][1] * p.scale);
          }
          if (r1 < p.sq) {
            atomicAdd(qa + r1 * dq_ss + d, acc[dt][2] * p.scale);
            atomicAdd(qa + r1 * dq_ss + d + 1, acc[dt][3] * p.scale);
          }
        }
      }
    }
  }

  const long long kv_ss = static_cast<long long>(p.kv_heads) * D;
  const long long base = static_cast<long long>(b) * p.sk * kv_ss + kvh * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (key0 < p.sk) {
      *reinterpret_cast<uint32_t*>(p.dk + base + key0 * kv_ss + d) =
          pack_bf16x2(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + base + key0 * kv_ss + d) =
          pack_bf16x2(dv[dt][0], dv[dt][1]);
    }
    if (key1 < p.sk) {
      *reinterpret_cast<uint32_t*>(p.dk + base + key1 * kv_ss + d) =
          pack_bf16x2(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + base + key1 * kv_ss + d) =
          pack_bf16x2(dv[dt][2], dv[dt][3]);
    }
  }
}

inline BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* seg,
                            const void* seg_tiles, void* dq,
                            void* dk, void* dv, void* dq_acc, int sq, int sk, int heads,
                            int kv_heads, const long long* strides, float scale) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.seg_tiles = static_cast<const int*>(seg_tiles);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.q_offset = sk - sq;
  p.scale = scale;
  return p;
}

template <bool CAUSAL, bool SEG>
inline void launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.sq + kBwdBlock - 1) / kBwdBlock, p.heads, batch);
  flash_bwd_dq_kernel<64, CAUSAL, SEG><<<grid, kBwdThreads, 0, stream>>>(p);
}

template <bool CAUSAL, bool SEG, bool ONEPASS>
inline void launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.sk + kBwdBlock - 1) / kBwdBlock, p.kv_heads, batch);
  flash_bwd_dkv_kernel<64, CAUSAL, SEG, ONEPASS><<<grid, kBwdThreads, 0, stream>>>(p);
}

}  // namespace gar

// strides: q, k, v, dO element strides (batch, sequence, head), 12 values.
// The outputs are contiguous (batch, seq, head, 64) bf16.
extern "C" int gar_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* seg, const void* seg_tiles, void* dq, int batch, int sq,
    int sk, int heads, int kv_heads, int head_dim, int causal, const long long* strides,
    float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || heads % kv_heads != 0 ||
      (seg && (sq != sk || !seg_tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  const gar::BwdParams p = gar::bwd_params(q, k, v, dout, lse, delta, seg, seg_tiles, dq,
                                           nullptr, nullptr, nullptr, sq, sk, heads, kv_heads,
                                           strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal) {
    if (seg) gar::launch_dq<true, true>(p, batch, st);
    else gar::launch_dq<true, false>(p, batch, st);
  } else {
    if (seg) gar::launch_dq<false, true>(p, batch, st);
    else gar::launch_dq<false, false>(p, batch, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gar_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* seg, const void* seg_tiles, void* dk, void* dv, int batch,
    int sq, int sk, int heads, int kv_heads, int head_dim, int causal, const long long* strides,
    float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || heads % kv_heads != 0 ||
      (seg && (sq != sk || !seg_tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  const gar::BwdParams p = gar::bwd_params(q, k, v, dout, lse, delta, seg, seg_tiles, nullptr,
                                           dk, dv, nullptr, sq, sk, heads, kv_heads, strides,
                                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal) {
    if (seg) gar::launch_dkv<true, true, false>(p, batch, st);
    else gar::launch_dkv<true, false, false>(p, batch, st);
  } else {
    if (seg) gar::launch_dkv<false, true, false>(p, batch, st);
    else gar::launch_dkv<false, false, false>(p, batch, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5: (tiles, seq, heads, 64) q, k, v, dO; lse and delta (tiles,
// heads, seq); dq_acc a zeroed fp32 (tiles, seq, heads, 64) workspace.
extern "C" int gar_vit_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, float* dq_acc, void* dk, void* dv, int tiles, int seq, int heads,
    int head_dim, const long long* strides, float scale, void* stream) {
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const gar::BwdParams p = gar::bwd_params(q, k, v, dout, lse, delta, nullptr, nullptr, nullptr,
                                           dk, dv, dq_acc, seq, seq, heads, heads, strides,
                                           scale);
  gar::launch_dkv<false, false, true>(p, tiles, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
