// Online-softmax attention over one 64-row query tile: the body shared by
// kernel A (ViT attention, vit_attention.cu) and kernel B (prefill flash
// attention, flash_attention.cu).
//
// One block owns BM query rows of one (batch, head), one warp per 16 rows:
// 64 rows (4 warps) for A and B, 128 (8 warps) for E, whose K/V staging
// with rope costs more and is then shared by twice the query rows. K/V stream through shared memory in 64-key tiles, both
// key-major as they lie in memory. Both products run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 sum): S = Q K^T from
// register-resident Q fragments, then P V with the fp32 probabilities
// rounded to bf16, as the TPU kernels round p before their PV dot; V's B
// fragments come from ldmatrix.trans, so V is never transposed in shared
// memory. Max, sum and the output accumulator stay fp32 in registers.
//
// Tensors are read through element strides for (batch, seq, head); the
// head dim is contiguous. So the JAX (B, S, H, D) layout, and views such as
// the v slice of the ViT's fused qkv buffer, need no transpose copy.
// Keys past Sk are masked by bounds (nothing is padded); causal masks are
// right-aligned by q_offset = Sk - Sq, and K tiles wholly above the
// diagonal are never loaded.
//
// Two outputs for the backward (flash_backward.cu): with `lse` set, each
// row's log-sum-exp of the scaled logits, m + log(l) from the online
// state, fp32 (batch, head, seq); with SEG, int32 segment ids (batch, seq)
// for self-attention (Sq == Sk): a pair is kept only where the ids are
// equal, on top of the causal and bound masks (packed rows; id 0 is
// padding and attends only padding). seg_tiles holds each 64-row tile's
// [min, max] id: a K tile whose range is disjoint from the query tile's
// has no equal pair and is skipped, which is exact (its p are all 0).
//
// With ROPE (kernel E), Q and K rows are rotated while they are staged into
// shared memory: rotate_half pairs element i with i +- D/2 of the same head,
// which no mma fragment holds together, so each thread takes the 8-element
// chunks at c and c + D/2 of one row, rotates them in fp32 with the row's
// cos/sin (fp32 tables (head, seq, D), element strides rope_sh and D) and
// rounds to bf16, as the TPU kernel rounds roped q/k before its products.
#pragma once

#include "common.cuh"

namespace gar {

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const float* cos;  // ROPE only: (head, seq, D) fp32 tables
  const float* sin;
  long long rope_sh;
  float* lse = nullptr;             // optional (batch, head, seq) fp32 log-sum-exp
  long long lse_sb = 0, lse_sh = 0;  // its batch and head strides (rows contiguous)
  const int* seg = nullptr;         // SEG only: (batch, seq) int32 segment ids
  long long seg_sb = 0;
  const int* seg_tiles = nullptr;   // SEG only: (batch, ceil(seq / 64), 2) [min, max] ids
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, sk;
  int group;     // query heads per kv head (GQA): kv head = h / group
  int q_offset;  // global position of query row 0 (Sk - Sq)
  float scale;
};

constexpr int kFlashBN = 64;       // keys per tile
constexpr int kSmemPad = 8;        // bf16 pad per smem row: conflict-free fragment loads
constexpr int kSegTile = 64;       // rows per entry of seg_tiles

// True when 64-row tiles qt and kt of one row's [min, max] segment-id table
// share no id range, so no (query, key) pair of theirs has equal ids.
__device__ __forceinline__ bool segments_disjoint(const int* tiles, int qt, int kt) {
  return tiles[2 * kt + 1] < tiles[2 * qt] || tiles[2 * kt] > tiles[2 * qt + 1];
}

// Stage rows [r0, r0 + rows) of a (seq, D) operand into dst (row stride LD),
// zeros past `limit`. With ROPE, rotate each row by its cos/sin table row
// (x * cos + rotate_half(x) * sin, fp32) before the bf16 store.
template <int D, int LD, bool ROPE, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ss, int r0,
                                           int rows, int limit, const float* cos,
                                           const float* sin, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (!ROPE) {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    for (int c = tid; c < rows * CPR; c += NT) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      uint4 val = zero;
      if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + cc);
      *reinterpret_cast<uint4*>(&dst[r * LD + cc]) = val;
    }
  } else {
    constexpr int HALF = D / 2, CPH = HALF / 8;  // chunk pairs (c, c + D/2) per row
    for (int c = tid; c < rows * CPH; c += NT) {
      const int r = c / CPH, cc = (c % CPH) * 8;
      uint4 out1 = zero, out2 = zero;
      if (r0 + r < limit) {
        const bf16* row = src + (r0 + r) * ss;
        const uint4 in1 = *reinterpret_cast<const uint4*>(row + cc);
        const uint4 in2 = *reinterpret_cast<const uint4*>(row + HALF + cc);
        const bf16* x1 = reinterpret_cast<const bf16*>(&in1);
        const bf16* x2 = reinterpret_cast<const bf16*>(&in2);
        const float4* c4 = reinterpret_cast<const float4*>(cos + (long long)(r0 + r) * D + cc);
        const float4* s4 = reinterpret_cast<const float4*>(sin + (long long)(r0 + r) * D + cc);
        const float4 cl[2] = {c4[0], c4[1]}, ch[2] = {c4[HALF / 4], c4[HALF / 4 + 1]};
        const float4 sl[2] = {s4[0], s4[1]}, sh[2] = {s4[HALF / 4], s4[HALF / 4 + 1]};
        const float* cosl = reinterpret_cast<const float*>(cl);
        const float* cosh_ = reinterpret_cast<const float*>(ch);
        const float* sinl = reinterpret_cast<const float*>(sl);
        const float* sinh_ = reinterpret_cast<const float*>(sh);
        uint32_t* w1 = reinterpret_cast<uint32_t*>(&out1);
        uint32_t* w2 = reinterpret_cast<uint32_t*>(&out2);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float a0 = __bfloat162float(x1[e]), a1 = __bfloat162float(x1[e + 1]);
          const float b0 = __bfloat162float(x2[e]), b1 = __bfloat162float(x2[e + 1]);
          // first half: x1 cos - x2 sin; second half: x2 cos + x1 sin
          w1[e / 2] = pack_bf16x2(a0 * cosl[e] - b0 * sinl[e], a1 * cosl[e + 1] - b1 * sinl[e + 1]);
          w2[e / 2] = pack_bf16x2(b0 * cosh_[e] + a0 * sinh_[e], b1 * cosh_[e + 1] + a1 * sinh_[e + 1]);
        }
      }
      *reinterpret_cast<uint4*>(&dst[r * LD + cc]) = out1;
      *reinterpret_cast<uint4*>(&dst[r * LD + HALF + cc]) = out2;
    }
  }
}

// BM query rows per block, one warp per 16 of them.
template <int D, bool CAUSAL, bool ROPE, int BM, bool SEG>
__global__ void __launch_bounds__(BM * 2)
flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BN = kFlashBN, NT = BM * 2;
  constexpr int LDQ = D + kSmemPad;   // sQ, sK, sV: [row][d]
  __shared__ __align__(16) bf16 sQ[BM * LDQ];
  __shared__ __align__(16) bf16 sK[BN * LDQ];
  __shared__ __align__(16) bf16 sV[BN * LDQ];
  __shared__ int sSeg[SEG ? BN : 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const float* cos_h = ROPE ? p.cos + h * p.rope_sh : nullptr;
  const float* sin_h = ROPE ? p.sin + h * p.rope_sh : nullptr;

  stage_rows<D, LDQ, ROPE, NT>(sQ, qb, p.q_ss, q0, BM, p.sq, cos_h, sin_h, tid);
  __syncthreads();

  uint32_t qf[D / 16][4];
  const int row0 = warp * 16 + g;  // this thread's rows in the tile: row0, row0 + 8
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = ld_u32(&sQ[row0 * LDQ + c]);
    qf[ks][1] = ld_u32(&sQ[(row0 + 8) * LDQ + c]);
    qf[ks][2] = ld_u32(&sQ[row0 * LDQ + c + 8]);
    qf[ks][3] = ld_u32(&sQ[(row0 + 8) * LDQ + c + 8]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int qi0 = q0 + row0 + p.q_offset;  // global positions of the two rows
  const int qi1 = qi0 + 8;
  const int* segb = SEG ? p.seg + b * p.seg_sb : nullptr;
  const int n_seg_tiles = (p.sk + kSegTile - 1) / kSegTile;
  const int* tiles_b = SEG ? p.seg_tiles + 2LL * b * n_seg_tiles : nullptr;
  int seg0 = 0, seg1 = 0;  // the two rows' segment ids (Sq == Sk under SEG)
  if (SEG) {
    seg0 = q0 + row0 < p.sq ? segb[q0 + row0] : -1;
    seg1 = q0 + row0 + 8 < p.sq ? segb[q0 + row0 + 8] : -1;
  }

  int n_tiles = (p.sk + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (p.q_offset + q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    if (SEG && segments_disjoint(tiles_b, q0 / kSegTile, j)) continue;  // uniform in the block
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D, LDQ, ROPE, NT>(sK, kb, p.k_ss, k0, BN, p.sk, cos_h, sin_h, tid);
    stage_rows<D, LDQ, false, NT>(sV, vb, p.v_ss, k0, BN, p.sk, nullptr, nullptr, tid);
    if (SEG && tid < BN) sSeg[tid] = k0 + tid < p.sk ? segb[k0 + tid] : -2;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = &sK[(nt * 8 + g) * LDQ + 2 * t];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_bf16_16816(s[nt], qf[ks], ld_u32(krow + ks * 16), ld_u32(krow + ks * 16 + 8));
    }

    // scale, mask, online softmax (fp32)
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        bool ok = key < p.sk;
        if (CAUSAL) ok = ok && ((i < 2 ? qi0 : qi1) >= key);
        if (SEG) ok = ok && (sSeg[key - k0] == (i < 2 ? seg0 : seg1));
        s[nt][i] = ok ? s[nt][i] * p.scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = expf(m_run[0] - mx0), alpha1 = expf(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;

    // p = exp(s - m); masked entries are exactly kNegInf and give 0. The C
    // fragments of n-tiles 2kk and 2kk+1 form the A fragment of k-step kk.
    uint32_t pa[BN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = s[nt][0] == kNegInf ? 0.f : expf(s[nt][0] - mx0);
      const float p1 = s[nt][1] == kNegInf ? 0.f : expf(s[nt][1] - mx0);
      const float p2 = s[nt][2] == kNegInf ? 0.f : expf(s[nt][2] - mx1);
      const float p3 = s[nt][3] == kNegInf ? 0.f : expf(s[nt][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l_run[0] = l_run[0] * alpha0 + rs0;
    l_run[1] = l_run[1] * alpha1 + rs1;

    // O = O * alpha + P V; the B fragments of V (key-major in shared
    // memory) come from ldmatrix.trans, two 8-wide d tiles at a time
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &sV[(kk * 16 + (lane & 15)) * LDQ + j * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(acc[2 * j], pa[kk], bf[0], bf[1]);
        mma_bf16_16816(acc[2 * j + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }

  const float l0 = fmaxf(l_run[0], 1e-30f), l1 = fmaxf(l_run[1], 1e-30f);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const int r0 = q0 + row0, r1 = r0 + 8;
  if (p.lse != nullptr && t == 0) {  // m and l are whole-row values in every lane of the quad
    float* lb = p.lse + b * p.lse_sb + h * p.lse_sh;
    if (r0 < p.sq) lb[r0] = m_run[0] + logf(l0);
    if (r1 < p.sq) lb[r1] = m_run[1] + logf(l1);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (r0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + d) = pack_bf16x2(acc[dt][0] / l0, acc[dt][1] / l0);
    if (r1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + d) = pack_bf16x2(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

// Launch on the caller's stream; returns the launch's error code. Segment
// ids (p.seg) take the SEG instantiations; the rope tile (E) has none.
template <int D, bool ROPE = false, int BM = 64>
inline int launch_flash_fwd(const FlashParams& p, int batch, int heads, bool causal,
                            cudaStream_t stream) {
  const dim3 grid((p.sq + BM - 1) / BM, heads, batch);
  if constexpr (ROPE) {
    if (p.seg != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (causal)
      flash_fwd_kernel<D, true, ROPE, BM, false><<<grid, BM * 2, 0, stream>>>(p);
    else
      flash_fwd_kernel<D, false, ROPE, BM, false><<<grid, BM * 2, 0, stream>>>(p);
  } else if (p.seg != nullptr) {
    static_assert(BM == kSegTile, "seg_tiles rows must match the query tile");
    if (causal)
      flash_fwd_kernel<D, true, ROPE, BM, true><<<grid, BM * 2, 0, stream>>>(p);
    else
      flash_fwd_kernel<D, false, ROPE, BM, true><<<grid, BM * 2, 0, stream>>>(p);
  } else {
    if (causal)
      flash_fwd_kernel<D, true, ROPE, BM, false><<<grid, BM * 2, 0, stream>>>(p);
    else
      flash_fwd_kernel<D, false, ROPE, BM, false><<<grid, BM * 2, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gar
