// Online-softmax attention over one 64-row query tile: the body of kernel
// A (non-causal ViT attention, vit_attention.cu). Kernels B and E are in
// flash_forward_sm90.cu.
//
// One block owns 64 query rows of one (batch, head), one warp per 16 rows.
// K/V stream through shared memory in 64-key tiles, both key-major as they
// lie in memory. Both products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 sum): S = Q K^T from register-resident Q
// fragments, then P V with the fp32 probabilities rounded to bf16, as the
// TPU kernels round p before their PV dot; V's B fragments come from
// ldmatrix.trans, so V is never transposed in shared memory. Max, sum and
// the output accumulator stay fp32 in registers.
//
// Tensors are read through element strides for (batch, seq, head); the
// head dim is contiguous. So the JAX (B, S, H, D) layout, and views such as
// the v slice of the ViT's fused qkv buffer, need no transpose copy. Keys
// past S are masked by bounds (nothing is padded).
//
// For the backward (kernel 5: 17's prep, 18's pass and 17's cast in
// flash_backward_sm90.cu), with `lse` set, each row's
// log-sum-exp of the scaled logits, m + log(l) from the online state, fp32
// (batch, head, seq).
#pragma once

#include "common.cuh"

namespace gar {

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse = nullptr;             // optional (batch, head, seq) fp32 log-sum-exp
  long long lse_sb = 0, lse_sh = 0;  // its batch and head strides (rows contiguous)
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int seq;
  float scale;
};

constexpr int kFlashBN = 64;       // keys per tile
constexpr int kSmemPad = 8;        // bf16 pad per smem row: conflict-free fragment loads

// Stage rows [r0, r0 + rows) of a (seq, D) operand into dst (row stride LD),
// zeros past `limit`.
template <int D, int LD, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ss, int r0,
                                           int rows, int limit, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < rows * CPR; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    uint4 val = zero;
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + cc);
    *reinterpret_cast<uint4*>(&dst[r * LD + cc]) = val;
  }
}

// 64 query rows per block, one warp per 16 of them.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BM = 64, BN = kFlashBN, NT = 128;
  constexpr int LDQ = D + kSmemPad;   // sQ, sK, sV: [row][d]
  __shared__ __align__(16) bf16 sQ[BM * LDQ];
  __shared__ __align__(16) bf16 sK[BN * LDQ];
  __shared__ __align__(16) bf16 sV[BN * LDQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;

  stage_rows<D, LDQ, NT>(sQ, qb, p.q_ss, q0, BM, p.seq, tid);
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

  const int n_tiles = (p.seq + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D, LDQ, NT>(sK, kb, p.k_ss, k0, BN, p.seq, tid);
    stage_rows<D, LDQ, NT>(sV, vb, p.v_ss, k0, BN, p.seq, tid);
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

    // scale, mask keys past S, online softmax (fp32)
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < p.seq ? s[nt][i] * p.scale : kNegInf;
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
    if (r0 < p.seq) lb[r0] = m_run[0] + logf(l0);
    if (r1 < p.seq) lb[r1] = m_run[1] + logf(l1);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (r0 < p.seq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + d) = pack_bf16x2(acc[dt][0] / l0, acc[dt][1] / l0);
    if (r1 < p.seq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + d) = pack_bf16x2(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

// Launch on the caller's stream; returns the launch's error code.
template <int D>
inline int launch_flash_fwd(const FlashParams& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.seq + 63) / 64, heads, batch);
  flash_fwd_kernel<D><<<grid, 128, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gar
