// Kernel 5: the ViT attention backward (FA-2 recurrences), bf16 operands,
// fp32 sums, mma.sync m16n8k16 on the flash tile's fragment layouts
// (flash_tile.cuh, common.cuh). Replaces
// grasp_any_region_tpu/ops/vit_attention.py:_vit_bwd_kernel, whose program
// holds a whole head's K, V and (S, D) fp32 dk/dv sums in VMEM, about four
// times the 227 KB of an H100 SM at S = 1025.
//
// Given q, k, v, dO, the forward's per-row log-sum-exp (lse) and
// delta = rowsum(dO * O) (computed by the wrapper, as the JAX package
// computes it outside Pallas), each 64 x 64 block of probabilities is
// recomputed as p = exp(scale * q k^T - lse) and
//   dv += p^T dO,   dp = dO v^T,   ds = p * (dp - delta) (rounded to bf16),
//   dq += ds k,     dk += ds^T q   (dq and dk scaled once at the end).
// p is rounded to bf16 before its product, as the TPU kernels round it.
// One block per (64 keys, tile-head) walks every query tile (non-causal,
// one head per kv head): each 64 x 64 p block is computed once and feeds
// dv, dp, dk and dq; the block's ds goes through shared memory so each warp
// multiplies 16 query rows by the block's K, and adds that into an fp32 dq
// workspace with red.global.add.f32 (the wrapper casts it to bf16 once at
// the end).
//
// Bound by its five tensor-core products, 10 S^2 D flops per tile-head.
#include "flash_tile.cuh"

namespace gar {

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (tiles, head, seq) fp32
  const float* delta;  // (tiles, head, seq) fp32
  bf16* dk;            // (tiles, seq, head, D), contiguous
  bf16* dv;
  float* dq_acc;       // fp32 (tiles, seq, head, D) workspace, zeroed
  long long q_sb, q_ss, q_sh;  // element strides: tile, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int seq, heads;
  float scale;
};

constexpr int kBwdBlock = 64;  // query rows and keys per tile
constexpr int kBwdThreads = 128;

// dk, dv for one (64-key tile, head, tile); the dq share is added
// atomically into p.dq_acc.
template <int D>
__global__ void __launch_bounds__(kBwdThreads) vit_bwd_kernel(const BwdParams p) {
  constexpr int BM = kBwdBlock, BN = kBwdBlock, NT = kBwdThreads, LD = D + kSmemPad;
  __shared__ __align__(16) bf16 sK[BN * LD];
  __shared__ __align__(16) bf16 sV[BN * LD];
  __shared__ __align__(16) bf16 sQ[BM * LD];
  __shared__ __align__(16) bf16 sdO[BM * LD];
  __shared__ __align__(16) bf16 sdS[BM * LD];  // ds as [query][key]
  __shared__ float sLse[BM], sDelta[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  stage_rows<D, LD, NT>(sK, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, BN, p.seq, tid);
  stage_rows<D, LD, NT>(sV, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, BN, p.seq, tid);

  const int row0 = warp * 16 + g;  // this thread's keys in the tile: row0, row0 + 8
  const int key0 = k0 + row0, key1 = key0 + 8;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int n_qt = (p.seq + BM - 1) / BM;
  const long long dq_ss = static_cast<long long>(p.heads) * D;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.seq;

  // two query tiles a trip: rolled, this loop took 2.77 ms at the tower's
  // shape on an H100 (chip_smoke.py), 2.16 unrolled by two
#pragma unroll 2
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // every warp is done with the previous tile (and sdS)
    stage_rows<D, LD, NT>(sQ, qb, p.q_ss, q0, BM, p.seq, tid);
    stage_rows<D, LD, NT>(sdO, ob, p.o_ss, q0, BM, p.seq, tid);
    if (tid < BM) {
      const bool in = q0 + tid < p.seq;
      sLse[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
      sDelta[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
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
        const bool ok = key < p.seq && q0 + ql < p.seq;
        pv[i] = ok ? expf(s[nt][i] * p.scale - sLse[ql]) : 0.f;
        ds[i] = pv[i] * (dpt[nt][i] - sDelta[ql]);
        sdS[ql * LD + row0 + (i < 2 ? 0 : 8)] = __float2bfloat16(ds[i]);
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
    float* qa = p.dq_acc + static_cast<long long>(b) * p.seq * dq_ss + h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (r0 < p.seq) {
        atomicAdd(qa + r0 * dq_ss + d, acc[dt][0] * p.scale);
        atomicAdd(qa + r0 * dq_ss + d + 1, acc[dt][1] * p.scale);
      }
      if (r1 < p.seq) {
        atomicAdd(qa + r1 * dq_ss + d, acc[dt][2] * p.scale);
        atomicAdd(qa + r1 * dq_ss + d + 1, acc[dt][3] * p.scale);
      }
    }
  }

  const long long base = static_cast<long long>(b) * p.seq * dq_ss + h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (key0 < p.seq) {
      *reinterpret_cast<uint32_t*>(p.dk + base + key0 * dq_ss + d) =
          pack_bf16x2(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + base + key0 * dq_ss + d) =
          pack_bf16x2(dv[dt][0], dv[dt][1]);
    }
    if (key1 < p.seq) {
      *reinterpret_cast<uint32_t*>(p.dk + base + key1 * dq_ss + d) =
          pack_bf16x2(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + base + key1 * dq_ss + d) =
          pack_bf16x2(dv[dt][2], dv[dt][3]);
    }
  }
}

}  // namespace gar

// Kernel 5: (tiles, seq, heads, 64) q, k, v, dO; lse and delta (tiles,
// heads, seq); dq_acc a zeroed fp32 (tiles, seq, heads, 64) workspace.
extern "C" int gar_vit_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, float* dq_acc, void* dk, void* dv, int tiles, int seq, int heads,
    int head_dim, const long long* strides, float scale, void* stream) {
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  gar::BwdParams p;
  p.q = static_cast<const gar::bf16*>(q);
  p.k = static_cast<const gar::bf16*>(k);
  p.v = static_cast<const gar::bf16*>(v);
  p.dout = static_cast<const gar::bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<gar::bf16*>(dk);
  p.dv = static_cast<gar::bf16*>(dv);
  p.dq_acc = dq_acc;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.seq = seq;
  p.heads = heads;
  p.scale = scale;
  const dim3 grid((seq + gar::kBwdBlock - 1) / gar::kBwdBlock, heads, tiles);
  gar::vit_bwd_kernel<64><<<grid, gar::kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
