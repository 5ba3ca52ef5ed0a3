// One bf16 tensor-core GEMM tile, shared by the fused ViT-block kernels D, F
// and G (vit_block.cu).
//
// The A operand (a block's rows, K wide) is resident in shared memory: the
// kernels stage it once, and D and G rewrite it in place as LayerNorm(x) in
// bf16 (their prologue). B, a (K, N) row-major weight, streams through a
// ring of STAGES shared-memory slabs of BK rows with cp.async, so the loads
// of later slabs overlap the products on the current one. Each warp owns a
// WM x WN tile of the block's output and keeps it in registers as the fp32
// accumulator of mma.sync m16n8k16 (bf16 in, fp32 sum); ldmatrix loads the
// A fragments, and its .trans form the B fragments straight from the
// row-major slab. The kernels apply their own epilogues (bias, GELU,
// LayerScale, residual) to that accumulator.
//
// Shared-memory rows are padded by 8 bf16 (16 bytes): with a row pitch of
// 16 mod 128 bytes the 8 row addresses of each ldmatrix fall in distinct
// bank groups.
#pragma once

#include "common.cuh"

namespace gar {

constexpr int kGemmPad = 8;

// 16-byte async copy global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + rows) of a (n_rows, width) row-major bf16 matrix into
// dst (row pitch ld) with cp.async; rows past n_rows are zero-filled. The
// caller commits and waits.
template <int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src,
                                                int width, int r0, int rows, int n_rows,
                                                int tid) {
  const int cpr = width / 8;
  for (int c = tid; c < rows * cpr; c += NT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    const bool ok = r0 + r < n_rows;
    const bf16* s = src + static_cast<long long>(ok ? r0 + r : 0) * width + cc;
    cp_async16(dst + r * ld + cc, s, ok ? 16 : 0);
  }
}

// In place: each of `rows` rows of sx (pitch ld, width d) becomes
// LayerNorm(row) = (x - mean) * rsqrt(var + eps) * w + b, rounded to bf16.
// fp32 statistics, two-pass variance mean((x - mean)^2), as the JAX
// kernels' _layer_norm_f32. One warp per row.
template <int NT>
__device__ __forceinline__ void layer_norm_rows(bf16* sx, int ld, int d, int rows,
                                                const float* w, const float* b, float eps,
                                                int warp, int lane) {
  const float inv_d = 1.0f / static_cast<float>(d);
  for (int r = warp; r < rows; r += NT / 32) {
    bf16* row = sx + r * ld;
    float s = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      s += v.x + v.y;
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      *reinterpret_cast<uint32_t*>(row + c) =
          pack_bf16x2((v.x - mean) * rstd * w[c] + b[c], (v.y - mean) * rstd * w[c + 1] + b[c + 1]);
    }
  }
}

// acc += sA[a_row0 : a_row0 + WM, 0:K] @ B[0:K, n0 + wn : n0 + wn + WN] for
// this warp, over a block of NT threads whose slabs span columns
// [n0, n0 + BN) of B (row pitch ldb). sA has row pitch lda. ring holds
// STAGES slabs of BK x (BN + kGemmPad). K must be a multiple of BK, and all
// of B's rows and columns must lie in bounds. Every thread of the block
// calls it; it returns after a barrier, so the caller may reuse the ring
// and rewrite sA at once.
template <int BK, int BN, int STAGES, int WM, int WN, int NT>
__device__ __forceinline__ void gemm_resident_a(float (&acc)[WM / 16][WN / 8][4],
                                                const bf16* sA, int lda, int a_row0,
                                                const bf16* B, long long ldb, int K, int n0,
                                                int wn, bf16* ring, int tid, int lane) {
  static_assert(BK % 16 == 0 && WM % 16 == 0 && WN % 16 == 0 && BN % 8 == 0, "tile shape");
  constexpr int LDB = BN + kGemmPad;
  constexpr int CPR = BN / 8;
  const int nk = K / BK;

  auto load_slab = [&](int kt) {
    bf16* dst = ring + (kt % STAGES) * (BK * LDB);
    const bf16* src = B + static_cast<long long>(kt) * BK * ldb + n0;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      cp_async16(dst + r * LDB + cc, src + r * ldb + cc);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slab(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();              // ... every thread's part; slab kt-1 is free
    if (kt + STAGES - 1 < nk) load_slab(kt + STAGES - 1);
    cp_async_commit();

    const bf16* sB = ring + (kt % STAGES) * (BK * LDB);
    const int k0 = kt * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[WM / 16][4];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        ldmatrix_x4(af[i], sA + (a_row0 + i * 16 + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        uint32_t bf[4];  // b0, b1 of n-tile 2j, then of n-tile 2j + 1
        ldmatrix_x4_trans(bf, sB + (kk + (lane & 15)) * LDB + wn + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) {
          mma_bf16_16816(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16_16816(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int WM, int WN>
__device__ __forceinline__ void zero_acc(float (&acc)[WM / 16][WN / 8][4]) {
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

}  // namespace gar
