// The RMSNorm prologue of the decode kernels that normalise x themselves:
// 21 / 23 (decode_mlp_sm90.cu) and 19 / 20 (layer_matmul_sm90.cu). Each CTA
// takes every x row's rstd (x is at most 32 rows, so each CTA reads it
// whole) and then writes xn = x * rstd * w over its own K range into shared
// memory once, in its kernel's layout.
#pragma once

#include "common.cuh"

namespace gar {

// rstd[r] = rsqrt(mean(x[r]^2) + eps) for the rows r = first, first + step,
// ... < rows of x (rows, d), d a multiple of 8, from fp32 squares: a warp a
// row, its loads all in flight (a CTA's warp w of n: first w, step n).
__device__ __forceinline__ void rms_rstd(float* rstd, const bf16* x, int rows, int d, float eps,
                                         int first, int step, int lane) {
  for (int r = first; r < rows; r += step) {
    const bf16* row = x + static_cast<size_t>(r) * d;
    float s = 0.f;
#pragma unroll 8
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s += f.x * f.x + f.y * f.y;
      }
    }
    s = warp_sum(s);
    if (lane == 0) rstd[r] = rsqrtf(s / static_cast<float>(d) + eps);
  }
}

// xn of a pair of x columns: x * rstd * w in fp32, JAX's order.
__device__ __forceinline__ float2 rms_value(__nv_bfloat162 x, __nv_bfloat162 w, float rstd) {
  const float2 xv = __bfloat1622float2(x), wv = __bfloat1622float2(w);
  return make_float2(xv.x * rstd * wv.x, xv.y * rstd * wv.y);
}

// xn at columns k, k + 1 of an x row.
__device__ __forceinline__ float2 rms_pair(const bf16* row, const bf16* w, float rstd, int k) {
  return rms_value(*reinterpret_cast<const __nv_bfloat162*>(row + k),
                   *reinterpret_cast<const __nv_bfloat162*>(w + k), rstd);
}

}  // namespace gar
