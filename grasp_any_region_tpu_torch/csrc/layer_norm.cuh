// The row body of kernel 24 (layer_norm.cu): LayerNorm over the trailing dim
// of a (rows, D) bf16 or fp32 array, with bf16 or fp32 weight and bias, the
// output in x's dtype. fp32 mean, the centered variance, rsqrt(var + eps),
// x w + b, one rounding. Kernels D and G (vit_block.cu) launch it as their
// LayerNorm pass.
//
// The work is ~8 operations per element, so it is bound by reading x once
// and writing the output once. One warp takes a row: each lane loads its
// share of the row in 16-byte vectors into registers, the warp sums it by
// shuffles for the mean, then sums the centered squares from the same
// registers for the variance (two passes over registers, one over HBM; not
// E[x^2] - mean^2), and writes the normalized row back in 16-byte vectors.
// Rows are independent, so any row count takes a grid of ceil(rows / 8)
// blocks of 8 warps, and no row past `rows` is read or written.
// D % 8 == 0 (whole vectors of either type) and D <= 8192: 32 vectors a
// lane for bf16; an fp32 row past 4096 needs 64, more than the registers
// hold, and spills to local memory.
#pragma once

#include "common.cuh"

namespace gar {

constexpr int kLnWarps = 8;

// The VEC elements of one 16-byte vector as fp32, and back.
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// N consecutive weight (or bias) elements from offset off, bf16 or fp32.
template <int N>
__device__ __forceinline__ void load_param(const void* p, bool f32, int off, float (&f)[N]) {
  if (f32) {
    const float4* v = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldg(v + i);
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
  } else {
    const __nv_bfloat162* v =
        reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + off);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __bfloat1622float2(v[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// NV: 16-byte vectors a lane, a power of two with NV * 32 * VEC >= D.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                  const void* __restrict__ b, T* __restrict__ out, int rows, int d, bool w_f32,
                  bool b_f32, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * d);
  const int nvec = d / VEC;

  uint4 raw[NV];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * 32 + lane;
    raw[j] = v < nvec ? xr[v] : make_uint4(0u, 0u, 0u, 0u);  // zeros add nothing
    float f[VEC];
    unpack(raw[j], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum += f[e];
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * 32 + lane < nvec) {
      float f[VEC];
      unpack(raw[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float c = f[e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * 32 + lane;
    if (v < nvec) {
      float f[VEC], wf[VEC], bf[VEC], o[VEC];
      unpack(raw[j], f);
      load_param(w, w_f32, v * VEC, wf);
      load_param(b, b_f32, v * VEC, bf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = (f[e] - mean) * rstd * wf[e] + bf[e];
      orow[v] = pack(o);
    }
  }
}

template <typename T, int NV>
int launch_layer_norm(const void* x, const void* w, const void* b, void* out, int rows, int d,
                      bool w_f32, bool b_f32, float eps, cudaStream_t stream) {
  const int grid = (rows + kLnWarps - 1) / kLnWarps;
  layer_norm_kernel<T, NV><<<grid, kLnWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), rows, d, w_f32, b_f32, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_layer_norm(const void* x, const void* w, const void* b, void* out, int rows, int d,
                        bool w_f32, bool b_f32, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = (d / VEC + 31) / 32;  // vectors a lane
#define GAR_LN_CASE(NV) \
  if (nv <= NV) return launch_layer_norm<T, NV>(x, w, b, out, rows, d, w_f32, b_f32, eps, stream);
  GAR_LN_CASE(1)
  GAR_LN_CASE(2)
  GAR_LN_CASE(4)
  GAR_LN_CASE(8)
  GAR_LN_CASE(16)
  GAR_LN_CASE(32)
  if constexpr (VEC == 4) {
    GAR_LN_CASE(64)
  }
#undef GAR_LN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gar
