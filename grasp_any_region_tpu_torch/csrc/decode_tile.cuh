// One (kv head, batch row) of decode attention with the KV append: the body
// of kernel C8 (decode_attention.cu) and of kernel 22's attention
// (decode_megakernel.cu), and the first form of kernels C and 16 (both now
// split the columns over a cluster, decode_split.cuh).
//
// The block (kDecodeWarps warps) writes the new K/V row at column write_pos
// of its cache slab, then streams 128-byte K rows one per lane and keeps the
// G query heads in shared memory, so each K and V row is read once for all
// G heads. The valid columns are [0, min(prompt_len, prompt_pad)) and
// [prompt_pad, write_pos); the columns between are never loaded. Each warp
// keeps its own fp32 online softmax (p rounded to bf16 before PV, as on the
// TPU); the warps merge at the end, where the current token is folded in
// from k_new / v_new, not from the cache, so no block reads the column it
// writes. The int8 cache (T = int8_t) is dequantized on load as bf16(q *
// scale); the new K/V are quantized with the same scale, clip(rint(x /
// scale), -127, 127), and folded in as their dequantized fp32 values.
#pragma once

#include "common.cuh"

namespace gar {

constexpr int kDecodeWarps = 16;

// One cache element to fp32 as the attention uses it: bf16 as stored, int8
// as bf16(q * scale).
__device__ __forceinline__ float cache_value(bf16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ float cache_value(int8_t x, float s) {
  return __bfloat162float(__float2bfloat16(static_cast<float>(x) * s));
}

// Two adjacent elements in one load (4 bytes of bf16, 2 of int8).
__device__ __forceinline__ void cache_pair(const bf16* p, float, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void cache_pair(const int8_t* p, float s, float& a, float& b) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  a = cache_value(static_cast<int8_t>(c.x), s);
  b = cache_value(static_cast<int8_t>(c.y), s);
}

template <int G, int D>
struct DecodeShared {
  __align__(16) float sq[G][D];
  float skn[D], svn[D];  // the current token's K and V as the attention uses them
  float sm[kDecodeWarps][G];
  float sl[kDecodeWarps][G];
  float sacc[kDecodeWarps][G][D];
};

// The attention of the G query heads at qp ((G, D) bf16) over the slabs kc,
// vc ((seq, D) at this layer, batch row and kv head), after writing kn / vn
// at column wpos. store(gg, d, value) receives each normalized fp32 output
// once. ksc / vsc: the int8 cache's scales (1 for bf16).
template <typename T, int D, int G, typename Store>
__device__ __forceinline__ void decode_attend(DecodeShared<G, D>& sh, const bf16* __restrict__ qp,
                                              T* kc, T* vc, const bf16* __restrict__ kn,
                                              const bf16* __restrict__ vn, int plen, int wpos,
                                              int seq, int prompt_pad, float ksc, float vsc,
                                              float scale, Store store) {
  constexpr bool Q8 = sizeof(T) == 1;
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int NW = kDecodeWarps;
  constexpr int DPL = D / 32;          // output dims per lane
  constexpr int VEC = 16 / sizeof(T);  // cache elements per 16-byte load
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * D; i += NW * 32) sh.sq[i / D][i % D] = __bfloat162float(qp[i]);
  if (tid < D) {
    float kf = __bfloat162float(kn[tid]), vf = __bfloat162float(vn[tid]);
    T kw, vw;
    if constexpr (Q8) {
      const float kq = fminf(fmaxf(rintf(kf / ksc), -127.f), 127.f);
      const float vq = fminf(fmaxf(rintf(vf / vsc), -127.f), 127.f);
      kw = static_cast<int8_t>(kq);
      vw = static_cast<int8_t>(vq);
      kf = kq * ksc;
      vf = vq * vsc;
    } else {
      kw = kn[tid];
      vw = vn[tid];
    }
    if (wpos >= 0 && wpos < seq) {
      kc[static_cast<size_t>(wpos) * D + tid] = kw;
      vc[static_cast<size_t>(wpos) * D + tid] = vw;
    }
    sh.skn[tid] = kf;
    sh.svn[tid] = vf;
  }
  __syncthreads();

  // columns [0, n1), then [lo2, lo2 + n2)
  const int hi = min(wpos, seq);
  const int n1 = max(min(min(plen, prompt_pad), hi), 0);  // prompt columns
  const int lo2 = prompt_pad;                              // generated columns
  const int n2 = max(hi - lo2, 0);
  const int total = n1 + n2;

  float m_run[G], l_run[G], acc[G][DPL];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    m_run[gg] = kNegInf;
    l_run[gg] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[gg][e] = 0.f;
  }

  for (int base = warp * 32; base < total; base += NW * 32) {
    const int i = base + lane;
    const bool valid = i < total;
    const int col = valid ? (i < n1 ? i : lo2 + (i - n1)) : 0;
    float sc[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) sc[gg] = 0.f;
    if (valid) {
      const uint4* krow = reinterpret_cast<const uint4*>(kc + static_cast<size_t>(col) * D);
#pragma unroll
      for (int c = 0; c < D / VEC; ++c) {
        const uint4 raw = krow[c];
        const T* kp = reinterpret_cast<const T*>(&raw);
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = cache_value(kp[e], ksc);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
#pragma unroll
          for (int e = 0; e < VEC; e += 8) {
            const float4 qa = *reinterpret_cast<const float4*>(&sh.sq[gg][c * VEC + e]);
            const float4 qb = *reinterpret_cast<const float4*>(&sh.sq[gg][c * VEC + e + 4]);
            sc[gg] += qa.x * kf[e] + qa.y * kf[e + 1] + qa.z * kf[e + 2] + qa.w * kf[e + 3] +
                      qb.x * kf[e + 4] + qb.y * kf[e + 5] + qb.z * kf[e + 6] + qb.w * kf[e + 7];
          }
        }
      }
    }
    float pb[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const float s = valid ? sc[gg] * scale : kNegInf;
      const float m_new = fmaxf(m_run[gg], warp_max(s));
      const float pr = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[gg] - m_new);
      l_run[gg] = l_run[gg] * alpha + warp_sum(pr);
      m_run[gg] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[gg][e] *= alpha;
      pb[gg] = __bfloat162float(__float2bfloat16(pr));
    }
    // all 32 keys of the chunk, so the loop unrolls and its V loads issue
    // together; an invalid lane has p = 0 and points at column 0
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int cj = __shfl_sync(0xffffffffu, col, jj);
      const T* vrow = vc + static_cast<size_t>(cj) * D + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int e = 0; e < DPL; e += 2) cache_pair(vrow + e, vsc, vf[e], vf[e + 1]);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const float pj = __shfl_sync(0xffffffffu, pb[gg], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[gg][e] += pj * vf[e];
      }
    }
  }

#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    if (lane == 0) {
      sh.sm[warp][gg] = m_run[gg];
      sh.sl[warp][gg] = l_run[gg];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) sh.sacc[warp][gg][lane * DPL + e] = acc[gg][e];
  }
  __syncthreads();

  // merge the warps and fold in the current token
  for (int idx = tid; idx < G * D; idx += NW * 32) {
    const int gg = idx / D, d = idx % D;
    float s_cur = 0.f;
    for (int e = 0; e < D; ++e) s_cur += sh.sq[gg][e] * sh.skn[e];
    s_cur *= scale;
    float m_all = s_cur;
#pragma unroll
    for (int w = 0; w < NW; ++w) m_all = fmaxf(m_all, sh.sm[w][gg]);
    const float p_cur = expf(s_cur - m_all);
    float l_all = p_cur, a_all = p_cur * sh.svn[d];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sh.sm[w][gg] - m_all);
      l_all += sh.sl[w][gg] * f;
      a_all += sh.sacc[w][gg][d] * f;
    }
    store(gg, d, a_all / fmaxf(l_all, 1e-30f));
  }
}

}  // namespace gar
