// Kernel C: one query token of GQA attention over layer `layer` of the
// stacked (L, B, K, S, D) bf16 cache, with the new K/V row written at column
// write_pos in place.
//
// Replaces grasp_any_region_tpu/ops/decode_attention.py:decode_attention_fused
// (_fused_kernel, unpaired layout). One block per (kv head, batch row). The
// step reads every valid cache column once and does ~2 flops per byte, so it
// is bound by memory, not arithmetic: the block streams 128-byte K rows one
// per lane (16 warps in flight) and keeps the G = H / K query heads in shared
// memory, so each K and V row is read once for all G heads. The valid
// columns are [0, min(prompt_len, prompt_pad)) and [prompt_pad, write_pos);
// the columns between are never loaded. Each warp keeps its own fp32 online
// softmax (p rounded to bf16 before PV, as on the TPU); the warps merge at
// the end, where the current token is folded in from k_new / v_new, not
// from the cache. So no block reads the column it writes, and the 8-row
// aligned write window of the TPU kernel (a tiling artifact) is one row.
// prompt_lens and write_pos are device tensors read here: the decode loop
// never waits for the host.
//
// Kernel C8, the second instantiation (T = int8_t), replaces the int8-KV
// branch of the same JAX function (_fused_kernel_paired with kv_q8) on the
// unpaired layout: K/V rows are 64 int8 bytes, dequantized on load as the
// TPU kernel does, bf16(q * scale), with one fp32 scale per (layer, batch
// row, kv-head pair) loaded once per block. The new K/V arrive in bf16 and
// are quantized here, clip(rint(x / scale), -127, 127) (rint rounds half to
// even, as jnp.round), written at write_pos, and folded in as their
// dequantized fp32 values, so this step sees what later steps read back.
// Half of C's bytes, the same grid: at B = 1 both are held by having one
// block per (kv head, batch row), not by the bytes (split-KV is later work).
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

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_attention_fused_kernel(const bf16* __restrict__ q, T* k_all, T* v_all,
                              const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
                              bf16* __restrict__ out, const int* __restrict__ prompt_lens,
                              const int* __restrict__ write_pos,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale, int layer, int batch,
                              int kv_heads, int seq, int prompt_pad, float scale) {
  constexpr bool Q8 = sizeof(T) == 1;
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int NW = kDecodeWarps;
  constexpr int DPL = D / 32;   // output dims per lane
  constexpr int VEC = 16 / sizeof(T);  // cache elements per 16-byte load
  __shared__ __align__(16) float sq[G][D];
  __shared__ float skn[D], svn[D];  // the current token's K and V as the attention uses them
  __shared__ float sm[NW][G];
  __shared__ float sl[NW][G];
  __shared__ float sacc[NW][G][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int plen = prompt_lens[b];
  const int wpos = write_pos[0];
  const size_t slab = ((static_cast<size_t>(layer) * batch + b) * kv_heads + kh) *
                      static_cast<size_t>(seq) * D;
  T* kc = k_all + slab;
  T* vc = v_all + slab;
  const size_t head0 = static_cast<size_t>(b) * kv_heads * G + static_cast<size_t>(kh) * G;
  const bf16* qp = q + head0 * D;
  const bf16* kn = k_new + (static_cast<size_t>(b) * kv_heads + kh) * D;
  const bf16* vn = v_new + (static_cast<size_t>(b) * kv_heads + kh) * D;
  float ksc = 1.f, vsc = 1.f;
  if (Q8) {  // pair kh / 2 of (layer, b)
    const size_t si = (static_cast<size_t>(layer) * batch + b) * (kv_heads / 2) + kh / 2;
    ksc = k_scale[si];
    vsc = v_scale[si];
  }

  for (int i = tid; i < G * D; i += NW * 32) sq[i / D][i % D] = __bfloat162float(qp[i]);
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
    skn[tid] = kf;
    svn[tid] = vf;
  }
  __syncthreads();

  const int hi = min(wpos, seq);
  const int n1 = max(min(min(plen, prompt_pad), hi), 0);  // prompt columns
  const int n2 = max(hi - prompt_pad, 0);                // generated columns
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
    const int col = valid ? (i < n1 ? i : prompt_pad + (i - n1)) : 0;
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
            const float4 qa = *reinterpret_cast<const float4*>(&sq[gg][c * VEC + e]);
            const float4 qb = *reinterpret_cast<const float4*>(&sq[gg][c * VEC + e + 4]);
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
      sm[warp][gg] = m_run[gg];
      sl[warp][gg] = l_run[gg];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) sacc[warp][gg][lane * DPL + e] = acc[gg][e];
  }
  __syncthreads();

  // merge the warps and fold in the current token
  for (int idx = tid; idx < G * D; idx += NW * 32) {
    const int gg = idx / D, d = idx % D;
    float s_cur = 0.f;
    for (int e = 0; e < D; ++e) s_cur += sq[gg][e] * skn[e];
    s_cur *= scale;
    float m_all = s_cur;
#pragma unroll
    for (int w = 0; w < NW; ++w) m_all = fmaxf(m_all, sm[w][gg]);
    const float p_cur = expf(s_cur - m_all);
    float l_all = p_cur;
    float a_all = p_cur * svn[d];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm[w][gg] - m_all);
      l_all += sl[w][gg] * f;
      a_all += sacc[w][gg][d] * f;
    }
    out[(head0 + gg) * D + d] = __float2bfloat16(a_all / fmaxf(l_all, 1e-30f));
  }
}

struct DecodeArgs {
  const void* q;
  void* k_all;
  void* v_all;
  const void* k_new;
  const void* v_new;
  void* out;
  const void* prompt_lens;
  const void* write_pos;
  const void* k_scale;  // C8 only
  const void* v_scale;
  int layer, batch, kv_heads, seq, prompt_pad;
  float scale;
};

template <typename T, int D, int G>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.kv_heads, a.batch);
  decode_attention_fused_kernel<T, D, G><<<grid, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<T*>(a.k_all), static_cast<T*>(a.v_all),
      static_cast<const bf16*>(a.k_new), static_cast<const bf16*>(a.v_new),
      static_cast<bf16*>(a.out), static_cast<const int*>(a.prompt_lens),
      static_cast<const int*>(a.write_pos), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), a.layer, a.batch, a.kv_heads, a.seq, a.prompt_pad,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_decode(const DecodeArgs& a, int heads, int head_dim, cudaStream_t stream) {
  if (head_dim != 64 || a.kv_heads <= 0 || heads % a.kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (heads / a.kv_heads) {
    case 1: return launch_decode<T, 64, 1>(a, stream);
    case 2: return launch_decode<T, 64, 2>(a, stream);
    case 4: return launch_decode<T, 64, 4>(a, stream);
    case 8: return launch_decode<T, 64, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gar

extern "C" int gar_decode_attention_fused(
    const void* q, void* k_all, void* v_all, const void* k_new, const void* v_new,
    void* out, const void* prompt_lens, const void* write_pos,
    int layer, int batch, int heads, int kv_heads, int seq, int head_dim,
    int prompt_pad, float scale, void* stream) {
  const gar::DecodeArgs a{q, k_all, v_all, k_new, v_new, out, prompt_lens, write_pos,
                          nullptr, nullptr, layer, batch, kv_heads, seq, prompt_pad, scale};
  return gar::dispatch_decode<gar::bf16>(a, heads, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int gar_decode_attention_fused_q8(
    const void* q, void* k_all, void* v_all, const void* k_new, const void* v_new,
    void* out, const void* prompt_lens, const void* write_pos, const void* k_scale,
    const void* v_scale, int layer, int batch, int heads, int kv_heads, int seq, int head_dim,
    int prompt_pad, float scale, void* stream) {
  if (kv_heads % 2) return static_cast<int>(cudaErrorInvalidValue);
  const gar::DecodeArgs a{q, k_all, v_all, k_new, v_new, out, prompt_lens, write_pos,
                          k_scale, v_scale, layer, batch, kv_heads, seq, prompt_pad, scale};
  return gar::dispatch_decode<int8_t>(a, heads, head_dim, static_cast<cudaStream_t>(stream));
}
