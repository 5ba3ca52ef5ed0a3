// Kernel C: one query token of GQA attention over layer `layer` of the
// stacked (L, B, K, S, D) bf16 cache, with the new K/V row written at column
// write_pos in place.
//
// Replaces grasp_any_region_tpu/ops/decode_attention.py:decode_attention_fused
// (_fused_kernel, unpaired layout). Its body is decode_split.cuh's
// decode_split_kernel: one thread-block cluster per (kv head, batch row),
// its CTAs splitting the valid columns and merging over distributed shared
// memory in one launch. The step reads every valid cache column once and
// does ~2 flops per byte, so it is bound by memory, not arithmetic: each K
// and V row is read once for all G = H / K query heads, the masked gap
// [prompt_len, prompt_pad) is never loaded, and no CTA reads the column
// that is written (the TPU kernel's 8-row aligned write window, a tiling
// artifact, is one row here). prompt_lens and write_pos are device tensors
// read there: the decode loop never waits for the host.
//
// Kernel C8 (decode_tile.cuh's decode_attend with T = int8_t, one block
// per (kv head, batch row)) replaces the int8-KV branch of the same JAX
// function (_fused_kernel_paired with kv_q8) on the unpaired layout: 64-byte
// int8 K/V rows with one fp32 scale per (layer, batch row, kv-head pair)
// loaded once per block. Half of C's bytes on C's first grid: at B = 1 it
// is held by having one block per (kv head, batch row), not by the bytes
// (its move onto the split body is later work).
//
// Kernel 16 replaces grasp_any_region_tpu/ops/decode_attention.py:
// decode_attention / decode_attention_stacked (_decode_kernel via
// _decode_call): C's split-KV body read only (decode_split_kernel<...,
// Append = false>), the current token already in the cache at write_pos,
// over the layer that a device int32 scalar picks out of the stacked bf16
// cache, so a caller never waits for the host. Bound by the valid columns'
// bytes like C, on C's grid of `splits` CTAs a (kv head, row). The TPU
// kernel walks whole block_s blocks up to the one holding write_pos; a
// prompt column past that block (prompt_len > write_pos + 1, outside the
// cache's layout) is left out here as there. A layer outside [0, L) writes
// NaN rows instead of reading outside the cache.
#include "decode_split.cuh"
#include "decode_tile.cuh"

namespace gar {

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_attention_fused_kernel(const bf16* __restrict__ q, T* k_all, T* v_all,
                              const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
                              bf16* __restrict__ out, const int* __restrict__ prompt_lens,
                              const int* __restrict__ write_pos,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale, int layer, int batch,
                              int kv_heads, int seq, int prompt_pad, float scale) {
  __shared__ DecodeShared<G, D> sh;
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t slab = ((static_cast<size_t>(layer) * batch + b) * kv_heads + kh) *
                      static_cast<size_t>(seq) * D;
  const size_t head0 = static_cast<size_t>(b) * kv_heads * G + static_cast<size_t>(kh) * G;
  const size_t row = static_cast<size_t>(b) * kv_heads + kh;
  float ksc = 1.f, vsc = 1.f;
  if (sizeof(T) == 1) {  // pair kh / 2 of (layer, b)
    const size_t si = (static_cast<size_t>(layer) * batch + b) * (kv_heads / 2) + kh / 2;
    ksc = k_scale[si];
    vsc = v_scale[si];
  }
  decode_attend<T, D, G>(sh, q + head0 * D, k_all + slab, v_all + slab, k_new + row * D,
                         v_new + row * D, prompt_lens[b], write_pos[0], seq, prompt_pad, ksc,
                         vsc, scale, [&](int gg, int d, float v) {
                           out[(head0 + gg) * D + d] = __float2bfloat16(v);
                         });
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

// C or 16 by the query heads a kv head serves.
template <bool Append>
int dispatch_split(const SplitArgs& a, int heads, int splits, cudaStream_t stream) {
  switch (heads / a.kv_heads) {
    case 1: return launch_split<bf16, 1, Append>(a, splits, stream);
    case 2: return launch_split<bf16, 2, Append>(a, splits, stream);
    case 4: return launch_split<bf16, 4, Append>(a, splits, stream);
    case 8: return launch_split<bf16, 8, Append>(a, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gar

// Kernel C over a cluster of `splits` CTAs (1-16; above 8, Hopper's
// non-portable cluster sizes).
extern "C" int gar_decode_attention_fused(
    const void* q, void* k_all, void* v_all, const void* k_new, const void* v_new,
    void* out, const void* prompt_lens, const void* write_pos,
    int layer, int batch, int heads, int kv_heads, int seq, int head_dim,
    int prompt_pad, int splits, float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || heads % kv_heads != 0 || splits < 1 ||
      splits > gar::kSplitMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const gar::SplitArgs a{static_cast<const gar::bf16*>(q), k_all, v_all,
                         static_cast<const gar::bf16*>(k_new),
                         static_cast<const gar::bf16*>(v_new), static_cast<gar::bf16*>(out),
                         static_cast<const int*>(prompt_lens), static_cast<const int*>(write_pos),
                         nullptr, layer, 0, batch, kv_heads, seq, prompt_pad, 0, scale};
  return gar::dispatch_split<true>(a, heads, splits, static_cast<cudaStream_t>(stream));
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

// Kernel 16 over a cluster of `splits` CTAs, as C; the layer is read on the card.
extern "C" int gar_decode_attention(const void* q, const void* k_all, const void* v_all,
                                    void* out, const void* prompt_lens, const void* write_pos,
                                    const void* layer, int n_layers, int batch, int heads,
                                    int kv_heads, int seq, int head_dim, int prompt_pad,
                                    int block_s, int splits, float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || heads % kv_heads != 0 || block_s <= 0 ||
      splits < 1 || splits > gar::kSplitMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // read only: the Append = false body never writes the cache
  const gar::SplitArgs a{static_cast<const gar::bf16*>(q), const_cast<void*>(k_all),
                         const_cast<void*>(v_all), nullptr, nullptr,
                         static_cast<gar::bf16*>(out), static_cast<const int*>(prompt_lens),
                         static_cast<const int*>(write_pos), static_cast<const int*>(layer), 0,
                         n_layers, batch, kv_heads, seq, prompt_pad, block_s, scale};
  return gar::dispatch_split<false>(a, heads, splits, static_cast<cudaStream_t>(stream));
}
