// Kernel C: one query token of GQA attention over layer `layer` of the
// stacked (L, B, K, S, D) bf16 cache, D 64 or 128, with the new K/V row
// written at column write_pos in place.
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
// Kernel C8 replaces the int8-KV branch of the same JAX function
// (_fused_kernel_paired with kv_q8) on the unpaired layout: 64-byte int8
// K/V rows with one fp32 scale per (layer, batch row, kv-head pair). Its
// body is C's (decode_split_kernel<int8_t, G, true>): the int8 stages
// widened per warp to bf16(int8 * scale), the new column quantized, the
// current token folded in dequantized. Half of C's bytes on C's grid.
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

namespace gar {

// C, C8 or 16 by the query heads a kv head serves.
template <typename T, bool Append, int D = 64>
int dispatch_split(const SplitArgs& a, int heads, int splits, cudaStream_t stream) {
  switch (heads / a.kv_heads) {
    case 1: return launch_split<T, 1, Append, D>(a, splits, stream);
    case 2: return launch_split<T, 2, Append, D>(a, splits, stream);
    case 4: return launch_split<T, 4, Append, D>(a, splits, stream);
    case 8: return launch_split<T, 8, Append, D>(a, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gar

// Kernel C over a cluster of `splits` CTAs (1-16; above 8, Hopper's
// non-portable cluster sizes), head dim 64 or 128.
extern "C" int gar_decode_attention_fused(
    const void* q, void* k_all, void* v_all, const void* k_new, const void* v_new,
    void* out, const void* prompt_lens, const void* write_pos,
    int layer, int batch, int heads, int kv_heads, int seq, int head_dim,
    int prompt_pad, int splits, float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || kv_heads <= 0 || heads % kv_heads != 0 ||
      splits < 1 || splits > gar::kSplitMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const gar::SplitArgs a{static_cast<const gar::bf16*>(q), k_all, v_all,
                         static_cast<const gar::bf16*>(k_new),
                         static_cast<const gar::bf16*>(v_new), static_cast<gar::bf16*>(out),
                         static_cast<const int*>(prompt_lens), static_cast<const int*>(write_pos),
                         nullptr, layer, 0, batch, kv_heads, seq, prompt_pad, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? gar::dispatch_split<gar::bf16, true, 64>(a, heads, splits, st)
                        : gar::dispatch_split<gar::bf16, true, 128>(a, heads, splits, st);
}

// Kernel C8 over a cluster of `splits` CTAs, as C; the scales (L, B, K / 2)
// fp32, K even.
extern "C" int gar_decode_attention_fused_q8(
    const void* q, void* k_all, void* v_all, const void* k_new, const void* v_new,
    void* out, const void* prompt_lens, const void* write_pos, const void* k_scale,
    const void* v_scale, int layer, int batch, int heads, int kv_heads, int seq, int head_dim,
    int prompt_pad, int splits, float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || kv_heads % 2 || heads % kv_heads != 0 || splits < 1 ||
      splits > gar::kSplitMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const gar::SplitArgs a{static_cast<const gar::bf16*>(q), k_all, v_all,
                         static_cast<const gar::bf16*>(k_new),
                         static_cast<const gar::bf16*>(v_new), static_cast<gar::bf16*>(out),
                         static_cast<const int*>(prompt_lens), static_cast<const int*>(write_pos),
                         nullptr, layer, 0, batch, kv_heads, seq, prompt_pad, 0, scale,
                         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return gar::dispatch_split<int8_t, true>(a, heads, splits, static_cast<cudaStream_t>(stream));
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
  return gar::dispatch_split<gar::bf16, false>(a, heads, splits, static_cast<cudaStream_t>(stream));
}
