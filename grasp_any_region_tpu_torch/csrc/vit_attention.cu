// Kernel A: non-causal ViT attention over (T, S, H, D) bf16, D = 64.
//
// Replaces grasp_any_region_tpu/ops/vit_attention.py:vit_attention
// (_vit_attn_kernel), which holds the whole (S, S) logits block of one
// (tile, head) in VMEM. At S = 1025 that block is 4.2 MB of fp32, far over
// the 227 KB of shared memory a Hopper block can use, so this computes the
// same function with an online softmax over 64-key tiles (flash_tile.cuh):
// fp32 scores, max and sum, p rounded to bf16 before the PV product.
// It is the non-causal, one-head-per-kv-head case of that tile kernel.
// lse (optional, nullptr for none): the (T, H, S) fp32 row log-sum-exp
// that the backward (kernel 5, flash_backward.cu) reads.
#include "flash_tile.cuh"

extern "C" int gar_vit_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int tiles, int seq, int heads, int head_dim,
    long long q_st, long long q_ss, long long q_sh,
    long long k_st, long long k_ss, long long k_sh,
    long long v_st, long long v_ss, long long v_sh,
    long long o_st, long long o_ss, long long o_sh,
    float scale, void* stream) {
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  gar::FlashParams p;
  p.q = static_cast<const gar::bf16*>(q);
  p.k = static_cast<const gar::bf16*>(k);
  p.v = static_cast<const gar::bf16*>(v);
  p.o = static_cast<gar::bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lse_sb = static_cast<long long>(heads) * seq;
  p.lse_sh = seq;
  p.q_sb = q_st; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_st; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_st; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_st; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = seq;
  p.sk = seq;
  p.group = 1;
  p.q_offset = 0;
  p.scale = scale;
  return gar::launch_flash_fwd<64>(p, tiles, heads, /*causal=*/false,
                                   static_cast<cudaStream_t>(stream));
}

// Kernel E: the same attention with q, k and v read straight out of the
// fused (T, S, 3D) qkv buffer and 2D rope applied to q and k on load.
//
// Replaces grasp_any_region_tpu/ops/vit_attention.py:vit_attention_fused_qkv
// (_fused_qkv_kernel), which takes 128-lane head pairs of the buffer and
// rolls lanes for rotate_half. Here q of head h is the view at column h * 64
// (k at D + h * 64, v at 2D + h * 64) with sequence stride 3D, so nothing is
// copied; cos/sin are fp32 (H, S, 64) tables whose CLS rows are the
// identity. Rope runs in fp32 while each Q/K row tile is staged into shared
// memory, then rounds to bf16 (flash_tile.cuh: stage_rows). K tiles are
// re-staged for every query tile, so blocks of 128 query rows (not A's 64)
// halve that work: rope on K runs S/128 times per head. The output is
// token-major (T, S, D).
extern "C" int gar_vit_attention_fused_qkv(
    const void* qkv, const void* cos, const void* sin, void* o,
    int tiles, int seq, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * head_dim;
  const gar::bf16* base = static_cast<const gar::bf16*>(qkv);
  gar::FlashParams p;
  p.q = base;
  p.k = base + dm;
  p.v = base + 2 * dm;
  p.o = static_cast<gar::bf16*>(o);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.rope_sh = static_cast<long long>(seq) * head_dim;
  p.q_sb = p.k_sb = p.v_sb = seq * 3 * dm;
  p.q_ss = p.k_ss = p.v_ss = 3 * dm;
  p.q_sh = p.k_sh = p.v_sh = head_dim;
  p.o_sb = seq * dm;
  p.o_ss = dm;
  p.o_sh = head_dim;
  p.sq = seq;
  p.sk = seq;
  p.group = 1;
  p.q_offset = 0;
  p.scale = scale;
  return gar::launch_flash_fwd<64, /*ROPE=*/true, /*BM=*/128>(p, tiles, heads, /*causal=*/false,
                                                              static_cast<cudaStream_t>(stream));
}
