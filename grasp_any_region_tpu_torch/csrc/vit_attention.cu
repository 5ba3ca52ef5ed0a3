// Kernel A: non-causal ViT attention over (T, S, H, D) bf16, D = 64.
//
// Replaces grasp_any_region_tpu/ops/vit_attention.py:vit_attention
// (_vit_attn_kernel), which holds the whole (S, S) logits block of one
// (tile, head) in VMEM. At S = 1025 that block is 4.2 MB of fp32, far over
// the 227 KB of shared memory a Hopper block can use, so this computes the
// same function with an online softmax over 64-key tiles (flash_tile.cuh):
// fp32 scores, max and sum, p rounded to bf16 before the PV product.
// Kernel E, the same attention with rope on the fused qkv buffer, is in
// flash_forward_sm90.cu.
// lse (optional, nullptr for none): the (T, H, S) fp32 row log-sum-exp
// that the backward (kernel 5, on flash_backward_sm90.cu's pass) reads.
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
  p.seq = seq;
  p.scale = scale;
  return gar::launch_flash_fwd<64>(p, tiles, heads, static_cast<cudaStream_t>(stream));
}
