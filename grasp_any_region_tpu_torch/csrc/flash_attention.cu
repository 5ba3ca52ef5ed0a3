// Kernel B: prefill flash attention, q (B, Sq, H, D) and k/v (B, Sk, K, D)
// bf16, D = 64, causal (right-aligned) or full.
//
// Replaces grasp_any_region_tpu/ops/flash_attention.py:flash_attention
// (_flash_kernel), the FA-2 forward. On the TPU the grid runs in order and
// each program holds a whole K/V head in VMEM; here a block owns 64 query
// rows and streams 64-key tiles through shared memory (flash_tile.cuh).
// GQA is index mapping (kv head = h / (H / K)), with no repeated K/V; the
// causal mask skips K tiles wholly above the diagonal. Optional outputs and
// inputs for training: lse, the (B, H, Sq) fp32 row log-sum-exp the
// backward reads (JAX's return_lse), and seg, (B, S) int32 segment ids for
// packed self-attention (Sq == Sk; equal ids only), or nullptr, with
// seg_tiles, each 64-row tile's [min, max] id (B, ceil(S / 64), 2).
#include "flash_tile.cuh"

extern "C" int gar_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* seg,
    const void* seg_tiles, int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  if (head_dim != 64 || kv_heads <= 0 || heads % kv_heads != 0 ||
      (seg && (sq != sk || !seg_tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  gar::FlashParams p;
  p.q = static_cast<const gar::bf16*>(q);
  p.k = static_cast<const gar::bf16*>(k);
  p.v = static_cast<const gar::bf16*>(v);
  p.o = static_cast<gar::bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lse_sb = static_cast<long long>(heads) * sq;
  p.lse_sh = sq;
  p.seg = static_cast<const int*>(seg);
  p.seg_sb = sk;
  p.seg_tiles = static_cast<const int*>(seg_tiles);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq;
  p.sk = sk;
  p.group = heads / kv_heads;
  p.q_offset = sk - sq;
  p.scale = scale;
  return gar::launch_flash_fwd<64>(p, batch, heads, causal != 0,
                                   static_cast<cudaStream_t>(stream));
}
