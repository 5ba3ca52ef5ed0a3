"""Llama-3-family decoder (`grasp_any_region_tpu/models/llama.py`).

  * Prefill: right-padded causal attention through `mha` (kernel B on the
    card), returning per-layer K/V for the cache.
  * Decode: two forms of `llama_decode_step`, as in JAX. The fused form
    (the default on a CUDA tensor) runs per layer kernel J (q, k, v), rope,
    kernel C (cache write + attention), kernel H (wo), kernel I (SwiGLU)
    and H again (w_down), the weights read in place from the stacked
    arrays (ops/layer_matmul.py). The XLA form (the default on the CPU)
    runs plain projections around kernel C.
  * KV cache: unpaired (L, B, K, S_max, D). Prompt columns [0, prompt_pad)
    are right-padded (rows masked past prompt_lens); generated tokens share
    one write column per step, `write_pos`, a device scalar. The cache and
    `write_pos` are updated in place, so no step copies the cache or waits
    for the host.
  * Logits: the tied (or untied) head with operands in the working dtype
    and fp32 sums and output, as the JAX package contracts them
    (preferred_element_type=float32); padded vocab rows masked to NEG_INF.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig
from ..core.weights import ParamGroup, add_param
from ..ops.attention import NEG_INF, mha
from ..ops.decode_attention import decode_attention_fused
from ..ops.layer_matmul import layer_matmul, layer_qkv, layer_swiglu
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, llama_inv_freq, rope_cos_sin


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, K, S_max, D) head-major
    v: torch.Tensor
    prompt_lens: torch.Tensor  # (B,) int32 true prompt lengths
    write_pos: torch.Tensor  # () int32 next column to write, on the cache's device


class LlamaParams(nn.Module):
    """Names and layouts of the JAX `params["llm"]` tree."""

    def __init__(self, cfg: TextConfig, vocab_rows: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        v = vocab_rows or cfg.vocab_size
        d, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        add_param(self, "embed", (v, d), device, dtype)
        self.blocks = ParamGroup({
            "attn_norm": (L, d),
            "wq": (L, d, h * dh), "wk": (L, d, k * dh), "wv": (L, d, k * dh),
            "wo": (L, h * dh, d),
            "mlp_norm": (L, d),
            "w_gate": (L, d, m), "w_up": (L, d, m), "w_down": (L, m, d),
        }, device, dtype)
        add_param(self, "final_norm", (d,), device, dtype)
        if not cfg.tie_word_embeddings:
            add_param(self, "lm_head", (d, v), device, dtype)


def _qkv(cfg: TextConfig, bp: dict, x: torch.Tensor, cos, sin):
    b, s, _ = x.shape
    h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ bp["wq"].to(x.dtype)).reshape(b, s, h, dh)
    kk = (x @ bp["wk"].to(x.dtype)).reshape(b, s, k, dh)
    vv = (x @ bp["wv"].to(x.dtype)).reshape(b, s, k, dh)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), vv


def _mlp(bp: dict, x: torch.Tensor) -> torch.Tensor:
    gate = x @ bp["w_gate"].to(x.dtype)
    up = x @ bp["w_up"].to(x.dtype)
    return (F.silu(gate) * up) @ bp["w_down"].to(x.dtype)


def llama_prefill(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) int
    *,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), 0 = padding
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward over right-padded rows. Returns (hidden
    (B, S, D), (k_all, v_all)), k_all / v_all (L, B, S, K, Dh) for cache
    seeding. Packed multi-document rows wait for the training slice."""
    b, s, _ = inputs_embeds.shape
    L, kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_cos_sin(positions, llama_inv_freq(cfg, inputs_embeds.device))
    eps = cfg.rms_norm_eps
    ks = inputs_embeds.new_empty((L, b, s, kh, dh))
    vs = inputs_embeds.new_empty((L, b, s, kh, dh))
    x = inputs_embeds
    for i in range(L):
        bp = params.blocks.layer(i)
        y = rms_norm(x, bp["attn_norm"], eps)
        q, k, v = _qkv(cfg, bp, y, cos, sin)
        a = mha(q, k, v, causal=True, segment_ids=segment_ids, right_padded=True)
        x = x + a.reshape(b, s, -1) @ bp["wo"].to(x.dtype)
        y = rms_norm(x, bp["mlp_norm"], eps)
        x = x + _mlp(bp, y)
        ks[i], vs[i] = k, v
    return x, (ks, vs)


def decode_kernel_choice(cfg: TextConfig, device) -> Union[bool, str]:
    """The decode form `use_kernel=None` picks: "fused" on a CUDA tensor,
    False (the XLA form) on the CPU, as the JAX package picks "fused" on
    the TPU and False elsewhere. JAX also falls back to XLA when one
    layer's q/k/v weights pass 13 MB: its qkv kernel holds them whole in
    the TPU's scoped VMEM. Kernels H-J stream column blocks and hold no
    whole weight, so the port has no such bound (GAR-8B takes the fused
    form too), and the rule reads the device alone; cfg stays for JAX's
    signature."""
    return "fused" if torch.device(device).type == "cuda" else False


def llama_decode_step(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    prompt_pad: int,
    *,
    use_kernel: Union[bool, str, None] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One token step. Writes the token's K/V at column write_pos of every
    layer and advances write_pos, both in place; returns (hidden (B, 1, D),
    the same cache).

    use_kernel: False = the XLA form (below); "fused" = kernels J, C, H, I,
    H a layer (`llama_decode_step_fused`); "mega" raises until the mega
    path is ported; None or True = `decode_kernel_choice`."""
    if use_kernel is None or use_kernel is True:
        use_kernel = decode_kernel_choice(cfg, inputs_embeds.device)
    if use_kernel == "mega":
        raise NotImplementedError("the mega decode path (three megakernels a layer) is not "
                                  "ported yet: ROADMAP section 2, item 5")
    if use_kernel:
        return llama_decode_step_fused(params, cfg, inputs_embeds, cache, prompt_pad)
    b = inputs_embeds.shape[0]
    wp = cache.write_pos
    # rope position of the new token per row: prompt_len + tokens generated
    pos = cache.prompt_lens + (wp - prompt_pad)
    cos, sin = rope_cos_sin(pos[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    eps = cfg.rms_norm_eps
    x = inputs_embeds
    for i in range(cfg.num_layers):
        bp = params.blocks.layer(i)
        y = rms_norm(x, bp["attn_norm"], eps)
        q, k, v = _qkv(cfg, bp, y, cos, sin)  # q (B,1,H,Dh), k/v (B,1,K,Dh)
        a = decode_attention_fused(
            q[:, 0], cache.k, cache.v, k[:, 0].to(cache.k.dtype),
            v[:, 0].to(cache.v.dtype), i, prompt_lens=cache.prompt_lens,
            write_pos=wp, prompt_pad=prompt_pad)  # (B, H, Dh)
        x = x + a.reshape(b, 1, -1) @ bp["wo"].to(x.dtype)
        y = rms_norm(x, bp["mlp_norm"], eps)
        x = x + _mlp(bp, y)
    wp.add_(1)
    return x, cache


def llama_decode_step_fused(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    prompt_pad: int,
) -> Tuple[torch.Tensor, KVCache]:
    """The decode step with the layer-indexed kernels
    (`grasp_any_region_tpu/models/llama.py:llama_decode_step_fused`): every
    weight is read once, in place, from its stacked (L, Din, Dout) array.
    Its rounding points are JAX's fused ones: q, k, v rounded by J before
    rope; SiLU * up from fp32 sums with one rounding; the residual adds
    outside the kernels. The cache contract is `llama_decode_step`'s."""
    b = inputs_embeds.shape[0]
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wp = cache.write_pos
    pos = cache.prompt_lens + (wp - prompt_pad)
    cos, sin = rope_cos_sin(pos[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    eps = cfg.rms_norm_eps
    blk = params.blocks
    x = inputs_embeds[:, 0]  # (B, D)
    for i in range(cfg.num_layers):
        y = rms_norm(x, blk.attn_norm[i], eps)
        qf, kf, vf = layer_qkv(y, blk.wq, blk.wk, blk.wv, i)
        q = apply_rope(qf.reshape(b, 1, h, dh), cos, sin)[:, 0]
        k = apply_rope(kf.reshape(b, 1, kh, dh), cos, sin)[:, 0]
        a = decode_attention_fused(
            q, cache.k, cache.v, k.to(cache.k.dtype), vf.reshape(b, kh, dh).to(cache.v.dtype),
            i, prompt_lens=cache.prompt_lens, write_pos=wp, prompt_pad=prompt_pad)
        x = x + layer_matmul(a.reshape(b, h * dh), blk.wo, i)
        y = rms_norm(x, blk.mlp_norm[i], eps)
        x = x + layer_matmul(layer_swiglu(y, blk.w_gate, blk.w_up, i), blk.w_down, i)
    wp.add_(1)
    return x[:, None], cache


def embed_tokens(params: LlamaParams, input_ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    return params.embed[input_ids.long()].to(dtype)


def lm_logits(
    params: LlamaParams,
    cfg: TextConfig,
    hidden: torch.Tensor,
    *,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """hidden (..., D) -> fp32 logits (..., V_rows), padded rows masked."""
    x = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    w = (params.embed.t() if cfg.tie_word_embeddings else params.lm_head).to(x.dtype)
    if x.device.type == "cuda":
        # cuBLAS with an fp32 C (aten::mm.dtype): bf16 operands, fp32 sums, no
        # bf16 rounding of the logits; w stays the (D, V) view of the embedding
        logits = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        logits = logits.reshape(*x.shape[:-1], w.shape[-1])
    else:  # mm.dtype has no CPU kernel; bf16 products are exact in fp32
        logits = x.float() @ w.float()
    v_rows = logits.shape[-1]
    if valid_vocab is not None and valid_vocab < v_rows:
        logits[..., valid_vocab:] = NEG_INF
    return logits
