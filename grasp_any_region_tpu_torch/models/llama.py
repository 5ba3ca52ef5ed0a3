"""Llama-3-family decoder (`grasp_any_region_tpu/models/llama.py`).

  * Prefill: causal attention through `mha` (kernel B on the card; where a
    gradient is needed kernels 17 and 18 backward), over right-padded rows
    or packed multi-document rows (`right_padded=False`: segment ids in the
    kernel), returning per-layer K/V for the cache; for training, each
    layer checkpointed (`remat`) and no K/V kept (`return_kv=False`).
  * Decode: three forms of `llama_decode_step`, as in JAX. The fused form
    (the default on a CUDA tensor) runs per layer kernel J (q, k, v), rope,
    kernel C (cache write + attention), kernel H (wo), kernel I (SwiGLU)
    and H again (w_down), the weights read in place from the stacked
    arrays (ops/layer_matmul.py); with int8 decode weights
    (models/quantize.py) it runs their int8 forms J8, H8, I8, and with an
    int8 cache kernel C8. The mega form runs three kernels a layer
    (ops/decode_megakernel.py): 19 (norm, q, k, v, rope), 22 (cache write,
    attention, wo, residual) and 23 (norm, MLP, residual), or 20, 22, 21
    with int8 decode weights. The XLA form (the default on the CPU) runs
    plain projections around kernel C.
  * KV cache: unpaired (L, B, K, S_max, D), bf16, or int8 with one static
    fp32 scale per (layer, batch row, kv-head pair), the JAX package's
    granularity. Prompt columns [0, prompt_pad)
    are right-padded (rows masked past prompt_lens); generated tokens share
    one write column per step, `write_pos`, a device scalar. The cache and
    `write_pos` are updated in place, so no step copies the cache or waits
    for the host.
  * Logits: the tied (or untied) head with operands in the working dtype
    and fp32 sums and output, as the JAX package contracts them
    (preferred_element_type=float32); padded vocab rows masked to NEG_INF.
    The int8 head widens int8 to the working dtype and scales the fp32
    sums per vocab row.
  * Serving-only int8 trees (the bf16 decoder matmuls dropped) project
    through the int8 leaves in prefill too (`_proj`), and a tied tree
    without `embed` gathers its embedding rows from the int8 head.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import TextConfig
from ..core.weights import ParamGroup, add_param
from ..ops.attention import NEG_INF, mha
from ..ops.decode_attention import decode_attention_fused
from ..ops.decode_megakernel import (decode_attention_wo, layer_mlp_residual,
                                     layer_mlp_residual_q8, layer_qkv_norm_rope,
                                     layer_qkv_norm_rope_q8)
from ..ops.layer_matmul import (layer_matmul, layer_matmul_q8, layer_qkv, layer_qkv_q8,
                                layer_swiglu, layer_swiglu_q8)
from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_attention_reference
from ..ops.rope import apply_rope, llama_inv_freq, rope_cos_sin


DECODE_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, K, S_max, D) head-major, bf16 or int8
    v: torch.Tensor
    prompt_lens: torch.Tensor  # (B,) int32 true prompt lengths
    write_pos: torch.Tensor  # () int32 next column to write, on the cache's device
    # int8 caches (gar.seed_cache_from_prefill(quantize_kv=True)): the static
    # fp32 dequantization scales, (L, B, K/2, 1, 1), one per kv-head pair;
    # None for bf16 caches
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class LlamaParams(nn.Module):
    """Names and layouts of the JAX `params["llm"]` tree.

    q8: None for the bf16 tree; else the tree of JAX
    `quantize_decode_weights(targets=q8, drop_bf16)`: int8 `{name}_q8`
    (L, Din, Dout) and fp32 `{name}_scale` (L, 1, Dout) beside each
    target, and the int8 head `lm_head_q8` with fp32 `lm_head_scale`,
    (V, D) and (V, 1) when tied, (D, V) and (1, V) when not. drop_bf16
    leaves out the bf16 copies of the targets and of the head (the tied
    `embed` or `lm_head`).

    lora: None, or (targets, rank) for the tree of JAX `add_lora_params`:
    fp32 `{name}_lora_a` (L, Din, r) and `{name}_lora_b` (L, r, Dout) beside
    each target and the fp32 scalar `lora_scaling` (train/lora.py)."""

    def __init__(self, cfg: TextConfig, vocab_rows: Optional[int] = None,
                 device=None, dtype=None, *, q8: Optional[Sequence[str]] = None,
                 drop_bf16: bool = False, lora: Optional[Tuple[Sequence[str], int]] = None):
        super().__init__()
        v = vocab_rows or cfg.vocab_size
        d, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        tied = cfg.tie_word_embeddings
        drop = set(q8 or ()) if drop_bf16 else set()
        mats = {"wq": (L, d, h * dh), "wk": (L, d, k * dh), "wv": (L, d, k * dh),
                "wo": (L, h * dh, d),
                "w_gate": (L, d, m), "w_up": (L, d, m), "w_down": (L, m, d)}
        if not set(q8 or ()) <= set(mats):
            raise KeyError(f"int8 targets {sorted(set(q8) - set(mats))} are not decoder matmuls")
        if not (drop_bf16 and q8 is not None and tied):
            add_param(self, "embed", (v, d), device, dtype)
        self.blocks = ParamGroup({
            "attn_norm": (L, d), "mlp_norm": (L, d),
            **{name: shape for name, shape in mats.items() if name not in drop},
        }, device, dtype)
        for name in q8 or ():
            add_param(self.blocks, f"{name}_q8", mats[name], device, torch.int8)
            add_param(self.blocks, f"{name}_scale", (L, 1, mats[name][2]), device, torch.float32)
        if lora is not None:
            targets, rank = lora
            for name in targets:
                _, din, dout = mats[name]
                add_param(self.blocks, f"{name}_lora_a", (L, din, rank), device, torch.float32)
                add_param(self.blocks, f"{name}_lora_b", (L, rank, dout), device, torch.float32)
            add_param(self, "lora_scaling", (), device, torch.float32)
        add_param(self, "final_norm", (d,), device, dtype)
        if not tied and not (drop_bf16 and q8 is not None):
            add_param(self, "lm_head", (d, v), device, dtype)
        if q8 is not None:
            add_param(self, "lm_head_q8", (v, d) if tied else (d, v), device, torch.int8)
            add_param(self, "lm_head_scale", (v, 1) if tied else (1, v), device, torch.float32)


def _proj(bp: dict, name: str, x: torch.Tensor, lora_scaling=None) -> torch.Tensor:
    """x @ the weight `name` of one layer. A serving-only tree (the bf16
    copy dropped) projects through the int8 copy, widened to x's dtype, and
    scales the product per output column (the scale commutes with the sum),
    in x's dtype, as JAX `_proj` does. With lora_scaling (the fp32 leaf of
    an unmerged LoRA tree) a target with adapters adds its fp32 low-rank
    term cast to the product's dtype (`train/lora.lora_delta`)."""
    w = bp.get(name)
    if w is None:
        out = (x @ bp[f"{name}_q8"].to(x.dtype)) * bp[f"{name}_scale"].to(x.dtype)
    else:
        out = x @ w.to(x.dtype)
    if lora_scaling is not None and f"{name}_lora_a" in bp:
        from ..train.lora import lora_delta

        out = out + lora_delta(bp, name, x, lora_scaling).to(out.dtype)
    return out


def _qkv(cfg: TextConfig, bp: dict, x: torch.Tensor, cos, sin, lora_scaling=None):
    b, s, _ = x.shape
    h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(bp, "wq", x, lora_scaling).reshape(b, s, h, dh)
    kk = _proj(bp, "wk", x, lora_scaling).reshape(b, s, k, dh)
    vv = _proj(bp, "wv", x, lora_scaling).reshape(b, s, k, dh)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), vv


def _mlp(bp: dict, x: torch.Tensor, lora_scaling=None) -> torch.Tensor:
    gate, up = _proj(bp, "w_gate", x, lora_scaling), _proj(bp, "w_up", x, lora_scaling)
    return _proj(bp, "w_down", F.silu(gate) * up, lora_scaling)


def _layer(cfg: TextConfig, bp: dict, x: torch.Tensor, cos, sin, attend, lora_scaling=None):
    """One decoder layer of the plain form, x (B, S, D). attend(q, k, v)
    (q (B, S, H, Dh), k / v (B, S, K, Dh) roped) writes whatever cache the
    caller keeps and returns the attention output, reshapeable to (B, S,
    H * Dh). lora_scaling: an unmerged LoRA tree's scaling leaf (prefill).
    Returns (x, k, v)."""
    b, s, _ = x.shape
    eps = cfg.rms_norm_eps
    y = rms_norm(x, bp["attn_norm"], eps)
    q, k, v = _qkv(cfg, bp, y, cos, sin, lora_scaling)
    x = x + _proj(bp, "wo", attend(q, k, v).reshape(b, s, -1), lora_scaling)
    y = rms_norm(x, bp["mlp_norm"], eps)
    return x + _mlp(bp, y, lora_scaling), k, v


def refuse_adapters(params: LlamaParams, entry: str) -> None:
    """Raise on an unmerged LoRA tree: the decode and serving steps read the
    base weights alone, as in JAX, which merges the adapters first."""
    if hasattr(params, "lora_scaling"):
        raise ValueError(f"{entry} got an unmerged LoRA tree (llm/lora_scaling and adapters "
                         "present): fold them in with train.lora.merge_lora first")


def llama_prefill(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) int
    *,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), 0 = padding
    remat: bool = False,
    right_padded: bool = True,
    return_kv: bool = True,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Full-sequence forward. Returns (hidden (B, S, D), (k_all, v_all)),
    k_all / v_all (L, B, S, K, Dh) for cache seeding, or (hidden, None)
    with return_kv=False (training: no layer's K/V stays alive).

    right_padded: the GAR rows are right-padded, so the causal kernel needs
    no segment mask; pass False for packed multi-document rows (per-document
    positions, segment ids 1..n, 0 = padding). remat: checkpoint each layer
    (non-reentrant), as JAX's `jax.checkpoint` scan body. An unmerged LoRA
    tree (`llm/lora_scaling` present) adds its adapters' terms, under remat
    as well."""
    b, s, _ = inputs_embeds.shape
    L, kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_cos_sin(positions, llama_inv_freq(cfg, inputs_embeds.device))
    lora_scaling = getattr(params, "lora_scaling", None)

    def attend(q, k, v):
        return mha(q, k, v, causal=True, segment_ids=segment_ids, right_padded=right_padded)

    def layer(x, bp):
        return _layer(cfg, bp, x, cos, sin, attend, lora_scaling)

    if return_kv:
        ks = inputs_embeds.new_empty((L, b, s, kh, dh))
        vs = inputs_embeds.new_empty((L, b, s, kh, dh))
    x = inputs_embeds
    for i, bp in enumerate(params.blocks.layers()):
        if remat:
            x, k, v = checkpoint(layer, x, bp, use_reentrant=False)
        else:
            x, k, v = layer(x, bp)
        if return_kv:
            ks[i], vs[i] = k, v
    return x, ((ks, vs) if return_kv else None)


def llama_prefill_chunk(
    params: LlamaParams,
    cfg: TextConfig,
    embeds: torch.Tensor,  # (B, C, D) one chunk of the prompt
    positions: torch.Tensor,  # (B, C) absolute positions
    kv_prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Incremental prefill (`grasp_any_region_tpu/models/llama.py:
    llama_prefill_chunk`): one chunk of the prompt against the K/V of the
    chunks before it, so a serving engine can advance a new request's
    prompt a chunk at a time while its other slots decode.

    kv_prefix: (L, B, P, K, Dh) K and V of the earlier chunks, None for the
    first. The chunk's queries attend causally over prefix ++ chunk, the
    mask right-aligned by P (kernel B at Sq = C < Sk = P + C on the card).
    Returns (hidden (B, C, D), (k_all, v_all) (L, B, P + C, K, Dh))."""
    refuse_adapters(params, "llama_prefill_chunk")
    b, c, _ = embeds.shape
    L, kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    p = 0 if kv_prefix is None else kv_prefix[0].shape[2]
    cos, sin = rope_cos_sin(positions, llama_inv_freq(cfg, embeds.device))
    ks = embeds.new_empty((L, b, p + c, kh, dh))
    vs = embeds.new_empty((L, b, p + c, kh, dh))
    if kv_prefix is not None:
        ks[:, :, :p] = kv_prefix[0]
        vs[:, :, :p] = kv_prefix[1]
    x = embeds
    for i, bp in enumerate(params.blocks.layers()):
        def attend(q, k, v, i=i):
            ks[i, :, p:], vs[i, :, p:] = k, v
            return mha(q, ks[i], vs[i], causal=True)

        x, _, _ = _layer(cfg, bp, x, cos, sin, attend)
    return x, (ks, vs)


def decode_kernel_choice(cfg: TextConfig, device) -> Union[bool, str]:
    """The decode form `use_kernel=None` picks: on a CUDA tensor the value
    of GAR_DECODE_PATH, "fused" when it is unset ("mega" for the mega
    form), and False (the XLA form) on the CPU, as the JAX package reads
    GAR_DECODE_PATH on the TPU and picks False elsewhere. JAX also falls
    back to XLA when one layer's q/k/v weights pass 13 MB: its qkv kernels
    hold them whole in the TPU's scoped VMEM. Kernels H-J and 19-20 stream
    column blocks and hold no whole weight, so the port has no such bound,
    and the rule reads the device alone; cfg stays for JAX's signature."""
    if torch.device(device).type == "cuda":
        return os.environ.get("GAR_DECODE_PATH", "fused")
    return False


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
    H a layer (`llama_decode_step_fused`); "mega" = kernels 19, 22, 23 a
    layer (`llama_decode_step_mega`); None or True =
    `decode_kernel_choice`. On the CPU "fused" and "mega" run their kernels'
    plain versions. An int8 cache takes the fused form whatever use_kernel
    says, on any device, as JAX sends its (paired) int8 cache there: only
    kernel C8 reads it (on the CPU through its plain version)."""
    refuse_adapters(params, "llama_decode_step")
    if cache.k.dtype == torch.int8:
        return llama_decode_step_fused(params, cfg, inputs_embeds, cache, prompt_pad)
    if use_kernel is None or use_kernel is True:
        use_kernel = decode_kernel_choice(cfg, inputs_embeds.device)
    if use_kernel == "mega":
        return llama_decode_step_mega(params, cfg, inputs_embeds, cache, prompt_pad)
    if use_kernel:
        return llama_decode_step_fused(params, cfg, inputs_embeds, cache, prompt_pad)
    wp = cache.write_pos
    # rope position of the new token per row: prompt_len + tokens generated
    pos = cache.prompt_lens + (wp - prompt_pad)
    cos, sin = rope_cos_sin(pos[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    x = inputs_embeds
    for i, bp in enumerate(params.blocks.layers()):
        def attend(q, k, v, i=i):  # q (B, 1, H, Dh), k / v (B, 1, K, Dh)
            return decode_attention_fused(
                q[:, 0], cache.k, cache.v, k[:, 0].to(cache.k.dtype),
                v[:, 0].to(cache.v.dtype), i, prompt_lens=cache.prompt_lens,
                write_pos=wp, prompt_pad=prompt_pad)  # (B, H, Dh)

        x, _, _ = _layer(cfg, bp, x, cos, sin, attend)
    wp.add_(1)
    return x, cache


def _fused_layer(cfg: TextConfig, blk, i: int, x: torch.Tensor, cos, sin, attend):
    """Layer i of the fused decode form, x (B, D): kernel J (q, k, v), rope,
    attend(q (B, H, Dh), k, v (B, K, Dh)) -> (B, H, Dh), then H (wo), I
    (SwiGLU) and H (w_down), or J8, H8, I8, H8 with int8 decode weights
    (`wq_q8` present). Its rounding points are JAX's fused ones: q, k, v
    rounded by J before rope; SiLU * up from fp32 sums with one rounding;
    the residual adds outside the kernels. Returns the new x."""
    b = x.shape[0]
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    q8 = hasattr(blk, "wq_q8")
    y = rms_norm(x, blk.attn_norm[i], eps)
    if q8:
        qf, kf, vf = layer_qkv_q8(y, blk.wq_q8, blk.wq_scale, blk.wk_q8, blk.wk_scale,
                                  blk.wv_q8, blk.wv_scale, i)
    else:
        qf, kf, vf = layer_qkv(y, blk.wq, blk.wk, blk.wv, i)
    q = apply_rope(qf.reshape(b, 1, h, dh), cos, sin)[:, 0]
    k = apply_rope(kf.reshape(b, 1, kh, dh), cos, sin)[:, 0]
    a = attend(q, k, vf.reshape(b, kh, dh)).reshape(b, h * dh)
    if q8:
        x = x + layer_matmul_q8(a, blk.wo_q8, blk.wo_scale, i)
        y = rms_norm(x, blk.mlp_norm[i], eps)
        act = layer_swiglu_q8(y, blk.w_gate_q8, blk.w_gate_scale, blk.w_up_q8,
                              blk.w_up_scale, i)
        return x + layer_matmul_q8(act, blk.w_down_q8, blk.w_down_scale, i)
    x = x + layer_matmul(a, blk.wo, i)
    y = rms_norm(x, blk.mlp_norm[i], eps)
    return x + layer_matmul(layer_swiglu(y, blk.w_gate, blk.w_up, i), blk.w_down, i)


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
    outside the kernels. The cache contract is `llama_decode_step`'s.

    With int8 decode weights (`wq_q8` present, models/quantize.py) the
    matmuls are J8, H8, I8, H8; with an int8 cache the attention is C8,
    which takes the new K/V in bf16 whatever the compute dtype (JAX's
    kv_io_dtype) and quantizes the appended column itself."""
    refuse_adapters(params, "llama_decode_step_fused")
    wp = cache.write_pos
    pos = cache.prompt_lens + (wp - prompt_pad)
    cos, sin = rope_cos_sin(pos[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    kv_io = torch.bfloat16 if cache.k.dtype == torch.int8 else cache.k.dtype
    x = inputs_embeds[:, 0]  # (B, D)
    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):
            return decode_attention_fused(
                q, cache.k, cache.v, k.to(kv_io), v.to(kv_io), i,
                prompt_lens=cache.prompt_lens, write_pos=wp, prompt_pad=prompt_pad,
                k_scale=cache.k_scale, v_scale=cache.v_scale)

        x = _fused_layer(cfg, params.blocks, i, x, cos, sin, attend)
    wp.add_(1)
    return x[:, None], cache


def llama_decode_step_mega(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    prompt_pad: int,
) -> Tuple[torch.Tensor, KVCache]:
    """The decode step in three kernels a layer
    (`grasp_any_region_tpu/models/llama.py:llama_decode_step_mega`): 19
    (RMSNorm, q, k, v, rope), 22 (cache write, attention, wo, residual), 23
    (RMSNorm, SwiGLU, w_down, residual), or 20, 22, 21 with int8 decode
    weights (`wq_q8` present; wo through 22's int8 form). No op runs
    between the kernels: the rope rows are built once a token. Its
    rounding points are the mega kernels' own (ops/decode_megakernel.py),
    not the fused step's. It takes the bf16 (or fp32) cache, as JAX's mega
    step; the cache contract is `llama_decode_step`'s."""
    refuse_adapters(params, "llama_decode_step_mega")
    b = inputs_embeds.shape[0]
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wp = cache.write_pos
    pos = cache.prompt_lens + (wp - prompt_pad)
    cos, sin = rope_cos_sin(pos, llama_inv_freq(cfg, inputs_embeds.device))  # (B, Dh) rows
    eps = cfg.rms_norm_eps
    blk = params.blocks
    q8 = hasattr(blk, "wq_q8")
    kw = dict(prompt_lens=cache.prompt_lens, write_pos=wp, prompt_pad=prompt_pad)
    x = inputs_embeds[:, 0]  # (B, D)
    for i in range(cfg.num_layers):
        if q8:
            qf, kf, vf = layer_qkv_norm_rope_q8(
                x, blk.attn_norm, blk.wq_q8, blk.wq_scale, blk.wk_q8, blk.wk_scale, blk.wv_q8,
                blk.wv_scale, cos, sin, cos, sin, i, eps=eps, head_dim=dh)
            x = decode_attention_wo(
                qf.view(b, h, dh), cache.k, cache.v, kf.view(b, kh, dh).to(cache.k.dtype),
                vf.view(b, kh, dh).to(cache.v.dtype), blk.wo_q8, x, i, wo_scale=blk.wo_scale,
                **kw)
            x = layer_mlp_residual_q8(x, blk.mlp_norm, blk.w_gate_q8, blk.w_gate_scale,
                                      blk.w_up_q8, blk.w_up_scale, blk.w_down_q8,
                                      blk.w_down_scale, i, eps=eps)
        else:
            qf, kf, vf = layer_qkv_norm_rope(x, blk.attn_norm, blk.wq, blk.wk, blk.wv, cos, sin,
                                             cos, sin, i, eps=eps, head_dim=dh)
            x = decode_attention_wo(
                qf.view(b, h, dh), cache.k, cache.v, kf.view(b, kh, dh).to(cache.k.dtype),
                vf.view(b, kh, dh).to(cache.v.dtype), blk.wo, x, i, **kw)
            x = layer_mlp_residual(x, blk.mlp_norm, blk.w_gate, blk.w_up, blk.w_down, i,
                                   eps=eps)
    wp.add_(1)
    return x[:, None], cache


def _paged_writer(k_pool: torch.Tensor, v_pool: torch.Tensor, block_table: torch.Tensor,
                  seq_lens: torch.Tensor, active: torch.Tensor):
    """write(i, k, v): one step's k, v (B, K, Dh) into layer i of the pools
    at each slot's position seq_lens[b], as serve/paged_cache
    .append_token_pages writes all layers (inactive slots on the trash
    page); the slots are found once a step."""
    from ..serve.paged_cache import token_slots  # serve/ imports this module

    pid, off = token_slots(block_table, seq_lens, active, k_pool.shape[3])

    def write(i, k, v):
        # the integer index goes first, so the target is (K, B, Dh)
        k_pool[i][:, pid, off] = k.transpose(0, 1).to(k_pool.dtype)
        v_pool[i][:, pid, off] = v.transpose(0, 1).to(v_pool.dtype)
    return write


def llama_decode_step_paged(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D), B = engine slots
    k_pool: torch.Tensor,  # (L, K, N, PS, Dh) page pools (serve/paged_cache.py)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP) int
    seq_lens: torch.Tensor,  # (B,) int cached tokens per slot, before the step
    active: torch.Tensor,  # (B,) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the paged pools, every slot at its own
    length (`grasp_any_region_tpu/models/llama.py:llama_decode_step_paged`).
    The new token's K/V land at position seq_lens[b] (page
    block_table[b, seq_lens // PS], offset seq_lens % PS), inactive slots'
    on the trash page, in place; attention is `paged_attention_reference`
    over seq_lens + 1 tokens. Plain projections on every device, as the
    JAX form is XLA. Returns (hidden (B, 1, D), k_pool, v_pool); the caller
    advances seq_lens."""
    refuse_adapters(params, "llama_decode_step_paged")
    cos, sin = rope_cos_sin(seq_lens[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    write = _paged_writer(k_pool, v_pool, block_table, seq_lens, active)
    post_lens = seq_lens + 1  # attention covers the token being written
    x = inputs_embeds
    for i, bp in enumerate(params.blocks.layers()):
        def attend(q, k, v, i=i):  # (B, 1, H, Dh), (B, 1, K, Dh)
            write(i, k[:, 0], v[:, 0])
            return paged_attention_reference(q[:, 0], k_pool[i], v_pool[i], block_table,
                                             post_lens)

        x, _, _ = _layer(cfg, bp, x, cos, sin, attend)
    return x, k_pool, v_pool


def llama_decode_step_paged_fused(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D), B = engine slots
    k_pool: torch.Tensor,  # (L, K, N, PS, Dh)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP) int
    seq_lens: torch.Tensor,  # (B,) int
    active: torch.Tensor,  # (B,) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`llama_decode_step_paged` with the layer-indexed weight stream
    (`grasp_any_region_tpu/models/llama.py:llama_decode_step_paged_fused`):
    the fused step's layer (`_fused_layer`: J, H, I, H or J8, H8, I8, H8)
    around the plain paged attention. JAX pads the rows to at least 8 for
    the TPU's sublanes; the stream kernels take any row count up to
    layer_matmul.MAX_ROWS, so the rows go in as they are."""
    refuse_adapters(params, "llama_decode_step_paged_fused")
    cos, sin = rope_cos_sin(seq_lens[:, None], llama_inv_freq(cfg, inputs_embeds.device))
    write = _paged_writer(k_pool, v_pool, block_table, seq_lens, active)
    post_lens = seq_lens + 1
    x = inputs_embeds[:, 0]  # (B, D)
    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):  # (B, H, Dh), (B, K, Dh)
            write(i, k, v)
            return paged_attention_reference(q, k_pool[i], v_pool[i], block_table, post_lens)

        x = _fused_layer(cfg, params.blocks, i, x, cos, sin, attend)
    return x[:, None], k_pool, v_pool


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: the rows of a (N, D) table at an integer index of any
    shape. On the CPU through index_select: the backward of advanced
    indexing (index_put_ with accumulate) adds repeated rows in parallel
    there, in an order that changes from run to run, where index_select's
    (index_add_) adds them in order, so a CPU train step is reproducible bit
    for bit. On the card advanced indexing's backward sorts the indices and
    is reproducible as it is."""
    if table.device.type != "cpu":
        return table[idx]
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])


def embed_tokens(params: LlamaParams, input_ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding lookup. A serving-only tied tree has no `embed`: its
    (V, D) int8 head, with one scale per vocab row, doubles as the table
    (the int8 rows gathered, widened and scaled in `dtype`, as in JAX)."""
    ids = input_ids.long()
    table = getattr(params, "embed", None)
    if table is None:
        scale = params.lm_head_scale
        if scale.shape[-1] != 1:
            raise ValueError("the int8 embedding lookup needs the tied (V, D) head layout")
        return params.lm_head_q8[ids].to(dtype) * scale[ids].to(dtype)
    return take_rows(table, ids).to(dtype)


def _int8_head(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 logits of x (N, D) against the int8 head, per-vocab scales on
    the fp32 sums. The layout comes from the scale's shape, as in JAX: (V, 1)
    is the tied (V, D) head, (1, V) the untied (D, V) one (the weight's
    shape cannot tell them apart when V == D). On the card the whole head is
    widened to x's dtype (exact for int8; a 0.5 GB temporary at gar_1b) and
    multiplied by cuBLAS with fp32 sums: one widen and one product were
    faster than any chunking over V. The widening pass sets the time, about
    4x the bf16 head's on the H100 (PERF.md); a hand W8A16 head kernel is
    queued (ROADMAP section 2)."""
    tied = scale.shape[-1] == 1
    if x.device.type != "cuda":  # fp32 products of the widened operands are exact
        w = q8.float()
        logits = x.float() @ (w.t() if tied else w)
    else:
        w = q8.to(x.dtype)
        logits = torch.mm(x, w.t() if tied else w, out_dtype=torch.float32)
    return logits * scale.reshape(-1)


def lm_logits(
    params: LlamaParams,
    cfg: TextConfig,
    hidden: torch.Tensor,
    *,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """hidden (..., D) -> fp32 logits (..., V_rows), padded rows masked.
    A tree with the int8 head (models/quantize.py) uses it."""
    x = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    if hasattr(params, "lm_head_q8"):
        logits = _int8_head(x.reshape(-1, x.shape[-1]), params.lm_head_q8, params.lm_head_scale)
        logits = logits.reshape(*x.shape[:-1], logits.shape[-1])
    elif x.device.type == "cuda":
        w = (params.embed.t() if cfg.tie_word_embeddings else params.lm_head).to(x.dtype)
        # cuBLAS with an fp32 C (aten::mm.dtype): bf16 operands, fp32 sums, no
        # bf16 rounding of the logits; w stays the (D, V) view of the embedding
        logits = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        logits = logits.reshape(*x.shape[:-1], w.shape[-1])
    else:  # mm.dtype has no CPU kernel; bf16 products are exact in fp32
        w = params.embed.t() if cfg.tie_word_embeddings else params.lm_head
        logits = x.float() @ w.float()
    v_rows = logits.shape[-1]
    if valid_vocab is not None and valid_vocab < v_rows:
        logits[..., valid_vocab:] = NEG_INF
    return logits
