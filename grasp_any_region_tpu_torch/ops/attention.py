"""Attention: plain-torch references and the `mha` dispatch.

Counterpart of `grasp_any_region_tpu/ops/attention.py`. All softmax math is
fp32. Masked logits take the large-but-finite NEG_INF, not -inf, so a fully
masked row never yields NaN from (-inf) - (-inf).

`mha` dispatches by device alone: a CUDA tensor goes to the prefill flash
kernel (ops/flash_attention.py; where a gradient is needed, its
differentiable form with kernels 17 and 18 backward), a CPU tensor to
`mha_reference`, which is what the JAX package runs off the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def repeat_kv(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, S, K*n, D) repeating each kv head n times."""
    if n == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n, d).reshape(b, s, k * n, d)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention, logits scaled by D**-0.5.

    q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0 (GQA).

    Causal masks are right-aligned (q is a suffix of the kv sequence).
    segment_ids (B, S): tokens attend only within equal ids (self-attention).
    Returns (B, Sq, H, D) in q.dtype.
    """
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qf = q * d ** -0.5
    kf = repeat_kv(k, h // kh)
    vf = repeat_kv(v, h // kh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf.float(), kf.float())
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = (qpos >= kpos)[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), vf.float())
    return out.to(q.dtype)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    right_padded: bool = False,
) -> torch.Tensor:
    """Dispatching attention entry point, by the JAX package's flash_safe
    rule on a CUDA tensor.

    Under a multi-rank mesh the callers (models/vision, models/llama,
    parallel/ulysses) hold their rank's rows and heads already, JAX's
    `_flash_sharded` layout, and call it on those.

    right_padded=True asserts that segment_ids encodes nothing but trailing
    padding: under a causal mask real tokens never see trailing pads, so the
    kernel drops the segment mask and stays exact for every real row (pad
    rows hold garbage that the prompt lengths mask later). Packed rows
    (right_padded=False, causal self-attention) take the kernel with its
    segment mask. Segment ids in any other form have no kernel and raise.
    """
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids)
    flash_safe = segment_ids is None or (causal and (right_padded or q.shape[1] == k.shape[1]))
    if not flash_safe:
        raise ValueError("segment ids need causal self-attention (or right_padded=True) "
                         "on the flash kernel")
    from .flash_attention import flash_attention_df

    segs = None if causal and right_padded else segment_ids
    return flash_attention_df(q, k, v, causal=causal, segment_ids=segs)


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    prompt_lens: torch.Tensor,
    write_pos: torch.Tensor,
    prompt_pad: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step attention against the two-interval KV cache.

    q: (B, H, D); k_cache/v_cache: (B, K, S, D) head-major. Valid columns of
    row b: [0, prompt_lens[b]) and [prompt_pad, write_pos] (the current token
    sits at write_pos). write_pos is a () device tensor: nothing here waits
    for the host. `scale` (default D**-0.5) is rounded to q's dtype and
    multiplies q before the product, and probabilities are cast to the cache
    dtype before the PV product, as in the JAX reference.
    """
    b, h, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, kh, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qf.float(), k_cache.float())
    ids = torch.arange(s, device=q.device)[None, :]
    valid = (ids < prompt_lens[:, None]) | ((ids >= prompt_pad) & (ids <= write_pos))
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
