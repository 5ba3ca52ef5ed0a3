"""Kernel B: prefill flash attention (FA-2 forward), causal or full, GQA,
and `flash_attention_df`, its differentiable form with kernels 17 and 18
(ops/flash_backward.py) as the backward.

Replaces `grasp_any_region_tpu/ops/flash_attention.py:flash_attention`
(`_flash_kernel`), at head dim 64 (GAR-1B) and 128 (GAR-8B). On the TPU
one program holds a whole K/V head in VMEM and the grid runs in order;
the CUDA kernel (csrc/flash_forward_sm90.cu) gives each CTA 128 query
rows and streams 128-key K/V tiles through a three-stage TMA ring (at
head dim 128 each 128-key tile is consumed as two 64-key units), with
both products on wgmma (S = Q K^T from shared
memory, O += P V with P in registers); each of two consumer warpgroups
runs its softmax of one key tile under its PV product of the last. At
the prefill's ~4.7k tokens it is bound by the two products (~2*2*Sq*Sk*D
flops per head, halved by the causal mask), so it skips K tiles wholly
above the diagonal, maps a query head to its kv head by index (no
repeated K/V) and reads (B, S, H, D) through strides (TMA tensor maps
encoded per call) with no transpose copies.

Supported: causal with the right-aligned `q_offset = Sk - Sq`, or full
attention; keys past Sk are masked by bounds. For training, the kernel
also writes the per-row log-sum-exp of the scaled logits, (B, H, Sq) fp32
(`return_lse`, the residual the backward reads), and takes segment ids
for packed self-attention (Sq == Sk): token i attends j only where their
ids are equal, so id 0 (padding) attends only padding.

On a CPU tensor the wrapper runs `flash_attention_plain`; on a CUDA tensor
it launches the kernel or raises. The raw wrapper has no backward, so on a
CUDA tensor that needs a gradient it raises: `flash_attention_df` is the
entry point there.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_segments = 0  # of those, launches with segment ids

FWD_TILE = 128  # query rows and keys per tile of kernel B (its segment-skip granularity)
HEAD_DIMS = (64, 128)  # kernel B's instances: GAR-1B's decoder, GAR-8B's


def attention_mask(sq: int, sk: int, causal: bool, segment_ids: Optional[torch.Tensor],
                   device) -> Optional[torch.Tensor]:
    """Keep-mask of the flash kernels, broadcastable to (B, 1, 1, Sq, Sk), or
    None when every pair is kept: causal right-aligned by Sk - Sq, segment
    ids (B, S) equal (self-attention)."""
    mask = None
    if causal:
        qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
        mask = (qpos >= torch.arange(sk, device=device)[None, :])[None, None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, segment_ids: Optional[torch.Tensor] = None,
                          return_lse: bool = False):
    """Masked softmax(q k^T / sqrt(D)) v in fp32; q (B, Sq, H, D), k/v
    (B, Sk, K, D). Output (B, Sq, H, D) in q.dtype, and with return_lse the
    (B, H, Sq) fp32 log-sum-exp of the scaled, masked logits."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3).reshape(b, kh, h // kh, sq, d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # (B, K, 1, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5  # (B, K, G, Sq, Sk)
    mask = attention_mask(sq, sk, causal, segment_ids, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(logits - lse), vf).reshape(b, h, sq, d)
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, h, sq)
    return out


def needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def check_segments(segment_ids: torch.Tensor, b: int, sq: int, sk: int) -> torch.Tensor:
    """(B, S) segment ids as the contiguous int32 tensor the kernels read."""
    if sq != sk or tuple(segment_ids.shape) != (b, sq):
        raise ValueError(f"segment ids need self-attention (Sq == Sk) and shape ({b}, {sq}), "
                         f"got Sq {sq}, Sk {sk}, ids {tuple(segment_ids.shape)}")
    return segment_ids.to(torch.int32).contiguous()


def segment_tiles(seg: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """(B, ceil(S / tile), 2) int32: the [min, max] segment id of each tile
    of rows. The kernels skip a (query tile, key tile) pair whose ranges are
    disjoint: no pair of its rows has equal ids, so all its p are 0. The
    ragged last tile is padded with the row's last id, which widens no range."""
    b, s = seg.shape
    pad = (-s) % tile
    if pad:
        seg = torch.cat([seg, seg[:, -1:].expand(b, pad)], dim=1)
    rows = seg.reshape(b, -1, tile)
    return torch.stack([rows.amin(-1), rows.amax(-1)], dim=-1).contiguous()


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Raise unless kernel B can read q (B, Sq, H, D) and k, v (B, Sk, K,
    D) as they are: D in HEAD_DIMS, bf16 on one device, H % K == 0, Sk >=
    Sq when causal, and a layout its TMA maps take (`_build.check_operand`:
    unit head-dim stride, other strides multiples of 16 bytes, 16-byte
    aligned data). Nothing is copied to fix a layout."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or h % kh:
        raise ValueError(f"bad shapes: q {q.shape}, k {k.shape}, v {v.shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel B is built for head dims {HEAD_DIMS}, got {d}")
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq, got {sk} < {sq}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _build.check_operand(x, name)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0; segment_ids
    (B, S) int for packed self-attention. Returns the output, or (output,
    lse) with return_lse."""
    if segment_ids is not None:
        segment_ids = check_segments(segment_ids, q.shape[0], q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, segment_ids=segment_ids,
                                     return_lse=return_lse)
    if needs_grad(q, k, v):
        raise RuntimeError("kernel B has no backward of its own: call flash_attention_df "
                           "where a gradient is needed")
    check_operands(q, k, v, causal)
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    seg, tiles = segment_ids, None
    if seg is not None:
        if seg.device != q.device:
            raise ValueError(f"segment ids are on {seg.device}, q on {q.device}")
        tiles = segment_tiles(seg, FWD_TILE)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.library()
    err = lib.gar_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if seg is None else seg.data_ptr(),
        None if tiles is None else tiles.data_ptr(), b, sq, sk, h, kh, d, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        d ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "gar_flash_attention")
    global launches, launches_segments
    launches += 1
    launches_segments += seg is not None
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """Kernel B with the LSE forward, kernels 17 and 18 backward (JAX's
    `flash_attention_df` custom_vjp pair)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids):
        if q.device.type == "cuda":  # before the forward: its backward must exist
            from .flash_backward import check_backward_head_dim

            check_backward_head_dim(q.shape[-1], "kernels 17 and 18 (the flash backward)",
                                    causal=causal, segments=segment_ids is not None)
        out, lse = flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                   return_lse=True)
        ctx.causal = causal
        ctx.has_segments = segment_ids is not None
        saved = (q, k, v, out, lse) + ((segment_ids,) if ctx.has_segments else ())
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        from .flash_backward import flash_attention_bwd

        q, k, v, out, lse, *seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, causal=ctx.causal,
                                         segment_ids=seg[0] if seg else None)
        return dq, dk, dv, None, None


def flash_attention_df(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable flash attention: where a gradient is needed, kernel B
    (with its LSE) forward and kernels 17 and 18 backward, through
    `torch.autograd.Function` (on a CPU tensor their plain versions);
    otherwise `flash_attention`, so a path without gradients launches
    exactly what it launched before."""
    if not needs_grad(q, k, v):
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    return _FlashAttention.apply(q, k, v, causal, segment_ids)
