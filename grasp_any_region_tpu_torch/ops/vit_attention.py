"""Kernels A and E: non-causal ViT attention; kernel 5, its backward.

A takes q, k, v as (T, S, H, D) in the JAX layout (the unfused block, D 64
at GAR-1B, 96 at GAR-8B, whose tower the JAX package keeps unfused); E
reads them out of the fused (T, S, 3D) qkv buffer and applies 2D rope
itself (the fused block, inference only, as in JAX). A can also write the
(T, H, S) fp32 row log-sum-exp, which kernel 5 reads, and
`vit_attention_df` pairs the two as a `torch.autograd.Function`.

Replaces `grasp_any_region_tpu/ops/vit_attention.py:vit_attention`
(`_vit_attn_kernel`), which keeps a whole (S, S) logits block per (tile,
head) in VMEM. On Hopper that block (4.2 MB fp32 at S = 1025) is far over
the 227 KB of shared memory, so A is kernel B's Hopper forward
(csrc/flash_forward_sm90.cu: TMA loads, two consumer warpgroups on wgmma,
an online softmax over 128-key tiles), non-causal with one head per kv
head. It is bound by the two products (~2*2*S^2*D flops per tile-head,
with K/V re-read per 128-row query tile from L2). Its TMA maps read q, k
and v through strides, so the views of the unfused block's qkv buffer need
no head-major copies (TMA needs 16-byte aligned bases and strides; a view
that breaks that raises), and the one key past 8 x 128 at S = 1025 takes
an n16 product instead of a whole key tile. At D = 96 A rides on B's
two-atom (D = 128) layout: TMA zero-fills columns 96-127 of each tile, S
takes 6 k-steps and PV runs at n128, 4/3 of PV's products.

Kernel E replaces `vit_attention_fused_qkv` (`_fused_qkv_kernel`): kernel
B's Hopper forward (csrc/flash_forward_sm90.cu: wgmma products, TMA loads,
two consumer warpgroups) reading q, k and v out of the qkv buffer through
one TMA map, with rope applied on the card's tiles in shared memory. Rope
reads fp32 tables, twice K's bytes, so a CTA keeps a head's whole roped K
(S <= 1152) and walks five 128-row query tiles against it: both
consumer warpgroups rope K first, each ropes its own Q rows. The TPU kernel's head-pair (128-lane) layout
is not needed: E reads per head.

Kernel 5 replaces `vit_attention_bwd_onepass` (`_vit_bwd_kernel`), whose
program keeps a whole head's K, V and (S, D) fp32 dk/dv sums in VMEM, four
times an H100 SM's 227 KB at S = 1025. On Hopper it is the non-causal
case of the flash backward (ops/flash_backward.py, with one head per kv
head): 17's prep (delta = rowsum(g * out) and the zeroed fp32 dq
workspace), 18's one pass (csrc/flash_backward_sm90.cu: one CTA per
(128 keys, head, tile) walks the 64-row query tiles through a TMA ring,
five wgmma products a tile pair from the saved LSE, dk and dv summed in
registers, dq added into the workspace by TMA reduce-adds) and 17's
cast. It is bound by the five products, 10 S^2 D flops per tile-head.
The launches count as 17 and 18 too; `launches_bwd` counts the ViT
layer backwards that went through them.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The raw wrappers have no backward, so on a
CUDA tensor that needs a gradient A raises: `vit_attention_df` is the
entry point there.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import needs_grad
from .flash_backward import (check_backward_head_dim, flash_attention_bwd,
                             flash_attention_bwd_plain)
from .rope import rotate_half

launches = 0  # kernel A launches since the last reset (chip_smoke.py reads it)
launches_fused = 0  # kernel E launches
launches_bwd = 0  # kernel 5 calls (each one launch of 17's prep, 18 and 17's cast)

E_MAX_SEQ = 9 * 128  # kernel E's longest sequence (the ViT's is 1025)
HEAD_DIMS = (64, 96)  # kernel A's instances: GAR-1B's tower, GAR-8B's


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        return_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v in fp32 over (T, S, H, D); output in
    q.dtype, and with return_lse the (T, H, S) fp32 row log-sum-exp."""
    d = q.shape[-1]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # (T, H, S, D)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(logits - lse), vf).permute(0, 2, 1, 3).to(q.dtype)
    return (out, lse[..., 0]) if return_lse else out


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless kernel A can read q, k, v (T, S, H, D) as they are:
    equal shapes, D in HEAD_DIMS, bf16 on one device, and a layout its TMA
    maps take (`_build.check_operand`). Nothing is copied to fix a layout."""
    d = q.shape[-1]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel A is built for head dims {HEAD_DIMS}, got {d}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _build.check_operand(x, name)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  return_lse: bool = False):
    """q, k, v: (T, S, H, D), no GQA. Returns (T, S, H, D) in q.dtype, and
    with return_lse the (T, H, S) fp32 log-sum-exp."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, return_lse=return_lse)
    if needs_grad(q, k, v):
        raise RuntimeError("kernel A has no backward of its own: call vit_attention_df "
                           "where a gradient is needed")
    check_operands(q, k, v)
    t, s, h, d = q.shape
    out = torch.empty((t, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((t, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.library()
    err = lib.gar_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), t, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        d ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "gar_vit_attention")
    global launches
    launches += 1
    return (out, lse) if return_lse else out


def vit_attention_bwd_plain(q, k, v, out, lse, g):
    """Kernel 5's plain version: the FA-2 recurrences in fp32
    (`flash_attention_bwd_plain`, non-causal, one head per kv head)."""
    return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=False)


def vit_attention_bwd(q, k, v, out, lse, g):
    """(dq, dk, dv) of `vit_attention` from its saved inputs, output and
    (T, H, S) LSE, and the output's cotangent g, all (T, S, H, D): kernel 5
    (17's prep, 18's pass, 17's cast, non-causal) on a CUDA tensor, the
    plain version on a CPU one. q, k, v may be strided views (v of the
    tower's qkv buffer): 18's tensor maps take their strides."""
    if q.device.type == "cpu":
        return vit_attention_bwd_plain(q, k, v, out, lse, g)
    check_backward_head_dim(q.shape[-1], "kernel 5 (the ViT attention backward)")
    if k.shape != q.shape or v.shape != q.shape or out.shape != q.shape \
            or g.shape != q.shape:
        raise ValueError(f"shapes differ: q {q.shape} k {k.shape} v {v.shape} out "
                         f"{out.shape} g {g.shape}")
    grads = flash_attention_bwd(q, k, v, out, lse, g, causal=False)
    global launches_bwd
    launches_bwd += 1
    return grads


class _VitAttention(torch.autograd.Function):
    """Kernel A with the LSE forward, kernel 5 backward (JAX's
    `vit_attention_df` custom_vjp pair)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cuda":  # before the forward: its backward must exist
            check_backward_head_dim(q.shape[-1], "kernel 5 (the ViT attention backward)")
        out, lse = vit_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return vit_attention_bwd(*ctx.saved_tensors, g)


def vit_attention_df(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable ViT attention: where a gradient is needed, kernel A
    (with its LSE) forward and kernel 5 backward (on a CPU tensor their
    plain versions); otherwise `vit_attention`, unchanged."""
    if not needs_grad(q, k, v):
        return vit_attention(q, k, v)
    return _VitAttention.apply(q, k, v)


def vit_attention_fused_qkv_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                                  num_heads: int, head_dim: int) -> torch.Tensor:
    """Rope q and k in fp32 and round them to qkv.dtype, as the TPU kernel
    does, then attention in fp32. qkv (T, S, 3D); cos/sin (H, S, Dh) from
    ops/rope.rope_head_tables. Returns (T, S, D) in qkv.dtype."""
    t, s, _ = qkv.shape
    q, k, v = qkv.reshape(t, s, 3, num_heads, head_dim).unbind(2)
    cs, sn = cos.permute(1, 0, 2), sin.permute(1, 0, 2)  # (S, H, Dh)

    def rope(z):
        zf = z.float()
        return (zf * cs + rotate_half(zf) * sn).to(z.dtype)

    return vit_attention_plain(rope(q), rope(k), v).reshape(t, s, num_heads * head_dim)


def check_fused_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                    head_dim: int) -> None:
    """Raise unless kernel E can read qkv as it is: a contiguous bfloat16
    (T, S, 3 * H * 64) buffer (one TMA map (64, S, 3H, T), row stride 3D,
    16-byte aligned) with S <= 1152 (a CTA keeps a head's whole roped K in
    shared memory: 9 tiles of 128 keys), and (H, S, 64) cos/sin tables on
    its device (E reads them as contiguous fp32; other tables are copied
    once by the wrapper)."""
    t, s, n3 = qkv.shape
    if n3 != 3 * num_heads * head_dim or head_dim != 64:
        raise ValueError(f"kernel E takes (T, S, 3 * H * 64), got {tuple(qkv.shape)} with "
                         f"{num_heads} heads of {head_dim}")
    if s > E_MAX_SEQ:
        raise ValueError(f"kernel E keeps a head's roped K in shared memory: S <= {E_MAX_SEQ}, "
                         f"got {s}")
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise TypeError(f"qkv: the kernel takes a contiguous bfloat16 tensor, got {qkv.dtype}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv: data must be 16-byte aligned")
    for x, name in ((cos, "cos"), (sin, "sin")):
        if tuple(x.shape) != (num_heads, s, head_dim) or x.device != qkv.device:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, expected "
                             f"({num_heads}, {s}, {head_dim}) on {qkv.device}")


def vit_attention_fused_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                            num_heads: int, head_dim: int) -> torch.Tensor:
    """Kernel E. qkv (T, S, 3D): q at columns [0, D), k [D, 2D), v [2D, 3D),
    head h at h * head_dim; cos/sin (H, S, Dh) fp32 with identity CLS rows.
    Returns the token-major (T, S, D) attention output."""
    if qkv.device.type == "cpu":
        return vit_attention_fused_qkv_plain(qkv, cos, sin, num_heads, head_dim)
    check_fused_qkv(qkv, cos, sin, num_heads, head_dim)
    t, s, _ = qkv.shape
    tables = [x.float().contiguous() for x in (cos, sin)]  # rope_head_tables': no copy
    out = torch.empty((t, s, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().gar_vit_attention_fused_qkv(
        qkv.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), out.data_ptr(), t, s,
        num_heads, head_dim, head_dim ** -0.5, _build.stream_handle(qkv.device))
    _build.check(err, "gar_vit_attention_fused_qkv")
    global launches_fused
    launches_fused += 1
    return out
