"""Kernels A and E: non-causal ViT attention.

A takes q, k, v as (T, S, H, D) in the JAX layout (the unfused block); E
reads them out of the fused (T, S, 3D) qkv buffer and applies 2D rope
itself (the fused block).

Replaces `grasp_any_region_tpu/ops/vit_attention.py:vit_attention`
(`_vit_attn_kernel`), which keeps a whole (S, S) logits block per (tile,
head) in VMEM. On Hopper that block (4.2 MB fp32 at S = 1025) is far over
the 227 KB of shared memory, so the CUDA kernel (csrc/vit_attention.cu,
body in csrc/flash_tile.cuh) computes the same function with an online
softmax over 64-key tiles on the tensor cores. It is bound by the two
products (~2*2*S^2*D flops per tile-head, with K/V re-read per 64-row query
tile from L2); it reads q, k and v through strides, so the views of the
fused qkv buffer need no head-major copies, and masks keys past S by bounds
instead of padding S to 1152.

Kernel E replaces `vit_attention_fused_qkv` (`_fused_qkv_kernel`): the
same tile with q/k/v as strided views of the qkv buffer and rope on q and k
while they are staged into shared memory (csrc/vit_attention.cu). The TPU
kernel's head-pair (128-lane) layout is not needed: E reads per head.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The LSE output (for the backward) waits for
the training slice.
"""

from __future__ import annotations

import torch

from . import _build
from .rope import rotate_half

launches = 0  # kernel A launches since the last reset (chip_smoke.py reads it)
launches_fused = 0  # kernel E launches


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32 over (T, S, H, D); output in q.dtype."""
    d = q.shape[-1]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # (T, H, S, D)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vf).permute(0, 2, 1, 3).to(q.dtype)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (T, S, H, D), no GQA. Returns (T, S, H, D) in q.dtype."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    t, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if d != 64:
        raise ValueError(f"kernel A is built for head_dim 64, got {d}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _build.check_operand(x, name)
    out = torch.empty((t, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.gar_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), t, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        d ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "gar_vit_attention")
    global launches
    launches += 1
    return out


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


def vit_attention_fused_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                            num_heads: int, head_dim: int) -> torch.Tensor:
    """Kernel E. qkv (T, S, 3D): q at columns [0, D), k [D, 2D), v [2D, 3D),
    head h at h * head_dim; cos/sin (H, S, Dh) fp32 with identity CLS rows.
    Returns the token-major (T, S, D) attention output."""
    if qkv.device.type == "cpu":
        return vit_attention_fused_qkv_plain(qkv, cos, sin, num_heads, head_dim)
    t, s, n3 = qkv.shape
    if n3 != 3 * num_heads * head_dim or head_dim != 64:
        raise ValueError(f"kernel E takes (T, S, 3 * H * 64), got {tuple(qkv.shape)} with "
                         f"{num_heads} heads of {head_dim}")
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise TypeError(f"qkv: the kernel takes a contiguous bfloat16 tensor, got {qkv.dtype}")
    tables = []
    for x, name in ((cos, "cos"), (sin, "sin")):
        if tuple(x.shape) != (num_heads, s, head_dim) or x.device != qkv.device:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, expected "
                             f"({num_heads}, {s}, {head_dim}) on {qkv.device}")
        tables.append(x.float().contiguous())
    out = torch.empty((t, s, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().gar_vit_attention_fused_qkv(
        qkv.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), out.data_ptr(), t, s,
        num_heads, head_dim, head_dim ** -0.5, _build.stream_handle(qkv.device))
    _build.check(err, "gar_vit_attention_fused_qkv")
    global launches_fused
    launches_fused += 1
    return out
