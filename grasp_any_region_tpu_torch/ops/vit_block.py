"""Kernels D, F and G: the GEMMs of the fused ViT block.

The JAX package runs each Perception-Encoder layer on the TPU as four
Pallas kernels (`grasp_any_region_tpu/ops/vit_block.py`, with
`vit_attention_fused_qkv`, kernel E, in ops/vit_attention.py):

  D  vit_ln_qkv       LayerNorm(x) @ wqkv + bqkv              -> (T, S, 3D)
  F  vit_wo_residual  x + ls * (attn @ wo + bo)
  G  vit_mlp_residual x + ls * (gelu(LayerNorm(x) @ fc1 + b1) @ fc2 + b2)

so that no LayerNorm, bias, GELU, LayerScale or residual pass goes through
device memory on its own, and G's (T, S, 4D) hidden never does. The CUDA
kernels keep the same rounding points: LayerNorm in fp32 rounded to bf16
before the product, fp32 sums, GELU in fp32 rounded to bf16 before fc2,
the branch and the residual add in fp32, bf16 output. D and G
(csrc/vit_block.cu) run on the mma.sync GEMM tile of csrc/gemm_tile.cuh;
F (csrc/gemm_sm90.cu) on the Hopper main loop of csrc/gemm_sm90.cuh: a
persistent CTA an SM, a TMA ring of (attn, wo) K-slabs, two consumer
warpgroups on wgmma with wo read as stored, and the bias, LayerScale and
residual applied on a shared-memory tile that TMA fills with x and
stores back. They take the (T, S) rows
as they are: S need not be a multiple of 8 (the TPU kernels' block rule).

On a CPU tensor each wrapper runs its plain version (below, same rounding
points in torch); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .norms import layer_norm

launches = dict(D=0, F=0, G=0)  # kernel launches since the last reset (chip_smoke.py reads it)

MLP_WIDTHS = (128, 256, 1024)  # ViT widths kernel G is built for: tests, narrow, gar_1b


def gelu_f32(h: torch.Tensor, fast: bool) -> torch.Tensor:
    """The JAX kernels' GELU on fp32: the tanh form, or the exact erf form
    (the TPU kernel's A&S erf polynomial is within 1.5e-7 of erf)."""
    if fast:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * h * (1.0 + torch.tanh(c * (h + 0.044715 * h * h * h)))
    return 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))


def vit_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv, *, eps: float = 1e-6):
    xn = layer_norm(x, ln_scale, ln_bias, eps)  # fp32 math, rounded to x.dtype
    return (xn.float() @ wqkv.float() + bqkv.float()).to(x.dtype)


def vit_wo_residual_plain(attn, x, wo, bo, ls=None):
    branch = attn.float() @ wo.float() + bo.float()
    if ls is not None:
        branch = branch * ls.float()
    return (x.float() + branch).to(x.dtype)


def vit_mlp_residual_plain(x, ln_scale, ln_bias, fc1, b1, fc2, b2, ls=None, *,
                           eps: float = 1e-6, fast_gelu: bool = False):
    xn = layer_norm(x, ln_scale, ln_bias, eps)
    h = gelu_f32(xn.float() @ fc1.float() + b1.float(), fast_gelu).to(x.dtype)
    branch = h.float() @ fc2.float() + b2.float()
    if ls is not None:
        branch = branch * ls.float()
    return (x.float() + branch).to(x.dtype)


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """x as a contiguous bf16 (rows, width) CUDA tensor, or raise."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x.reshape(-1, x.shape[-1])


def _weight(w: torch.Tensor, x: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {tuple(shape)}")
    if w.device != x.device:
        raise ValueError(f"{name} is on {w.device}, x on {x.device}")
    return w.to(torch.bfloat16).contiguous()


def _vector(v: Optional[torch.Tensor], x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A (n,) fp32 vector for the kernel; None (no LayerScale) becomes ones."""
    if v is None:
        return torch.ones(n, dtype=torch.float32, device=x.device)
    if tuple(v.shape) != (n,) or v.device != x.device:
        raise ValueError(f"{name}: shape {tuple(v.shape)} on {v.device}, expected ({n},)")
    return v.float().contiguous()


def _check_tiles(k: int, n: int, name: str) -> None:
    if k % 64 or n % 128:
        raise ValueError(f"{name}: the kernel takes K % 64 == 0 and N % 128 == 0, got "
                         f"K {k}, N {n}")


def vit_ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, *, eps: float = 1e-6):
    """Kernel D: LayerNorm(x) @ wqkv + bqkv. x (T, S, D) -> (T, S, 3D)."""
    if x.device.type == "cpu":
        return vit_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv, eps=eps)
    d = x.shape[-1]
    n = wqkv.shape[-1]
    _check_tiles(d, n, "vit_ln_qkv")
    xr = _rows(x, "x")
    w = _weight(wqkv, x, (d, n), "wqkv")
    # held in locals: a temporary's memory could be reused before the launch
    lw, lb, b = (_vector(ln_scale, x, d, "ln_scale"), _vector(ln_bias, x, d, "ln_bias"),
                 _vector(bqkv, x, n, "bqkv"))
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    err = _build.library().gar_vit_ln_qkv(
        xr.data_ptr(), lw.data_ptr(), lb.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), xr.shape[0], d, n, eps, _build.stream_handle(x.device))
    _build.check(err, "gar_vit_ln_qkv")
    launches["D"] += 1
    return out


def check_wo_residual(attn: torch.Tensor, x: torch.Tensor, wo: torch.Tensor) -> None:
    """Raise unless kernel F can read its operands by TMA as they are: attn
    and x the same (..., D) bfloat16 rows, wo a (D, D) bfloat16 (K, N)
    matrix, all three contiguous on one device with 16-byte aligned data,
    and D a multiple of 128 (the tile takes 64-deep K slabs and 128 output
    columns)."""
    d = x.shape[-1]
    if attn.shape != x.shape or tuple(wo.shape) != (d, d):
        raise ValueError(f"kernel F takes attn and x alike and wo (D, D): attn "
                         f"{tuple(attn.shape)}, x {tuple(x.shape)}, wo {tuple(wo.shape)}")
    if d % 128:
        raise ValueError(f"kernel F takes widths that are multiples of 128, got {d}")
    for t, name in ((attn, "attn"), (x, "x"), (wo, "wo")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def vit_wo_residual(attn, x, wo, bo, ls=None):
    """Kernel F: x + ls * (attn @ wo + bo). attn, x (T, S, D)."""
    if x.device.type == "cpu":
        return vit_wo_residual_plain(attn, x, wo, bo, ls)
    d = x.shape[-1]
    w = wo.to(torch.bfloat16).contiguous()  # a no-op for the tower's bf16 weights
    check_wo_residual(attn, x, w)
    ar, xr = attn.reshape(-1, d), x.reshape(-1, d)
    b, g = _vector(bo, x, d, "bo"), _vector(ls, x, d, "ls")
    out = torch.empty_like(x)
    err = _build.library().gar_vit_wo_residual(
        ar.data_ptr(), xr.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
        out.data_ptr(), xr.shape[0], d, _build.stream_handle(x.device))
    _build.check(err, "gar_vit_wo_residual")
    launches["F"] += 1
    return out


def vit_mlp_residual(x, ln_scale, ln_bias, fc1, b1, fc2, b2, ls=None, *,
                     eps: float = 1e-6, fast_gelu: bool = False):
    """Kernel G: x + ls * (gelu(LayerNorm(x) @ fc1 + b1) @ fc2 + b2), the
    (T, S, M) hidden kept on chip. x (T, S, D)."""
    if x.device.type == "cpu":
        return vit_mlp_residual_plain(x, ln_scale, ln_bias, fc1, b1, fc2, b2, ls, eps=eps,
                                      fast_gelu=fast_gelu)
    d, m = x.shape[-1], fc1.shape[-1]
    if d not in MLP_WIDTHS or m % 256:
        raise ValueError(f"kernel G is built for widths {MLP_WIDTHS} and hidden sizes "
                         f"that are multiples of 256, got {d}, {m}")
    xr = _rows(x, "x")
    w1, w2 = _weight(fc1, x, (d, m), "fc1"), _weight(fc2, x, (m, d), "fc2")
    lw, lb, v1, v2, g = (_vector(ln_scale, x, d, "ln_scale"), _vector(ln_bias, x, d, "ln_bias"),
                         _vector(b1, x, m, "b1"), _vector(b2, x, d, "b2"),
                         _vector(ls, x, d, "ls"))
    out = torch.empty_like(x)
    err = _build.library().gar_vit_mlp_residual(
        xr.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(), v1.data_ptr(),
        w2.data_ptr(), v2.data_ptr(), g.data_ptr(), out.data_ptr(), xr.shape[0], d, m, eps,
        int(fast_gelu), _build.stream_handle(x.device))
    _build.check(err, "gar_vit_mlp_residual")
    launches["G"] += 1
    return out
