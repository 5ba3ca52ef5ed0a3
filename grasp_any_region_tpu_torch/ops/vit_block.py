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
the branch and the residual add in fp32, bf16 output. All three run on
the Hopper GEMM of csrc/gemm_sm90.cu (main loop in csrc/gemm_sm90.cuh): a
persistent CTA an SM, a TMA ring of (A, B) K-slabs, two consumer
warpgroups on wgmma with the weight read as stored, and the epilogue
(bias; GELU; LayerScale and residual) applied on a shared-memory tile that
TMA fills with x and stores back. D and G (csrc/vit_block.cu) first write
LayerNorm(x) in bf16 by kernel 24's row body (csrc/layer_norm.cuh) into a
workspace; G's fc1 writes its (T * S, M) hidden to a second one, which fc2
reads back (one CTA cannot hold a 128-row tile's fc2 sums, as the TPU
kernel holds the hidden in VMEM). They take the (T, S) rows as they are: S
need not be a multiple of 8 (the TPU kernels' block rule).

On a CPU tensor each wrapper runs its plain version (below, same rounding
points in torch); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .norms import layer_norm

launches = dict(D=0, F=0, G=0)  # wrapper calls since the last reset (chip_smoke.py reads it)


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


def _vector(v: Optional[torch.Tensor], x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A (n,) fp32 vector for the kernel; None (no LayerScale) becomes ones."""
    if v is None:
        return torch.ones(n, dtype=torch.float32, device=x.device)
    if tuple(v.shape) != (n,) or v.device != x.device:
        raise ValueError(f"{name}: shape {tuple(v.shape)} on {v.device}, expected ({n},)")
    return v.float().contiguous()


def _check_operands(kernel: str, widths: dict, **tensors: torch.Tensor) -> None:
    """Raise unless every width is a multiple of 128 (the GEMM's 128-column
    tiles and 64-deep K slabs) and every tensor is bfloat16, contiguous, on
    x's device and 16-byte aligned: what TMA reads as it is."""
    for name, n in widths.items():
        if n % 128:
            raise ValueError(f"kernel {kernel} takes widths that are multiples of 128, got "
                             f"{name} = {n}")
    x = tensors["x"]
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def check_ln_qkv(x: torch.Tensor, wqkv: torch.Tensor) -> None:
    """Raise unless kernel D can read its operands by TMA as they are: x
    (..., D) bfloat16 rows, wqkv a (D, N) bfloat16 (K, N) matrix, both
    contiguous on one device with 16-byte aligned data, D and N multiples
    of 128."""
    d = x.shape[-1]
    if wqkv.dim() != 2 or wqkv.shape[0] != d:
        raise ValueError(f"kernel D takes wqkv (D, N): x {tuple(x.shape)}, wqkv "
                         f"{tuple(wqkv.shape)}")
    _check_operands("D", dict(D=d, N=wqkv.shape[1]), x=x, wqkv=wqkv)


def check_wo_residual(attn: torch.Tensor, x: torch.Tensor, wo: torch.Tensor) -> None:
    """Raise unless kernel F can read its operands by TMA as they are: attn
    and x the same (..., D) bfloat16 rows, wo a (D, D) bfloat16 (K, N)
    matrix, all three contiguous on one device with 16-byte aligned data,
    and D a multiple of 128."""
    d = x.shape[-1]
    if attn.shape != x.shape or tuple(wo.shape) != (d, d):
        raise ValueError(f"kernel F takes attn and x alike and wo (D, D): attn "
                         f"{tuple(attn.shape)}, x {tuple(x.shape)}, wo {tuple(wo.shape)}")
    _check_operands("F", dict(D=d), attn=attn, x=x, wo=wo)


def check_mlp_residual(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor) -> None:
    """Raise unless kernel G can read its operands by TMA as they are: x
    (..., D) bfloat16 rows, fc1 a (D, M) and fc2 an (M, D) bfloat16 (K, N)
    matrix, all three contiguous on one device with 16-byte aligned data, D
    and M multiples of 128."""
    d = x.shape[-1]
    m = fc1.shape[-1]
    if fc1.dim() != 2 or fc1.shape[0] != d or tuple(fc2.shape) != (m, d):
        raise ValueError(f"kernel G takes fc1 (D, M) and fc2 (M, D): x {tuple(x.shape)}, fc1 "
                         f"{tuple(fc1.shape)}, fc2 {tuple(fc2.shape)}")
    _check_operands("G", dict(D=d, M=m), x=x, fc1=fc1, fc2=fc2)


def vit_ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, *, eps: float = 1e-6):
    """Kernel D: LayerNorm(x) @ wqkv + bqkv. x (T, S, D) -> (T, S, 3D)."""
    if x.device.type == "cpu":
        return vit_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv, eps=eps)
    w = wqkv.to(torch.bfloat16).contiguous()  # a no-op for the tower's bf16 weights
    check_ln_qkv(x, w)
    d, n = w.shape
    xr = x.reshape(-1, d)
    # held in locals: a temporary's memory could be reused before the launch
    lw, lb, b = (_vector(ln_scale, x, d, "ln_scale"), _vector(ln_bias, x, d, "ln_bias"),
                 _vector(bqkv, x, n, "bqkv"))
    xn = torch.empty_like(xr)  # LayerNorm(x) in bf16, the product's A
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    err = _build.library().gar_vit_ln_qkv(
        xr.data_ptr(), lw.data_ptr(), lb.data_ptr(), w.data_ptr(), b.data_ptr(),
        xn.data_ptr(), out.data_ptr(), xr.shape[0], d, n, eps, _build.stream_handle(x.device))
    _build.check(err, "gar_vit_ln_qkv")
    launches["D"] += 1
    return out


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
    """Kernel G: x + ls * (gelu(LayerNorm(x) @ fc1 + b1) @ fc2 + b2). x
    (T, S, D); the (T * S, M) hidden goes through a workspace."""
    if x.device.type == "cpu":
        return vit_mlp_residual_plain(x, ln_scale, ln_bias, fc1, b1, fc2, b2, ls, eps=eps,
                                      fast_gelu=fast_gelu)
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (fc1, fc2))
    check_mlp_residual(x, w1, w2)
    d, m = w1.shape
    xr = x.reshape(-1, d)
    lw, lb, v1, v2, g = (_vector(ln_scale, x, d, "ln_scale"), _vector(ln_bias, x, d, "ln_bias"),
                         _vector(b1, x, m, "b1"), _vector(b2, x, d, "b2"),
                         _vector(ls, x, d, "ls"))
    xn = torch.empty_like(xr)  # LayerNorm(x) in bf16, fc1's A
    h = torch.empty((xr.shape[0], m), dtype=x.dtype, device=x.device)  # fc2's A
    out = torch.empty_like(x)
    err = _build.library().gar_vit_mlp_residual(
        xr.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(), v1.data_ptr(),
        w2.data_ptr(), v2.data_ptr(), g.data_ptr(), xn.data_ptr(), h.data_ptr(), out.data_ptr(),
        xr.shape[0], d, m, eps, int(fast_gelu), _build.stream_handle(x.device))
    _build.check(err, "gar_vit_mlp_residual")
    launches["G"] += 1
    return out
