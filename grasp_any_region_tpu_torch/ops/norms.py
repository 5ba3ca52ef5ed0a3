"""Normalization ops: RMSNorm (Llama decoder) and LayerNorm (PE ViT).

fp32 math, cast back to the input dtype, as the JAX package's reference
forms (`grasp_any_region_tpu/ops/norms.py`). `layer_norm` is that
reference form and dispatches nothing: the JAX package never dispatches its
Pallas LayerNorm either (it measured neutral on the TPU).

Kernel 24 (`csrc/layer_norm.cu`) replaces that Pallas LayerNorm,
`layer_norm_fused` (`_ln_kernel`): one warp a row, the row held in
registers through the mean and the centered variance, one HBM read and one
write. `layer_norm_fused_df` is the counterpart of the JAX package's
custom-gradient wrapper `_layer_norm_tpu`: kernel 24 forward, autograd
through `layer_norm` backward. On a CPU tensor both run the plain version;
on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel 24 launches since the last reset (chip_smoke.py reads it)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


# Kernel 24's plain version: `_ln_kernel` computes `layer_norm`'s arithmetic
# (fp32 mean, centered variance, rsqrt, x w + b, one rounding).
layer_norm_fused_plain = layer_norm


def layer_norm_fused(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6, *,
    block_rows: int = 256,
) -> torch.Tensor:
    """LayerNorm over the trailing dim of x (any leading shape), output in
    x's dtype. `block_rows` is the TPU kernel's row tiling, kept for its
    signature; the result does not depend on it. Kernel 24 takes x in bf16
    or fp32, weight and bias (D,) each in bf16 or fp32, D % 8 == 0 and
    D <= 8192, and no gradient (see `layer_norm_fused_df`)."""
    del block_rows
    if x.device.type == "cpu":
        return layer_norm(x, weight, bias, eps)
    d = x.shape[-1]
    if d % 8 or d > 8192:
        raise ValueError(f"kernel 24 takes a trailing dim that is a multiple of 8 and at most "
                         f"8192, got {d}")
    for t, name, shape in ((x, "x", tuple(x.shape)), (weight, "weight", (d,)),
                           (bias, "bias", (d,))):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name}: kernel 24 takes bfloat16 or float32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and of shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("kernel 24 has no backward: use layer_norm_fused_df")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    f32 = [int(t.dtype == torch.float32) for t in (x, weight, bias)]
    err = _build.library().gar_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // d, d,
        *f32, eps, _build.stream_handle(x.device))
    _build.check(err, "gar_layer_norm")
    global launches
    launches += 1
    return out


class _LayerNormFused(torch.autograd.Function):
    """Kernel 24 forward; the backward is autograd through `layer_norm` on
    the saved (x, weight, bias), as `_ln_bwd` takes the reference form's
    VJP (the TPU kernel is forward-only)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return layer_norm_fused(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm(*inputs, ctx.eps)
        grads = torch.autograd.grad(out, inputs, g)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None)


def layer_norm_fused_df(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """`layer_norm_fused` with a gradient: the counterpart of the JAX
    package's `_layer_norm_tpu`."""
    return _LayerNormFused.apply(x, weight, bias, eps)
