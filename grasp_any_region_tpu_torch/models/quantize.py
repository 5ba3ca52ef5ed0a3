"""Int8 weights for the decode path (`grasp_any_region_tpu/models/quantize.py`).

Decode streams every decoder weight once a token, so it is bound by HBM
bytes; symmetric per-output-column int8 halves them. The decode kernels
(H8, I8, J8) widen the int8 weights to bf16 on chip and scale the fp32
sums per output column; prefill keeps the bf16 copies unless they were
dropped (`serving_weights`), and then projects through the int8 ones.

The trees are `GARParams` modules with the JAX package's leaf names:
`quantize_decode_weights` returns a new module that shares every tensor it
does not change with its input (as JAX's `dict(params)` copies share
leaves) and adds `{name}_q8` (int8) and `{name}_scale` (fp32) leaves.
"""

from __future__ import annotations

import copy
from typing import Sequence, Tuple

import torch
from torch import nn

from ..core.config import GARConfig
from ..core.weights import init_leaf, require_device
from .gar import GARParams
from .llama import DECODE_MATMULS


def quantize_int8(w: torch.Tensor, axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Din, Dout) -> int8 values and fp32 scales, one per slice along
    `axis`, the contracting axis (so the scale commutes with the sum):
    scale = max(amax / 127, 1e-12), q = clip(round(w / scale), -127, 127),
    rounding half to even, as jnp.round."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=axis, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _node(module: nn.Module) -> nn.Module:
    """A new module object of the same class holding the same tensors and
    submodules, so adding or dropping leaves leaves `module` as it was."""
    new = copy.copy(module)
    new.__dict__["_parameters"] = dict(module._parameters)
    new.__dict__["_modules"] = dict(module._modules)
    return new


def _leaf(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


@torch.no_grad()
def quantize_decode_weights(params: GARParams, targets: Sequence[str] = DECODE_MATMULS,
                            drop_bf16: bool = False) -> GARParams:
    """params with int8 copies of the decoder matmuls `targets` and of the
    LM head added, on the params' device.

    drop_bf16=False keeps the bf16 originals (prefill uses them; decode reads
    only the int8 copies). drop_bf16=True (serving only) removes them, and
    the bf16 head: the tied `embed` (the int8 (V, D) head with one scale per
    vocab row then doubles as the embedding table) or the untied `lm_head`.
    The head is quantized along D: (V, D) tied, scales (V, 1); (D, V)
    untied, scales (1, V)."""
    out, llm, blocks = _node(params), _node(params.llm), _node(params.llm.blocks)
    for name in targets:
        q, s = quantize_int8(getattr(blocks, name))  # (L, Din, Dout), (L, 1, Dout)
        setattr(blocks, f"{name}_q8", _leaf(q))
        setattr(blocks, f"{name}_scale", _leaf(s))
        if drop_bf16:
            delattr(blocks, name)
    llm.blocks = blocks
    if hasattr(llm, "lm_head"):
        q, s = quantize_int8(llm.lm_head, axis=-2)  # (D, V), (1, V)
        head = "lm_head"
    else:
        q, s = quantize_int8(llm.embed, axis=-1)  # (V, D), (V, 1)
        head = "embed"
    if drop_bf16:
        delattr(llm, head)
    llm.lm_head_q8, llm.lm_head_scale = _leaf(q), _leaf(s)
    out.llm = llm
    return out


def serving_weights(params: GARParams) -> GARParams:
    """Serving-only int8: int8 decoder matmuls and head with no resident
    bf16 copies (the vision tower and projector stay as they are)."""
    return quantize_decode_weights(params, drop_bf16=True)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


@torch.no_grad()
def init_gar_serving_int8(cfg: GARConfig, generator: torch.Generator,
                          device="cuda") -> GARParams:
    """Random params built directly in the serving-only int8 layout, the
    tree `serving_weights` makes of bf16 params, with no bf16 decoder ever
    resident: bf16 vision, projector and mask embed by the init rules of
    `init_gar_params`, uniform int8 decoder matmuls and head in
    [-127, 127] with scales 0.02 / 73.3 (dequantized std about 0.02), ones
    for the norms, and for an untied head a normal(0.02) bf16 embedding.
    The numbers come from a torch generator, not jax.random; the names,
    shapes and dtypes are the JAX tree's."""
    params = GARParams(cfg, device=require_device(device), dtype=torch.bfloat16,
                       q8=DECODE_MATMULS, drop_bf16=True)
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=generator, device=p.device,
                                  dtype=torch.int8))
        elif leaf.endswith("_scale") and name.startswith("llm."):
            p.fill_(0.02 / 73.3)
        elif name == "llm.embed":
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        else:
            init_leaf(name, p, cfg, generator)
    return params
