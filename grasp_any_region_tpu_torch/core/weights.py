"""Parameters: the JAX tree's names and layouts as `nn.Module`s, the loader
from its flattened numpy form, and a seeded random init.

The JAX package flattens its parameter tree to numpy with
`core/weights.flatten_params`, under '/'-joined names such as
`llm/blocks/wq`. The port's modules hold the same tensors under the same
names ('.'-joined) and layouts: (Din, Dout) kernels used as x @ W, blocks
stacked on a leading L axis, the channel-major patch kernel. So loading is
a name-for-name copy.

The int8 trees of `grasp_any_region_tpu/models/quantize.py` load the same
way: their `*_q8` leaves are int8 and their `*_scale` leaves fp32 whatever
the working dtype, held as `nn.Parameter(..., requires_grad=False)` like
every other leaf (so `named_parameters`, `.to(device)` and the loader's
name check treat them alike).

The entry points that make the port's tensors (`load_flat_params`,
`init_gar_params`, and `data/synthetic.synthetic_batch`,
`models/quantize.init_gar_serving_int8`) build on the card unless the
caller asks for the CPU, and raise where there is no card.

Training (`train/step.init_state`) turns on `requires_grad` for every
float leaf, as `jax.value_and_grad` differentiates the whole tree; the
optimizer's mask decides which leaves move. `flat_grads` gives the
gradients back under the flat JAX names.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .config import GARConfig


def require_device(device) -> torch.device:
    """The device an entry point builds on. A CUDA device without a card
    raises: the port never moves to the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for (the default) but torch.cuda.is_available() "
                           "is false; pass device='cpu' to build on the CPU")
    return dev


def add_param(module: nn.Module, name: str, shape, device=None, dtype=None) -> None:
    """Register an uninitialised, non-trainable tensor on `module` (an int8
    one too: a Parameter that needs no gradient may hold any dtype)."""
    module.register_parameter(
        name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                           requires_grad=False))


class ParamGroup(nn.Module):
    """The tensors of one node of the JAX parameter tree."""

    def __init__(self, shapes: Mapping[str, tuple], device=None, dtype=None):
        super().__init__()
        for name, shape in shapes.items():
            add_param(self, name, shape, device, dtype)

    def layer(self, i: int) -> dict:
        """Views of layer i of tensors stacked on a leading L axis."""
        return {name: p[i] for name, p in self.named_parameters()}

    def layers(self) -> list:
        """Every layer's views, from one `unbind` per stacked tensor. Under
        autograd the backward of each is one `stack` of the layers'
        gradients, where L calls of `layer(i)` would each add a zero-filled
        (L, ...) gradient."""
        names, tensors = zip(*self.named_parameters())
        return [dict(zip(names, views)) for views in zip(*(p.unbind(0) for p in tensors))]


def _int8_layout(flat: Mapping[str, np.ndarray], cfg: GARConfig) -> dict:
    """The `GARParams` int8 arguments a flat tree's names call for: `q8`,
    the decoder matmuls with `*_q8` leaves (None for a tree without the
    int8 head, i.e. not quantized), and `drop_bf16`, whether the bf16
    head (the tied embedding or `lm_head`) was dropped."""
    from ..models.llama import DECODE_MATMULS

    if "llm/lm_head_q8" not in flat:
        return dict(q8=None, drop_bf16=False)
    head = "llm/embed" if cfg.text.tie_word_embeddings else "llm/lm_head"
    return dict(q8=tuple(n for n in DECODE_MATMULS if f"llm/blocks/{n}_q8" in flat),
                drop_bf16=head not in flat)


def _lora_layout(flat: Mapping[str, np.ndarray]):
    """The `GARParams` lora argument a flat tree's names call for: None, or
    (targets, rank) read from its `llm/blocks/{target}_lora_a` leaves (JAX
    `train/lora.add_lora_params`)."""
    from ..models.llama import DECODE_MATMULS

    targets = tuple(n for n in DECODE_MATMULS if f"llm/blocks/{n}_lora_a" in flat)
    if not targets:
        return None
    return targets, int(np.shape(flat[f"llm/blocks/{targets[0]}_lora_a"])[-1])


def load_flat_params(flat: Mapping[str, np.ndarray], cfg: GARConfig,
                     device="cuda", dtype=torch.float32):
    """Build `GARParams` from a flat {'a/b/c': array} dict, bf16 or int8
    (`_int8_layout` reads which from the names), with or without LoRA
    adapters (`_lora_layout`).

    Raises KeyError on a missing or unused name, ValueError on a shape
    mismatch and TypeError on a float array for an int8 leaf. The learned
    rope frequencies, the int8 scales, the adapters and `llm/lora_scaling`
    stay fp32 and the `*_q8` leaves int8, as in the JAX tree.
    """
    from ..models.gar import GARParams

    params = GARParams(cfg, device=require_device(device), dtype=dtype,
                       **_int8_layout(flat, cfg), lora=_lora_layout(flat))
    expected = {name.replace(".", "/"): p for name, p in params.named_parameters()}
    missing = sorted(set(expected) - set(flat))
    unused = sorted(set(flat) - set(expected))
    if missing or unused:
        raise KeyError(f"parameter names differ: missing {missing}, unused {unused}")
    for key, p in expected.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected {tuple(p.shape)}")
        if p.dtype == torch.int8:
            if arr.dtype != np.int8:
                raise TypeError(f"{key}: an int8 leaf, got {arr.dtype}")
            arr = arr.copy()  # writable, as torch.from_numpy wants
        else:
            arr = arr.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.from_numpy(arr))
    return params


def flat_grads(params: nn.Module) -> dict:
    """{'a/b/c': fp32 numpy gradient} for every float leaf, under the names
    of the JAX package's `flatten_params`; a leaf with no gradient (unused by
    the loss) gives zeros, as `jax.grad` does."""
    out = {}
    for name, p in params.named_parameters():
        if p.dtype.is_floating_point:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[name.replace(".", "/")] = g.detach().float().cpu().numpy()
    return out


_ONES = {"scale", "ln1_scale", "ln2_scale", "attn_norm", "mlp_norm", "final_norm"}
_ZEROS = {"bias", "ln1_bias", "ln2_bias", "bqkv", "bo", "b1", "b2"}


def _mixed_rope_freqs(cfg, generator, device) -> torch.Tensor:
    """(depth, heads, d/2, 2): base magnitudes theta^(-4t/d), each head given
    a random planar rotation so the x and y axes mix."""
    d = cfg.head_dim
    t = torch.arange(0, d // 4, dtype=torch.float32, device=device)
    mag = 1.0 / (cfg.rope_temperature ** (t * 4.0 / d))
    ang = torch.empty((cfg.depth, cfg.num_heads, 1), device=device)
    ang.uniform_(0.0, 2 * math.pi, generator=generator)
    fx = torch.cat([mag * torch.cos(ang), mag * torch.cos(ang + math.pi / 2)], dim=-1)
    fy = torch.cat([mag * torch.sin(ang), mag * torch.sin(ang + math.pi / 2)], dim=-1)
    return torch.stack([fx, fy], dim=-1)


def init_leaf(name: str, p: torch.Tensor, cfg: GARConfig, generator: torch.Generator) -> None:
    """Fill one bf16/fp32 leaf of `GARParams` (dotted name) by the JAX
    package's init rules."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "mask_embed.kernel" or leaf in _ZEROS:
        p.zero_()
    elif leaf in _ONES:
        p.fill_(1.0)
    elif leaf in ("ls1", "ls2"):
        p.fill_(cfg.vision.init_values)
    elif leaf == "rope_freqs":
        p.copy_(_mixed_rope_freqs(cfg.vision, generator, p.device))
    else:
        w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
        p.copy_(w)


@torch.no_grad()
def init_gar_params(cfg: GARConfig, generator: torch.Generator, device="cuda",
                    dtype=torch.float32):
    """Random `GARParams` by the JAX package's init rules: truncated normal
    (std 0.02, cut at 2 std) for kernels and embeddings, ones for norm
    scales, zeros for biases, LayerScale at `init_values`, zero `mask_embed`.
    The numbers differ from jax.random's; tests load JAX params instead."""
    from ..models.gar import GARParams

    params = GARParams(cfg, device=require_device(device), dtype=dtype)
    for name, p in params.named_parameters():
        init_leaf(name, p, cfg, generator)
    return params
