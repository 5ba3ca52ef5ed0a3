"""LoRA adapters for the decoder (`grasp_any_region_tpu/train/lora.py`).

The reference's `llm_lora` regime: low-rank adapters beside the stacked
decoder weights, as (L, Din, r) A and (L, r, Dout) B leaves named
`llm/blocks/{target}_lora_a|b`, plus the fp32 scalar `llm/lora_scaling`
(alpha / rank). `llama_prefill` adds s * (x @ A) @ B to each target's
product whenever `lora_scaling` is present; the decode steps refuse such a
tree, as JAX merges the adapters into the base weights before inference
(`merge_lora`).

The trees are `GARParams` modules with the JAX package's leaf names:
`add_lora_params` and `merge_lora` return a new module that shares every
tensor it does not change with its input (as JAX's `dict(params)` copies
share leaves). Adapters and the scaling are fp32 whatever the base's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from ..core.config import TextConfig
from ..models.gar import GARParams
from ..models.quantize import _leaf, _node

# decoder matmuls eligible for adaptation, with their (din, dout) extents
TARGET_DIMS = {
    "wq": ("hidden", "q"),
    "wk": ("hidden", "kv"),
    "wv": ("hidden", "kv"),
    "wo": ("q", "hidden"),
    "w_gate": ("hidden", "mlp"),
    "w_up": ("hidden", "mlp"),
    "w_down": ("mlp", "hidden"),
}


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def lora_shapes(text_cfg: TextConfig, targets, rank: int) -> dict:
    """{'{t}_lora_a': (L, Din, r), '{t}_lora_b': (L, r, Dout)} for each target."""
    dims = {"hidden": text_cfg.hidden_size, "q": text_cfg.num_heads * text_cfg.head_dim,
            "kv": text_cfg.num_kv_heads * text_cfg.head_dim,
            "mlp": text_cfg.intermediate_size}
    shapes = {}
    for t in targets:
        if t not in TARGET_DIMS:
            raise KeyError(f"unknown LoRA target {t}")
        din, dout = (dims[x] for x in TARGET_DIMS[t])
        shapes[f"{t}_lora_a"] = (text_cfg.num_layers, din, rank)
        shapes[f"{t}_lora_b"] = (text_cfg.num_layers, rank, dout)
    return shapes


@torch.no_grad()
def add_lora_params(params: GARParams, text_cfg: TextConfig, lora_cfg: LoRAConfig,
                    generator: torch.Generator) -> GARParams:
    """params with the adapters added on its device: A ~ N(0, 1/r) from
    `generator` (drawn on the generator's device, target by target in
    lora_cfg's order), B = 0, so the adapted model starts exactly at the
    base model (peft's convention); `llm.lora_scaling` = alpha / rank."""
    out, llm, blocks = _node(params), _node(params.llm), _node(params.llm.blocks)
    device = params.llm.final_norm.device
    for name, shape in lora_shapes(text_cfg, lora_cfg.targets, lora_cfg.rank).items():
        if name.endswith("_a"):
            a = torch.randn(shape, generator=generator, device=generator.device)
            value = (a / lora_cfg.rank ** 0.5).to(device)
        else:
            value = torch.zeros(shape, device=device)
        setattr(blocks, name, _leaf(value))
    llm.blocks = blocks
    llm.lora_scaling = _leaf(torch.tensor(lora_cfg.scaling, dtype=torch.float32, device=device))
    out.llm = llm
    return out


def lora_delta(bp: dict, name: str, x: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """(x @ A) @ B in x's dtype, times the fp32 scaling (so the product is
    fp32, as JAX promotes a bf16 array times an fp32 leaf), for one layer's
    views; the caller casts it to its output's dtype."""
    a, b = bp[f"{name}_lora_a"], bp[f"{name}_lora_b"]
    return ((x @ a.to(x.dtype)) @ b.to(x.dtype)).float() * scaling


@torch.no_grad()
def merge_lora(params: GARParams, lora_cfg: LoRAConfig) -> GARParams:
    """Fold the adapters into the base weights, W += s * A @ B in fp32 cast
    back to W's dtype, s = lora_cfg.scaling, and drop them and the scaling
    leaf: what the decode steps (and an export) need. One layer at a time,
    so the fp32 temporaries are one layer's."""
    out, llm, blocks = _node(params), _node(params.llm), _node(params.llm.blocks)
    for t in lora_cfg.targets:
        if not hasattr(blocks, f"{t}_lora_a"):
            continue
        a, b = getattr(blocks, f"{t}_lora_a"), getattr(blocks, f"{t}_lora_b")
        delattr(blocks, f"{t}_lora_a")
        delattr(blocks, f"{t}_lora_b")
        w = getattr(blocks, t)
        merged = torch.empty_like(w)
        for i in range(w.shape[0]):
            delta = (a[i].float() @ b[i].float()) * lora_cfg.scaling
            merged[i] = (w[i].float() + delta).to(w.dtype)
        setattr(blocks, t, _leaf(merged))
    llm.blocks = blocks
    if hasattr(llm, "lora_scaling"):
        delattr(llm, "lora_scaling")
    out.llm = llm
    return out


def lora_trainable_mask(params: nn.Module, *, train_embeddings: bool = True) -> dict:
    """{'a/b/c': True where the leaf trains} of the reference's LoRA regime,
    JAX's rule by flat path: the adapters and the always-new mask embed,
    and with train_embeddings every path ending in `embed` or `lm_head`
    (so `vision/pos_embed` trains too, and `vision/patch_embed/kernel` does
    not: a rule of the reference's that the port copies)."""

    def decide(path: str) -> bool:
        if "_lora_" in path or "mask_embed" in path:
            return True
        return train_embeddings and (path.endswith("embed") or path.endswith("lm_head"))

    return {name.replace(".", "/"): decide(name.replace(".", "/"))
            for name, _ in params.named_parameters()}
