"""Optimizer and schedule: AdamW, linear warm-up then cosine, global-norm
clipping, gradient accumulation, frozen leaves
(`grasp_any_region_tpu/train/optimizer.py`).

The JAX package builds it from optax:
  multi_transform({train: chain(clip_by_global_norm, adamw(schedule)),
                   freeze: set_to_zero}), inside MultiSteps when
  accumulation > 1.
This module computes the same updates with `torch._foreach_*` ops on the
trainable leaves, in place:
  * the global norm is taken over the trainable leaves' gradients; above
    `max_grad_norm` each is scaled by max_grad_norm / norm (no epsilon);
  * Adam's moments live in each parameter's dtype (bf16 parameters keep
    bf16 moments, as optax does); the update is
    mu_hat / (sqrt(nu_hat) + eps) with bias-corrected moments, plus
    weight_decay * param (decoupled), times -lr;
  * lr is the schedule at the count of updates applied so far, starting at
    0, so the first warm-up update has lr 0;
  * frozen leaves never move;
  * with accumulation k, each step folds its gradient into the running
    mean of the window (acc += (g - acc) / (n + 1)) and every k-th step
    applies the update to the mean.
The count of applied updates is a host integer (it follows from the step
count alone), so no step waits for the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
from torch import nn

ADAM_EPS = 1e-8  # optax.adamw's default, which the JAX package keeps


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-5
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    total_steps: int = 10000
    accumulation: int = 1
    freeze_llm: bool = False
    freeze_visual_encoder: bool = False
    freeze_connector: bool = False
    unfreeze_vocab: bool = True
    unfreeze_lm_head: bool = True


def trainable_mask(params: nn.Module, cfg: OptimizerConfig) -> dict:
    """{'a/b/c': True where the leaf trains}; mask_embed always trains."""

    def decide(path: str) -> bool:
        if "mask_embed" in path:
            return True
        if path.startswith("vision"):
            return not cfg.freeze_visual_encoder
        if path.startswith("projector"):
            return not cfg.freeze_connector
        if path.startswith("llm"):
            if path.endswith("embed") and cfg.unfreeze_vocab:
                return True
            if path.endswith("lm_head") and cfg.unfreeze_lm_head:
                return True
            return not cfg.freeze_llm
        return True

    return {name.replace(".", "/"): decide(name.replace(".", "/"))
            for name, _ in params.named_parameters()}


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """optax's linear_schedule(0, lr, warmup) joined to
    cosine_decay_schedule(lr, total - warmup), warmup = int(total * ratio)."""
    warmup = int(cfg.total_steps * cfg.warmup_ratio)

    def cosine(count: int, steps: int) -> float:
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))

    def schedule(count: int) -> float:
        if warmup == 0:
            return cosine(count, max(1, cfg.total_steps))
        if count < warmup:
            return cfg.lr * count / warmup
        return cosine(count - warmup, max(1, cfg.total_steps - warmup))

    return schedule


@dataclass
class OptState:
    mu: List[torch.Tensor]  # per trainable leaf, in its dtype
    nu: List[torch.Tensor]
    count: int = 0  # updates applied so far
    acc: Optional[List[torch.Tensor]] = None  # accumulation > 1: the window's mean gradient
    mini_step: int = 0  # steps folded into acc


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, on the device."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """The trainable leaves' AdamW with clipping and accumulation. `init`
    makes the state, `apply` updates the parameters in place from their
    `.grad` (a trainable leaf without one counts as a zero gradient, as in
    `jax.grad`)."""

    def __init__(self, params: nn.Module, cfg: OptimizerConfig):
        int8 = [n for n, p in params.named_parameters() if not p.dtype.is_floating_point]
        if int8:
            raise ValueError(f"an int8 tree does not train (int8 leaves {int8[:3]}...); "
                             "train the bf16 tree and quantize it after")
        mask = trainable_mask(params, cfg)
        self.cfg = cfg
        self.names = [n for n, _ in params.named_parameters() if mask[n.replace(".", "/")]]
        self.schedule = make_schedule(cfg)

    def _leaves(self, params: nn.Module) -> List[torch.Tensor]:
        named = dict(params.named_parameters())
        return [named[n] for n in self.names]

    def init(self, params: nn.Module) -> OptState:
        leaves = self._leaves(params)
        return OptState(mu=[torch.zeros_like(p) for p in leaves],
                        nu=[torch.zeros_like(p) for p in leaves],
                        acc=[torch.zeros_like(p) for p in leaves]
                        if self.cfg.accumulation > 1 else None)

    @torch.no_grad()
    def apply(self, params: nn.Module, state: OptState) -> None:
        leaves = self._leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        k = self.cfg.accumulation
        if k > 1:  # optax MultiSteps: Welford mean over the window
            diff = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, diff)
            state.mini_step = (state.mini_step + 1) % k
            if state.mini_step:
                return
            grads = state.acc
        cfg = self.cfg
        b1, b2 = cfg.betas
        norm = global_norm(grads)
        clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                           cfg.max_grad_norm / norm)
        g = torch._foreach_mul(grads, clip)
        torch._foreach_lerp_(state.mu, g, 1.0 - b1)  # mu = b1 mu + (1 - b1) g
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        del g
        state.count += 1
        upd = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        den = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        del den
        if cfg.weight_decay:
            torch._foreach_add_(upd, leaves, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(state.count - 1))
        torch._foreach_add_(leaves, upd)
        if k > 1:
            torch._foreach_zero_(state.acc)


def make_optimizer(params: nn.Module, cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(params, cfg)
