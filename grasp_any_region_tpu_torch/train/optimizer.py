"""Optimizer and schedule: AdamW, linear warm-up then cosine, global-norm
clipping, gradient accumulation, frozen leaves
(`grasp_any_region_tpu/train/optimizer.py`).

The JAX package builds it from optax:
  multi_transform({train: chain(clip_by_global_norm, adamw(schedule)),
                   freeze: set_to_zero}), inside MultiSteps when
  accumulation > 1.
This module computes the same updates with `torch._foreach_*` ops on the
trainable leaves, in place, in optax's order of operations and at the
leaves' own dtype, so bf16 parameters round where optax rounds them:
  * the global norm: each leaf's sum of squares (fp32 sums) in the leaf's
    dtype, added up in that dtype in the tree's (sorted) order, its square
    root; where it reaches `max_grad_norm`, each gradient becomes
    (g / norm) * max_grad_norm, the norm in g's dtype (no epsilon);
  * Adam's moments live in each parameter's dtype (bf16 parameters keep
    bf16 moments, as optax does): mu = (1 - b1) g + b1 mu and nu =
    (1 - b2) g^2 + b2 nu, each product and sum rounded on its own; the
    update mu_hat / (sqrt(nu_hat) + eps), the bias corrections
    1 - b^count taken in fp32 and rounded to the moment's dtype, plus
    weight_decay * param (decoupled), times -lr rounded to the dtype;
  * Python constants enter rounded to the leaves' dtype, as JAX rounds a
    weak-typed float that multiplies a bf16 array (1 - b1 = 0.1 becomes
    0.10009766, b1 = 0.9 becomes 0.8984375). One departure: b2 multiplies
    nu unrounded, where optax's bf16 b2 = 0.999 is 1.0 (a defect of the
    reference, ROADMAP section 3). In bf16 it changes no bit: 0.001 of nu
    is under half a bf16 ulp, so bf16(0.999 nu) is nu, and bf16 moments
    do not decay either way; in fp32 both are 0.999.
  * lr is the schedule at the count of updates applied so far, starting at
    0, so the first warm-up update has lr 0;
  * frozen leaves never move;
  * with accumulation k, each step folds its gradient into the running
    mean of the window (acc += (g - acc) / (n + 1)) and every k-th step
    applies the update to the mean.
The count of applied updates is a host integer (it follows from the step
count alone), so no step waits for the card. At bf16 the parameters equal
optax's under jax.jit on the CPU bit for bit after one update at the
default betas and three clipped updates with weight decay
(tests/test_torch_train.py); the frameworks' fp32 sums (the norm) and
powers (the bias corrections) may differ in their last bits, which can
move a bf16 rounding now and then.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
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
    lora_only: bool = False  # train only the LoRA adapters (+ embeds, lm_head,
    # mask_embed: `train/lora.lora_trainable_mask`), the reference's llm_lora regime


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
    `jax.grad`) and frees each `.grad` once its clipped copy is made;
    `free_frozen_grads` frees the others' (a step's metric has read them)."""

    def __init__(self, params: nn.Module, cfg: OptimizerConfig, mesh=None):
        int8 = [n for n, p in params.named_parameters() if not p.dtype.is_floating_point]
        if int8:
            raise ValueError(f"an int8 tree does not train (int8 leaves {int8[:3]}...); "
                             "train the bf16 tree and quantize it after")
        if cfg.lora_only:  # embeddings follow unfreeze_vocab, lm_head too, as in JAX
            from .lora import lora_trainable_mask

            mask = lora_trainable_mask(params, train_embeddings=cfg.unfreeze_vocab)
        else:
            mask = trainable_mask(params, cfg)
        self.cfg = cfg
        self.names = [n for n, _ in params.named_parameters() if mask[n.replace(".", "/")]]
        # the leaves in JAX's tree order: its dicts flatten in sorted key order
        self.order = sorted(range(len(self.names)),
                            key=lambda i: self.names[i].replace(".", "/").split("/"))
        self.schedule = make_schedule(cfg)
        # under a multi-rank mesh the leaves are shards (parallel/sharding):
        # a sum over a whole leaf counts each shard once, on the first rank
        # along every axis its spec does not shard over (`sq_sums`)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._owned: Dict[str, float] = {}
        self._owned_rows: Dict[Tuple[str, ...], torch.Tensor] = {}
        if self.mesh is not None:
            from ..parallel.sharding import spec_axes

            self._owned = {n: float(all(mesh.coords[a] == 0 for a in mesh.axis_names
                                        if a not in spec_axes(p.spec)))
                           for n, p in params.named_parameters()}

    def _leaves(self, params: nn.Module) -> List[torch.Tensor]:
        named = dict(params.named_parameters())
        return [named[n] for n in self.names]

    def free_frozen_grads(self, params: nn.Module) -> None:
        trained = set(self.names)
        for name, p in params.named_parameters():
            if name not in trained:
                p.grad = None

    def init(self, params: nn.Module) -> OptState:
        leaves = self._leaves(params)
        return OptState(mu=[torch.zeros_like(p) for p in leaves],
                        nu=[torch.zeros_like(p) for p in leaves],
                        acc=[torch.zeros_like(p) for p in leaves]
                        if self.cfg.accumulation > 1 else None)

    def sq_sums(self, names: List[str], tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-leaf fp32 sums of squares of `tensors` (of the leaves `names`);
        under a multi-rank mesh the sums over the whole leaves, each shard
        counted once (a replicated leaf once, not once a rank): one
        all-reduce over every rank."""
        sq = [s * s for s in torch._foreach_norm(tensors, 2, dtype=torch.float32)]
        if self.mesh is None:
            return sq
        from ..parallel.collectives import all_reduce

        key = tuple(names)
        if key not in self._owned_rows:
            self._owned_rows[key] = torch.tensor([self._owned[n] for n in names],
                                                 device=tensors[0].device)
        return list(all_reduce(torch.stack(sq) * self._owned_rows[key],
                               self.mesh.group(self.mesh.axis_names)).unbind())

    @torch.no_grad()
    def apply(self, params: nn.Module, state: OptState,
              sq: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """sq: {name: `sq_sums` of its gradient} where the step has them
        (a sharded step, for its metric); without an accumulation window
        the clipping norm takes them instead of reducing again."""
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
            grads = list(state.acc)
        cfg = self.cfg
        b1, b2 = cfg.betas
        if sq is not None and k == 1:
            zero = torch.zeros((), device=grads[0].device)
            sq = [sq.get(n, zero) for n in self.names]
        else:
            sq = None
        norm = self._global_norm(grads, sq)
        lr = -self.schedule(state.count)
        state.count += 1
        # optax's bias corrections: 1 - b ** count in fp32, rounded to the moments' dtype
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(state.count))
                    for b in (b1, b2))
        unclipped = norm < cfg.max_grad_norm
        for dtype, idx in self._by_dtype(leaves).items():
            def c(value: float) -> float:
                return _in_dtype(value, dtype)

            ps = [leaves[i] for i in idx]
            mu, nu = [state.mu[i] for i in idx], [state.nu[i] for i in idx]
            # clip: where the norm reaches max_norm, (g / norm) * max_norm in g's dtype
            one = torch.ones((), dtype=dtype, device=norm.device)
            g = torch._foreach_div([grads[i] for i in idx],
                                   torch.where(unclipped, one, norm.to(dtype)))
            for i in idx:  # the clipped copies are made: free each gradient now
                grads[i] = leaves[i].grad = None
            if cfg.max_grad_norm != 1.0:
                torch._foreach_mul_(g, torch.where(unclipped, one, one * cfg.max_grad_norm))
            torch._foreach_mul_(mu, c(b1))  # mu = (1 - b1) g + b1 mu, each op rounded
            torch._foreach_add_(mu, torch._foreach_mul(g, c(1.0 - b1)))
            sq = torch._foreach_mul(g, g)  # nu = (1 - b2) g^2 + b2 nu
            del g
            torch._foreach_mul_(sq, c(1.0 - b2))
            torch._foreach_mul_(nu, b2)  # b2 unrounded: the one departure
            torch._foreach_add_(nu, sq)
            del sq
            upd = torch._foreach_div(mu, c(bc1))
            den = torch._foreach_div(nu, c(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c(ADAM_EPS))
            torch._foreach_div_(upd, den)
            del den
            if cfg.weight_decay:
                torch._foreach_add_(upd, torch._foreach_mul(ps, c(cfg.weight_decay)))
            torch._foreach_mul_(upd, c(lr))
            torch._foreach_add_(ps, upd)
        if k > 1:
            torch._foreach_zero_(state.acc)

    def _global_norm(self, grads: List[torch.Tensor],
                     sq: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """optax's global norm: each leaf's sum of squares (`sq_sums`, or
        sq given) rounded to its dtype, added up in the tree's order (the
        sorted leaf paths) in that dtype, then the square root."""
        if sq is None:
            sq = self.sq_sums(self.names, grads)
        total = None
        for i in self.order:
            s = sq[i].to(grads[i].dtype)
            total = s if total is None else total + s
        return torch.sqrt(total)

    @staticmethod
    def _by_dtype(leaves: List[torch.Tensor]) -> dict:
        groups: dict = {}
        for i, p in enumerate(leaves):
            groups.setdefault(p.dtype, []).append(i)
        return groups


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """value as JAX uses a Python float against an array of `dtype`:
    rounded to that dtype."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).item()


def make_optimizer(params: nn.Module, cfg: OptimizerConfig, mesh=None) -> Optimizer:
    return Optimizer(params, cfg, mesh)
