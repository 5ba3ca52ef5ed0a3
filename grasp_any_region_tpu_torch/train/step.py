"""The single-card training step (`grasp_any_region_tpu/train/step.py`,
its `mesh=None` case): forward under remat, chunked CE, backward, clip,
AdamW.

Where the JAX step is one jitted function returning a new state, the port
runs eagerly and updates the parameters and the optimizer state in place,
so one copy of each lives on the card. `init_state` turns on
`requires_grad` for every float leaf (`jax.value_and_grad` differentiates
the whole tree; the optimizer's mask decides which leaves move), and the
step frees the gradients after the update.

On the card, attention runs the hand kernels both ways: the ViT's kernel A
with its LSE and kernel 5, the decoder's kernel B and kernels 17 and 18
(with segment ids on the packed path). Under non-reentrant checkpointing
each block's forward runs again in the backward, so A and B launch twice a
block a step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.config import GARConfig
from ..core.weights import require_device
from ..models.gar import GARBatch, GARParams, build_prefill_embeds
from ..models.llama import embed_tokens, llama_prefill
from .losses import chunked_cross_entropy, shift_labels
from .optimizer import OptimizerConfig, OptState, Optimizer, global_norm, make_optimizer


class TrainState(NamedTuple):
    params: GARParams
    opt_state: OptState
    step: int


def loss_fn(params: GARParams, cfg: GARConfig, batch: GARBatch, labels: torch.Tensor, *,
            mask_compat: bool = True, ce_chunk: int = 1024, vit_remat_group: int = 1,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean next-token CE of one multimodal batch, everything under remat.
    compute_dtype is bf16 as in JAX; the fp32 parity tests pass float32."""
    embeds = build_prefill_embeds(params, cfg, batch, mask_compat=mask_compat, remat=True,
                                  remat_group=vit_remat_group, compute_dtype=compute_dtype)
    hidden, _ = llama_prefill(params.llm, cfg.text, embeds, batch.positions,
                              segment_ids=batch.segment_ids, remat=True, return_kv=False)
    return chunked_cross_entropy(params.llm, cfg.text, hidden, shift_labels(labels),
                                 valid_vocab=cfg.extended_vocab_size, chunk_size=ce_chunk)


def packed_loss_fn(params: GARParams, cfg: GARConfig, packed,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean CE over packed text-only rows (`data/builders.PackedTextBatch`):
    the decoder alone, with the block-diagonal segment mask in the kernel
    (right_padded=False) and per-document positions."""
    embeds = embed_tokens(params.llm, packed.input_ids, compute_dtype)
    hidden, _ = llama_prefill(params.llm, cfg.text, embeds, packed.positions,
                              segment_ids=packed.segment_ids, remat=True, right_padded=False,
                              return_kv=False)
    return chunked_cross_entropy(params.llm, cfg.text, hidden, shift_labels(packed.labels),
                                 valid_vocab=cfg.extended_vocab_size)


def init_state(params: GARParams, opt_cfg: OptimizerConfig, *, device="cuda"):
    """(TrainState, optimizer) for `params`, moved to `device` (the card
    unless the caller asks for the CPU; no card raises) and made
    differentiable in place. Raises on an int8 tree."""
    params = params.to(require_device(device))
    tx = make_optimizer(params, opt_cfg)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def _step_with(loss_of: Callable, tx: Optimizer, device) -> Callable:
    device = require_device(device)

    def step(state: TrainState, *inputs):
        params = state.params
        if params.llm.final_norm.device.type != device.type:
            raise ValueError(f"the state lives on {params.llm.final_norm.device}, the step "
                             f"was made for {device}")
        for p in params.parameters():
            p.grad = None
        loss = loss_of(params, *inputs)
        loss.backward()
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        tx.apply(params, state.opt_state)
        for p in params.parameters():
            p.grad = None
        return state._replace(step=state.step + 1), metrics

    return step


def make_train_step(cfg: GARConfig, tx: Optimizer, *, mask_compat: bool = True,
                    ce_chunk: int = 1024, vit_remat_group: int = 1, device="cuda",
                    compute_dtype=torch.bfloat16):
    """step(state, batch, labels) -> (state, {"loss", "grad_norm"}), both
    metrics 0-dim tensors on the device; grad_norm is over all gradients.
    compute_dtype: `loss_fn`'s (bf16, as in JAX)."""
    return _step_with(
        lambda p, batch, labels: loss_fn(p, cfg, batch, labels, mask_compat=mask_compat,
                                         ce_chunk=ce_chunk, vit_remat_group=vit_remat_group,
                                         compute_dtype=compute_dtype),
        tx, device)


def make_packed_train_step(cfg: GARConfig, tx: Optimizer, *, device="cuda",
                           compute_dtype=torch.bfloat16):
    """step(state, packed) -> (state, metrics) over `PackedTextBatch` rows.
    The packed path never touches the vision tower: its gradients are zero."""
    return _step_with(lambda p, packed: packed_loss_fn(p, cfg, packed, compute_dtype), tx,
                      device)


def make_train_loop(cfg: GARConfig, tx: Optimizer, n_steps: int, *, mask_compat: bool = True,
                    ce_chunk: int = 1024, vit_remat_group: int = 1, device="cuda"):
    """loop(state, batch, labels) -> (state, losses (n_steps,)): n_steps
    steps on the same batch (a benchmark harness, as in JAX), the losses
    kept on the device and the card synchronised once, at the end."""
    step = make_train_step(cfg, tx, mask_compat=mask_compat, ce_chunk=ce_chunk,
                           vit_remat_group=vit_remat_group, device=device)

    def loop(state: TrainState, batch: GARBatch, labels: torch.Tensor):
        losses = []
        for _ in range(n_steps):
            state, metrics = step(state, batch, labels)
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        if losses.device.type == "cuda":
            torch.cuda.synchronize(losses.device)
        return state, losses

    return loop
