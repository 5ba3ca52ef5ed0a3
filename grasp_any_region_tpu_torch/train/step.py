"""The training step (`grasp_any_region_tpu/train/step.py`): forward under
remat, chunked CE, backward, clip, AdamW, on one card or sharded over a
multi-rank mesh (data, fsdp, tensor, seq, pipe).

Where the JAX step is one jitted function returning a new state, the port
runs eagerly and updates the parameters and the optimizer state in place,
so one copy of each lives on the card. `init_state` turns on
`requires_grad` for every float leaf (`jax.value_and_grad` differentiates
the whole tree, and `grad_norm` covers every gradient; the optimizer's
mask decides which leaves move). The step frees the frozen leaves'
gradients once `grad_norm` has read them, and each trainable one once the
update has its clipped copy: under LoRA (`OptimizerConfig.lora_only`,
`train/lora.py`) at GAR-8B the frozen base's bf16 gradients are as large as
the base itself.

On the card, attention runs the hand kernels both ways: the ViT's kernel A
with its LSE and kernel 5, the decoder's kernel B and kernels 17 and 18
(with segment ids on the packed path). Under non-reentrant checkpointing
each block's forward runs again in the backward, so A and B launch twice a
block a step.

Under a multi-rank mesh (`init_state(mesh=)`, `make_train_step(mesh=)`)
each rank holds its shards of the parameters (`parallel/sharding.
shard_params`) and AdamW's moments are `zeros_like` of the shards, so both
live only on their fsdp shards (JAX pins its moments to the parameters'
shardings, `opt_state_shardings`). Each layer's weights are gathered just
before the layer, and again in the backward under remat; the gathers'
backward reduce-scatters the gradients onto the shards. Each rank takes
its rows of the batch (`shard_batch`) and, with a seq axis, its part of
the sequence; the loss is the mean over every supervised token of the
global batch (`losses.global_mean`). After the backward the gradients are
summed over the ranks that hold other rows or tokens of the same shard
(`reduce_gradients`); one all-reduce sums each shard's squares once
(`Optimizer.sq_sums`, the optimizer made with the mesh), for `grad_norm`
and for the clipping norm. The optimizer updates the local shards.

With pipeline stages (pipe > 1, composed with data and fsdp alone) each
stage holds L / P of the decoder's layers and the rest of the tree
whole. The step runs `pipe_loss_and_grads` (JAX's `loss_and_grads_1f1b`,
and `jax.value_and_grad` of its GPipe `loss_fn`): stage 0 runs the front
(the tower, the projector, the mask embed and the lookup: the others do
not), the schedule (`pipe_schedule`, "1f1b" or "gpipe",
parallel/pipeline.py) runs the decoder and the loss head on the last
stage, and stage 0 back-propagates the embeds' gradient through the front
once. `reduce_gradients` then sums each leaf outside the blocks over the
stages as well (JAX's `_merge_pipe_grads` and shard_map's sum over the
replicated axes): the front's gradients from stage 0 and the head's from
the last stage, so that the tied embedding's gradient is its lookup's plus
its head's, and every stage's copy takes the one-process update. Which
leaves some stage holds a gradient for is read once, on the step's first
call (`pipe_grad_leaves`).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ..core.config import GARConfig
from ..core.weights import require_device
from ..models.gar import GARBatch, GARParams, build_prefill_embeds
from ..models.llama import embed_tokens, llama_prefill
from .losses import ce_sums, chunked_cross_entropy, global_mean, shift_labels
from .optimizer import OptimizerConfig, OptState, Optimizer, global_norm, make_optimizer


class TrainState(NamedTuple):
    params: GARParams
    opt_state: OptState
    step: int


def _mean_ce(params: GARParams, cfg: GARConfig, hidden: torch.Tensor, labels: torch.Tensor,
             ce_chunk: int, mesh) -> torch.Tensor:
    """The mean CE of the decoder output against the shifted labels; under
    a multi-rank mesh hidden is this rank's sequence shard and the labels,
    shifted over the whole sequence, are sliced to it."""
    if mesh is None or mesh.size == 1:
        return chunked_cross_entropy(params.llm, cfg.text, hidden, labels,
                                     valid_vocab=cfg.extended_vocab_size, chunk_size=ce_chunk)
    from ..parallel.sharding import constrain_seq

    total, count = ce_sums(params.llm, cfg.text, hidden, constrain_seq(labels, mesh),
                           chunk_size=ce_chunk, valid_vocab=cfg.extended_vocab_size, mesh=mesh)
    return global_mean(total, count, mesh)


def _pipe(mesh) -> bool:
    return mesh is not None and mesh.shape["pipe"] > 1


def _pipe_loss_value(params: GARParams, cfg: GARConfig, front: Callable, positions, labels,
                     segment_ids, right_padded: bool, ce_chunk: int, dtype, mesh):
    """The loss under a pipe mesh, the value alone: `pipeline_prefill`'s
    hidden, broadcast to every stage, through the CE (stage 0 runs the
    front); no gradient crosses the stages (the step takes
    `pipe_loss_and_grads`)."""
    from ..parallel.pipeline import pipeline_prefill

    with torch.no_grad():
        embeds = front(params) if mesh.coords["pipe"] == 0 else None
        hidden = pipeline_prefill(params.llm, cfg.text, embeds, positions, mesh,
                                  segment_ids=segment_ids, right_padded=right_padded,
                                  dtype=dtype)
        return _mean_ce(params, cfg, hidden, shift_labels(labels), ce_chunk, mesh)


def _front(params: GARParams, cfg: GARConfig, batch: GARBatch, mask_compat: bool,
           vit_remat_group: int, compute_dtype, mesh) -> torch.Tensor:
    return build_prefill_embeds(params, cfg, batch, mask_compat=mask_compat, remat=True,
                                remat_group=vit_remat_group, compute_dtype=compute_dtype,
                                mesh=mesh)


def loss_fn(params: GARParams, cfg: GARConfig, batch: GARBatch, labels: torch.Tensor, *,
            mask_compat: bool = True, ce_chunk: int = 1024, vit_remat_group: int = 1,
            compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """Mean next-token CE of one multimodal batch, everything under remat.
    compute_dtype is bf16 as in JAX; the fp32 parity tests pass float32.
    mesh: a multi-rank mesh, params the sharded tree, batch and labels this
    rank's rows (`shard_batch`); the value is the global mean on every
    rank, its gradient this rank's part. Under pipeline stages the value
    alone (`pipe_loss_and_grads` gives the gradients)."""
    def front(p):
        return _front(p, cfg, batch, mask_compat, vit_remat_group, compute_dtype, mesh)

    if _pipe(mesh):
        return _pipe_loss_value(params, cfg, front, batch.positions, labels, batch.segment_ids,
                                True, ce_chunk, compute_dtype, mesh)
    hidden, _ = llama_prefill(params.llm, cfg.text, front(params), batch.positions,
                              segment_ids=batch.segment_ids, remat=True, return_kv=False,
                              mesh=mesh)
    return _mean_ce(params, cfg, hidden, shift_labels(labels), ce_chunk, mesh)


def packed_loss_fn(params: GARParams, cfg: GARConfig, packed,
                   compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """Mean CE over packed text-only rows (`data/builders.PackedTextBatch`):
    the decoder alone, with the block-diagonal segment mask in the kernel
    (right_padded=False) and per-document positions. mesh: `loss_fn`'s."""
    def front(p):
        return embed_tokens(p.llm, packed.input_ids, compute_dtype, mesh=mesh)

    if _pipe(mesh):
        return _pipe_loss_value(params, cfg, front, packed.positions, packed.labels,
                                packed.segment_ids, False, 1024, compute_dtype, mesh)
    hidden, _ = llama_prefill(params.llm, cfg.text, front(params), packed.positions,
                              segment_ids=packed.segment_ids, remat=True, right_padded=False,
                              return_kv=False, mesh=mesh)
    return _mean_ce(params, cfg, hidden, shift_labels(packed.labels), 1024, mesh)


def _pipe_backward(params: GARParams, cfg: GARConfig, front: Callable, positions, labels,
                   segment_ids, right_padded: bool, *, schedule: str, n_micro, ce_chunk: int,
                   dtype, mesh) -> torch.Tensor:
    from ..parallel.pipeline import pipeline_train

    embeds = front(params) if mesh.coords["pipe"] == 0 else None
    loss, _, d_embeds = pipeline_train(
        params.llm, cfg.text, None if embeds is None else embeds.detach(), positions, labels,
        mesh, schedule=schedule, n_micro=n_micro, segment_ids=segment_ids,
        right_padded=right_padded, valid_vocab=cfg.extended_vocab_size, ce_chunk=ce_chunk,
        dtype=dtype)
    if embeds is not None and embeds.requires_grad:
        embeds.backward(d_embeds)
    return loss


def pipe_loss_and_grads(params: GARParams, cfg: GARConfig, batch: GARBatch,
                        labels: torch.Tensor, *, mesh, schedule: str = "1f1b",
                        mask_compat: bool = True, ce_chunk: int = 1024,
                        vit_remat_group: int = 1, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """`loss_fn`'s value with its backward done, under pipeline stages
    (JAX's `loss_and_grads_1f1b` with schedule "1f1b", its GPipe
    `value_and_grad(loss_fn)` with "gpipe"): the loss on every rank, this
    rank's gradients in `.grad` (before `reduce_gradients`); one row of the
    global batch a microbatch, as JAX's default."""
    def front(p):
        return _front(p, cfg, batch, mask_compat, vit_remat_group, compute_dtype, mesh)

    return _pipe_backward(params, cfg, front, batch.positions, labels, batch.segment_ids, True,
                          schedule=schedule, n_micro=None, ce_chunk=ce_chunk,
                          dtype=compute_dtype, mesh=mesh)


def packed_pipe_loss_and_grads(params: GARParams, cfg: GARConfig, packed, *, mesh,
                               schedule: str = "1f1b", n_micro=None,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """`pipe_loss_and_grads` of `packed_loss_fn` (JAX's
    `packed_loss_and_grads_1f1b`); n_micro: microbatches of the global
    batch (default one row each)."""
    def front(p):
        return embed_tokens(p.llm, packed.input_ids, compute_dtype, mesh=mesh)

    return _pipe_backward(params, cfg, front, packed.positions, packed.labels,
                          packed.segment_ids, False, schedule=schedule, n_micro=n_micro,
                          ce_chunk=1024, dtype=compute_dtype, mesh=mesh)


def init_state(params: GARParams, opt_cfg: OptimizerConfig, *, device="cuda", mesh=None):
    """(TrainState, optimizer) for `params`, moved to `device` (the card
    unless the caller asks for the CPU; no card raises) and made
    differentiable in place. Raises on an int8 tree.

    mesh: a multi-rank mesh (JAX's `init_sharded_state`): the state holds
    this rank's shards on `mesh.device` (`params` is left as it is), the
    moments shards of the same shapes, and the optimizer, made with the
    mesh, sums the shards' squares over the ranks."""
    if mesh is not None and mesh.size > 1:
        from ..parallel.sharding import shard_params

        params = shard_params(params, mesh)
    else:
        params = params.to(require_device(device))
    tx = make_optimizer(params, opt_cfg, mesh)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def shard_batch(batch: GARBatch, labels: torch.Tensor, mesh):
    """This rank's rows of a whole batch and its labels: the batch axis over
    (data, fsdp), as JAX's `shard_batch` places it (a multi-process trainer
    loads only its rows instead)."""
    from ..models.gar import map_batch
    from ..parallel.sharding import shard_rows

    dp = mesh.axis_size(("data", "fsdp"))
    if labels.shape[0] % dp:
        raise ValueError(f"batch {labels.shape[0]} does not divide data * fsdp = {dp}")
    return (map_batch(lambda x: shard_rows(x, ("data", "fsdp"), mesh), batch),
            shard_rows(labels, ("data", "fsdp"), mesh))


@torch.no_grad()
def pipe_grad_leaves(params: GARParams, mesh) -> List[bool]:
    """[whether some stage holds a gradient for the leaf] for each leaf of
    `params`, over the pipe group (one all-reduce and a host read). Fixed for
    a step function: the front's leaves on stage 0, the final norm and the
    head on the last stage, the blocks on every stage; so the step takes it
    once, on its first call."""
    from ..parallel.collectives import all_reduce

    has = torch.tensor([float(p.grad is not None) for p in params.parameters()],
                       device=mesh.device)
    has = all_reduce(has, mesh.group("pipe"), torch.distributed.ReduceOp.MAX)
    return [h > 0 for h in has.tolist()]


@torch.no_grad()
def reduce_gradients(params: GARParams, mesh, shared: Optional[List[bool]] = None) -> None:
    """Sum each shard's gradient over the ranks holding the same shard of
    other rows or tokens: over (data, seq) for fsdp-sharded leaves (their
    gathers' backward summed over fsdp already), over (data, fsdp, seq) for
    the rest; and, under pipeline stages, each leaf outside the blocks over
    the stages too: a leaf with a gradient on some stage (`shared`, from
    `pipe_grad_leaves` where not given) gets zeros where it has none. One
    flat all-reduce a group and dtype."""
    from ..parallel.collectives import all_reduce
    from ..parallel.sharding import spec_axes

    if mesh.group("pipe") is not None:
        if shared is None:
            shared = pipe_grad_leaves(params, mesh)
        for (name, p), h in zip(params.named_parameters(), shared):
            if h and p.grad is None:
                p.grad = torch.zeros_like(p)
            elif p.grad is not None and not h:
                raise RuntimeError(f"{name} has a gradient that no stage had on the step "
                                   "function's first call")
    buckets = {}
    for p in params.parameters():
        if p.grad is None:
            continue
        axes = ("data", "seq") if "fsdp" in spec_axes(p.spec) else ("data", "fsdp", "seq")
        if "pipe" not in spec_axes(p.spec):
            axes += ("pipe",)
        if mesh.group(axes) is not None:
            buckets.setdefault((axes, p.grad.dtype), []).append(p)
    for (axes, _), ps in buckets.items():
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in ps]), mesh.group(axes))
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def _backward(loss: torch.Tensor) -> torch.Tensor:
    loss.backward()
    return loss


def _step_with(loss_and_grads: Callable, tx: Optimizer, device, mesh=None) -> Callable:
    multi = mesh is not None and mesh.size > 1
    device = mesh.device if multi else require_device(device)
    shared = []  # under pipeline stages: `pipe_grad_leaves`, taken on the first call

    def step(state: TrainState, *inputs):
        params = state.params
        if params.llm.final_norm.device.type != device.type:
            raise ValueError(f"the state lives on {params.llm.final_norm.device}, the step "
                             f"was made for {device}")
        for p in params.parameters():
            p.grad = None
        loss = loss_and_grads(params, *inputs)
        if multi:
            if _pipe(mesh) and not shared:
                shared.append(pipe_grad_leaves(params, mesh))
            reduce_gradients(params, mesh, shared[0] if shared else None)
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        sq = None
        if multi:  # one reduction serves the metric and the clipping norm
            names = [n for n, p in params.named_parameters() if p.grad is not None]
            sq = dict(zip(names, tx.sq_sums(names, grads)))
            gnorm = torch.sqrt(torch.stack(list(sq.values())).sum())
        else:
            gnorm = global_norm(grads)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        del grads
        tx.free_frozen_grads(params)  # they served the metric alone
        tx.apply(params, state.opt_state, sq)
        for p in params.parameters():
            p.grad = None
        return state._replace(step=state.step + 1), metrics

    return step


def make_train_step(cfg: GARConfig, tx: Optimizer, *, mask_compat: bool = True,
                    ce_chunk: int = 1024, vit_remat_group: int = 1, device="cuda",
                    compute_dtype=torch.bfloat16, mesh=None, pipe_schedule: str = "1f1b"):
    """step(state, batch, labels) -> (state, {"loss", "grad_norm"}), both
    metrics 0-dim tensors on the device; grad_norm is over all gradients.
    compute_dtype: `loss_fn`'s (bf16, as in JAX). mesh: the sharded step
    (the state from `init_state(mesh=)`, this rank's rows of the batch);
    the metrics are global. pipe_schedule ("1f1b", or "gpipe", which keeps
    every microbatch's graph across the turn: the same launches and bubble
    at a higher peak): the pipeline's, where the mesh has pipeline stages;
    `pipeline_train` checks the name."""
    if _pipe(mesh):
        def loss_and_grads(p, batch, labels):
            return pipe_loss_and_grads(p, cfg, batch, labels, mesh=mesh, schedule=pipe_schedule,
                                       mask_compat=mask_compat, ce_chunk=ce_chunk,
                                       vit_remat_group=vit_remat_group,
                                       compute_dtype=compute_dtype)
    else:
        def loss_and_grads(p, batch, labels):
            return _backward(loss_fn(p, cfg, batch, labels, mask_compat=mask_compat,
                                     ce_chunk=ce_chunk, vit_remat_group=vit_remat_group,
                                     compute_dtype=compute_dtype, mesh=mesh))
    return _step_with(loss_and_grads, tx, device, mesh)


def make_packed_train_step(cfg: GARConfig, tx: Optimizer, *, device="cuda",
                           compute_dtype=torch.bfloat16, mesh=None, pipe_schedule: str = "1f1b"):
    """step(state, packed) -> (state, metrics) over `PackedTextBatch` rows.
    The packed path never touches the vision tower: its gradients are zero.
    pipe_schedule: `make_train_step`'s."""
    if _pipe(mesh):
        def loss_and_grads(p, packed):
            return packed_pipe_loss_and_grads(p, cfg, packed, mesh=mesh, schedule=pipe_schedule,
                                              compute_dtype=compute_dtype)
    else:
        def loss_and_grads(p, packed):
            return _backward(packed_loss_fn(p, cfg, packed, compute_dtype, mesh))
    return _step_with(loss_and_grads, tx, device, mesh)


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
