"""Pipeline parallelism for the decoder: GPipe and 1F1B over the mesh's
'pipe' axis (`grasp_any_region_tpu/parallel/pipeline.py`).

The stacked layer dim of the decoder's blocks shards over 'pipe'
(`sharding.param_pspecs(pipe=True)`): stage s holds layers [s L/P,
(s + 1) L/P) and runs them through `models/llama.prefill_layer`, the layer
of the one-rank prefill (with its LoRA terms and segment ids), each layer
checkpointed under remat. The batch splits into n_micro microbatches;
activations go from stage s to s + 1 and their gradients back from s + 1
to s, one tick at a time, all of a tick's traffic posted at once
(`collectives.send_recv`).

JAX runs one shard_map over the stages and gets GPipe's backward by
differentiating through its forward scan. Autograd does not cross
processes, so here both training schedules are tables of (stage, tick) ->
the forward or the backward of a microbatch, run by one runner (`_run`):

  * GPipe: all M forwards in M + P - 1 ticks, then all M backwards in as
    many, the last microbatch first, as the scan's transpose runs them; a
    stage keeps M microbatches' graphs (under remat its layers' inputs)
    across the turn;
  * 1F1B: JAX's half-tick table over 2M + 2P - 2 ticks: stage s forwards
    microbatch f = (h - s) / 2 and backwards b = (h - (2P - 1 - s)) / 2
    where those are whole numbers in [0, M); stage s keeps at most P - s
    graphs, whatever M. The bubble is (P - 1) / (M + P - 1) in both.

Both run the same launches; the train step defaults to 1F1B, whose peak
memory is the lower. GPipe is the order JAX's differentiated forward
takes, kept to hold the two against each other.

A forward keeps its autograd graph until the microbatch's backward, where
JAX's 1F1B keeps the stage's input alone and runs the forward again under
its vjp: under remat the port runs a stage's layers twice a microbatch in
both schedules, JAX's 1F1B three times.

The loss is JAX's: the last stage runs the final norm and the chunked CE
head on each microbatch it retires, and divides each microbatch's NLL sum
by the global count of supervised tokens, taken from the labels before
any compute, so that the loss is the global mean `chunked_cross_entropy`
takes. Only the last stage holds head gradients (JAX carries a (V, D) head
gradient on every stage and adds zeros to it, its pipeline.py:370). Stage
0 returns the gradient of the embeds it injected; the front that made
them (the vision tower, the projector, the lookup) runs on stage 0 alone
and takes it in one backward (train/step.py).

Composition: the data and fsdp ranks of one stage each run the pipeline
over their own rows (whole microbatches of the global batch, divided over
them); tensor and seq must be 1. The gradients a schedule leaves are this
rank's part: the train step sums them over the ranks that hold other rows,
and each leaf outside the blocks over the stages too
(`train/step.reduce_gradients`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..core.config import TextConfig
from ..core.mesh import Mesh, MeshSpec, make_mesh
from ..models.llama import LlamaParams, prefill_layer
from .collectives import all_reduce, broadcast, send_recv

__all__ = ["make_pipeline_mesh", "pipeline_bubble_fraction", "pipeline_prefill", "pipeline_train",
           "SCHEDULES"]


def make_pipeline_mesh(n_stages: int, device=None) -> Mesh:
    """A mesh of one 'pipe' axis over the initialised world's n_stages ranks."""
    return make_mesh(MeshSpec(pipe=n_stages), device=device)


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe (and 1F1B) schedule: (P-1)/(M+P-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _pipe_layout(mesh, cfg: TextConfig, batch: int, n_micro: Optional[int]):
    """(stages, data * fsdp, n_micro, rows of a microbatch) for `batch`
    rows of the global batch, with JAX's checks and messages. mesh: anything
    with JAX's `.shape` {axis: size}."""
    n_stages = mesh.shape["pipe"]
    dp = mesh.shape["data"] * mesh.shape["fsdp"]
    for a in ("tensor", "seq"):
        if mesh.shape[a] > 1:
            raise ValueError(f"pipeline composes with data/fsdp only; mesh axis '{a}' has size "
                             f"{mesh.shape[a]} (must be 1 when pipe > 1)")
    if n_micro is None:
        n_micro = max(1, batch // dp)
    if batch % n_micro != 0:
        raise ValueError(f"batch {batch} must divide into n_micro={n_micro}")
    if cfg.num_layers % n_stages != 0:
        raise ValueError(f"pipe axis {n_stages} must evenly divide num_layers {cfg.num_layers}")
    mb = batch // n_micro
    if dp > 1 and mb % dp != 0:
        raise ValueError(f"microbatch rows {mb} must divide over data*fsdp={dp} "
                         "(lower n_micro or raise the batch)")
    return n_stages, dp, n_micro, mb


# (stage, tick) -> ("F" | "B", microbatch) or None, and the number of ticks.
# A stage's forward at tick t is the next stage's at t + 1, its backward the
# previous stage's at t + 1: every message is used one tick after it is sent.

def _gpipe(n_stages: int, n_micro: int):
    fwd_ticks = n_micro + n_stages - 1

    def op(s: int, t: int):
        if t < fwd_ticks:
            kind, m = "F", t - s
        else:  # the last microbatch first, from the last stage back
            kind, m = "B", n_micro - 1 - (t - fwd_ticks - (n_stages - 1 - s))
        return (kind, m) if 0 <= m < n_micro else None

    return op, 2 * fwd_ticks


def _one_f_one_b(n_stages: int, n_micro: int):
    def op(s: int, h: int):
        tf, tb = h - s, h - (2 * n_stages - 1 - s)
        if 0 <= tf < 2 * n_micro and tf % 2 == 0:
            return "F", tf // 2
        if 0 <= tb < 2 * n_micro and tb % 2 == 0:
            return "B", tb // 2
        return None

    return op, 2 * n_micro + 2 * n_stages - 2


SCHEDULES = {"gpipe": _gpipe, "1f1b": _one_f_one_b}


def _run(op, n_ticks: int, mesh, template: torch.Tensor, forward: Callable,
         backward: Callable) -> None:
    """Tick by tick, this stage's entries of the table `op`: forward(m, x)
    (x the previous stage's activation, None on stage 0) returns what goes
    to the next stage; backward(m, g) (g the next stage's gradient, None on
    the last) returns what goes to the previous one. template: the shape,
    dtype and device of a message."""
    group, n, s = mesh.group("pipe"), mesh.shape["pipe"], mesh.coords["pipe"]
    if group is not None and dist.get_backend(group) == "nccl":
        dist.barrier(group=group)  # NCCL's first call over a group takes every rank of it
    x_in = g_in = None
    for t in range(n_ticks):
        entry, sends = op(s, t), []
        if entry is not None and entry[0] == "F":
            y = forward(entry[1], x_in)
            if s < n - 1:
                sends.append((s + 1, y))
        elif entry is not None:
            g = backward(entry[1], g_in)
            if s > 0:
                sends.append((s - 1, g))
        from_prev = s > 0 and (op(s - 1, t) or ("",))[0] == "F"
        from_next = s < n - 1 and (op(s + 1, t) or ("",))[0] == "B"
        got = send_recv(sends, [(s - 1, template)] * from_prev + [(s + 1, template)] * from_next,
                        group)
        x_in = got.pop(0) if from_prev else None
        g_in = got.pop(0) if from_next else None


def _stage_runner(params: LlamaParams, cfg: TextConfig, positions, segment_ids, right_padded,
                  remat):
    """run(x, rows) -> this stage's layers over x, the rows `rows` of the
    batch (their positions and segment ids)."""
    lora_scaling = getattr(params, "lora_scaling", None)

    def run(x, rows):
        layer = prefill_layer(cfg, positions[rows],
                              segment_ids=None if segment_ids is None else segment_ids[rows],
                              right_padded=right_padded, lora_scaling=lora_scaling)
        for bp in params.blocks.layers():
            x = (checkpoint(layer, x, bp, use_reentrant=False) if remat else layer(x, bp))[0]
        return x

    return run


def _layout(cfg, inputs_embeds, positions, mesh, n_micro, dtype):
    """(stages, this stage, microbatches, local rows of one, message template)."""
    b, s = positions.shape
    n_stages, dp, n_micro, mb = _pipe_layout(mesh, cfg, b * mesh.axis_size(("data", "fsdp")),
                                             n_micro)
    dtype = inputs_embeds.dtype if inputs_embeds is not None else dtype
    if dtype is None:
        raise ValueError("stages past the first take dtype= where they get no embeds")
    if mesh.coords["pipe"] == 0 and inputs_embeds is None:
        raise ValueError("stage 0 injects the embeds: pass inputs_embeds")
    template = torch.empty((mb // dp, s, cfg.hidden_size), dtype=dtype, device=positions.device)
    return n_stages, mesh.coords["pipe"], n_micro, mb // dp, template


def pipeline_prefill(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: Optional[torch.Tensor],  # (B, S, D) on stage 0, this rank's rows
    positions: torch.Tensor,  # (B, S)
    mesh: Mesh,
    *,
    n_micro: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    right_padded: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The decoder's forward over this rank's rows, layer-partitioned over
    the pipe axis (GPipe's forward ticks): the hidden (B, S, D) of
    `llama_prefill`, before the final norm, on every rank of the pipe
    group, broadcast from the last stage (the one place an O(B S D) result
    crosses the stages; the training schedules never do it). Forward only,
    with no graph kept (so JAX's remat has nothing to save here): no
    gradient crosses the stages (training takes `pipeline_train`).

    params: this rank's shards (`shard_params`: the blocks its stage's
    layers); inputs_embeds: needed on stage 0 alone, the other stages may
    pass None and the embeds' dtype. n_micro: microbatches of the global
    batch (default B // (data * fsdp), one row each)."""
    n_stages, s, n_micro, mb, template = _layout(cfg, inputs_embeds, positions, mesh, n_micro,
                                                 dtype)
    run = _stage_runner(params, cfg, positions, segment_ids, right_padded, remat=False)
    out = template.new_empty((n_micro * mb,) + template.shape[1:])

    def forward(m, x):
        rows = slice(m * mb, (m + 1) * mb)
        y = run(inputs_embeds[rows] if s == 0 else x, rows)
        if s == n_stages - 1:
            out[rows] = y
        return y

    op, n_ticks = _gpipe(n_stages, n_micro)
    with torch.no_grad():
        _run(op, n_ticks // 2, mesh, template, forward, None)
        return broadcast(out, mesh.group("pipe"), n_stages - 1)


def pipeline_train(
    params: LlamaParams,
    cfg: TextConfig,
    inputs_embeds: Optional[torch.Tensor],  # (B, S, D) on stage 0, this rank's rows
    positions: torch.Tensor,  # (B, S)
    labels: torch.Tensor,  # (B, S) unshifted; -100 = ignore
    mesh: Mesh,
    *,
    schedule: str = "1f1b",
    n_micro: Optional[int] = None,
    remat: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    right_padded: bool = True,
    valid_vocab: Optional[int] = None,
    ce_chunk: int = 1024,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """The decoder's loss and gradients under a pipeline schedule ("gpipe"
    or "1f1b", `SCHEDULES`): JAX's `pipeline_train_1f1b`, and GPipe as
    `jax.grad` through its `pipeline_prefill` + CE.

    Returns (loss, d_llm, d_embeds). loss: the global mean CE over every
    rank's rows, on every rank. The gradients accumulate into the leaves'
    `.grad`, as a backward does: d_llm maps each leaf this stage touched to
    its `.grad` ("blocks/<name>" of its layers; on the last stage alone also
    "final_norm" and "embed" or "lm_head"), this rank's part before the sum
    over the ranks of other rows (JAX returns it summed). d_embeds: on stage
    0 the gradient of inputs_embeds, None on the others. inputs_embeds and
    dtype: `pipeline_prefill`'s."""
    from ..train.losses import IGNORE_INDEX, ce_sums, shift_labels

    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipe schedule {schedule!r}; choose from {sorted(SCHEDULES)}")
    n_stages, s, n_micro, mb, template = _layout(cfg, inputs_embeds, positions, mesh, n_micro,
                                                 dtype)
    last = s == n_stages - 1
    run = _stage_runner(params, cfg, positions, segment_ids, right_padded, remat)
    shifted = shift_labels(labels)
    count = all_reduce((shifted != IGNORE_INDEX).sum(), mesh.group(("data", "fsdp")))
    count = count.clamp(min=1).float()
    head_mesh = mesh if mesh.shape["fsdp"] > 1 else None  # the head gathered over fsdp
    nll = torch.zeros((), dtype=torch.float32, device=positions.device)
    d_embeds = torch.zeros_like(inputs_embeds) if s == 0 else None
    held = {}  # microbatch -> (its input, what its backward starts from)

    def forward(m, x):
        nonlocal nll
        rows = slice(m * mb, (m + 1) * mb)
        x = (inputs_embeds[rows] if s == 0 else x).detach().requires_grad_(True)
        y = run(x, rows)
        if not last:
            held[m] = (x, y)
            return y.detach()
        total, _ = ce_sums(params, cfg, y, shifted[rows], chunk_size=ce_chunk,
                           valid_vocab=valid_vocab, mesh=head_mesh)
        nll = nll + total.detach()
        held[m] = (x, total / count)
        return None

    def backward(m, g):
        x, out = held.pop(m)
        torch.autograd.backward(out, None if last else g)
        if s == 0:
            d_embeds[m * mb:(m + 1) * mb] = x.grad
            return None
        return x.grad

    op, n_ticks = SCHEDULES[schedule](n_stages, n_micro)
    _run(op, n_ticks, mesh, template, forward, backward)
    loss = all_reduce(nll, mesh.group(("data", "fsdp", "pipe"))) / count
    touched = {f"blocks/{n}": p for n, p in params.blocks.named_parameters()}
    if last:
        head = "embed" if cfg.tie_word_embeddings else "lm_head"
        touched.update(final_norm=params.final_norm, **{head: getattr(params, head)})
    d_llm = {name: p.grad for name, p in touched.items() if p.grad is not None}
    return loss, d_llm, d_embeds

