"""Multi-rank jobs for the port's CPU tests: `run_ranks` spawns gloo ranks
(one process each, torch and the port only, no JAX), runs a job in each
and returns each rank's result. The jobs below build everything from numpy
inputs the test made, so a test file spawns one job, in a module-scoped
fixture, for all its checks. Not collected by pytest (no test_ prefix)."""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import traceback

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
            job, args = pickle.load(f)
        result = job(rank, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class RankJob:
    """job(rank, *args) started in each rank of a `world`-rank gloo group
    (spawned processes); `results()` waits for them: the caller can work
    meanwhile (a test's references). The job and its arguments reach the
    ranks through a file, so that starting a rank does not wait for it to
    import what unpickling them needs."""

    def __init__(self, world: int, job, *args, timeout: float = 300.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        self._timeout = timeout
        with open(os.path.join(self._dir.name, "job.pkl"), "wb") as f:
            pickle.dump((job, args), f)
        port = _free_port()
        self._procs = [ctx.Process(target=_entry, args=(r, world, port, self._dir.name))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def results(self) -> list:
        """[each rank's result]; raises with a rank's traceback if one failed."""
        out = self._dir.name
        try:
            for p in self._procs:
                p.join(self._timeout)
            alive = [p for p in self._procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
            errors = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
                      if f.endswith(".err")]
            codes = [p.exitcode for p in self._procs]
            if errors or alive or any(codes):
                raise RuntimeError(f"ranks failed (exit codes {codes}, {len(alive)} timed "
                                   "out):\n" + "\n".join(errors))
            return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                    for r in range(len(self._procs))]
        finally:
            self._dir.cleanup()


def run_ranks(world: int, job, *args, timeout: float = 300.0) -> list:
    """[job(rank, *args) for each rank] (`RankJob`, waited for at once)."""
    return RankJob(world, job, *args, timeout=timeout).results()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

F32 = torch.float32


def _port_params(flat, cfg):
    """flat: a {path: array} dict, or the path of an .npz file of one."""
    from grasp_any_region_tpu_torch.core.weights import load_flat_params

    if isinstance(flat, str):
        flat = dict(np.load(flat))
    return load_flat_params(flat, cfg, device="cpu")


def _batch(fields: dict):
    from grasp_any_region_tpu_torch.models.gar import GARBatch

    return GARBatch(**{k: None if v is None else torch.from_numpy(np.array(v))
                       for k, v in fields.items()})


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def snapshot_grads(tx, out: dict, mesh=None) -> None:
    """Make tx.apply first copy the whole gradients into out (the step
    frees them as it applies them)."""
    from grasp_any_region_tpu_torch.core.weights import flat_grads
    from grasp_any_region_tpu_torch.parallel.sharding import full_grads

    apply = tx.apply

    def snapshot_then_apply(params, opt_state, sq=None):
        grads = flat_grads(params) if mesh is None else full_grads(params, mesh)
        out.update({k: np.asarray(v) for k, v in grads.items()})
        apply(params, opt_state, sq)

    tx.apply = snapshot_then_apply


def train_step(params, cfg, fields, labels, lr, mesh=None, **step_kw) -> dict:
    """One fp32 step of `make_train_step` (sharded where mesh is given;
    step_kw: its compute_dtype, pipe_schedule): its metrics, the whole
    gradients it applied, the whole parameters after it, and this rank's
    parameter + moment bytes."""
    from grasp_any_region_tpu_torch.parallel.sharding import unshard_params
    from grasp_any_region_tpu_torch.train import OptimizerConfig
    from grasp_any_region_tpu_torch.train.step import init_state, make_train_step, shard_batch

    batch, labels = _batch(fields), torch.from_numpy(np.array(labels))
    if mesh is not None:
        batch, labels = shard_batch(batch, labels, mesh)
    state, tx = init_state(params, OptimizerConfig(lr=lr, total_steps=10, warmup_ratio=0.0),
                           device="cpu", mesh=mesh)
    grads = {}
    snapshot_grads(tx, grads, mesh)
    step = make_train_step(cfg, tx, mask_compat=False, device="cpu", mesh=mesh,
                           **{"compute_dtype": F32, **step_kw})
    state, metrics = step(state, batch, labels)
    after = state.params if mesh is None else unshard_params(state.params, mesh)
    mu = dict(zip(tx.names, state.opt_state.mu))
    named = dict(state.params.named_parameters())
    leaf_bytes = {n: _bytes([p]) + 2 * (_bytes([mu[n]]) if n in mu else 0)
                  for n, p in named.items()}
    return dict(loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
                grads=grads, bytes=sum(leaf_bytes.values()), leaf_bytes=leaf_bytes,
                specs={n: getattr(p, "spec", ()) for n, p in named.items()},
                params={n.replace(".", "/"): p.detach().numpy()
                        for n, p in after.named_parameters()})


def train_job(rank: int, cases: list, lr: float) -> dict:
    """`train_step` on each case (name, MeshSpec, cfg, flat params, batch
    fields, labels, optionally a dict of `train_step`'s step_kw), each on
    its own mesh over the job's ranks."""
    from grasp_any_region_tpu_torch.core.mesh import make_mesh

    return {name: train_step(_port_params(flat, cfg), cfg, fields, labels, lr,
                             make_mesh(spec, device="cpu"), **(kw[0] if kw else {}))
            for name, spec, cfg, flat, fields, labels, *kw in cases}


def attention_job(rank: int, inputs: dict, segments: dict) -> dict:
    """inputs {tag: (q, k, v, dout)}, whole (B, S, H | K, D) arrays: Ulysses
    (where the kv heads divide 2, else its refusal) and ring attention at
    seq = 2 over this rank's sequence shards, causal and not, the ring's
    gradients of sum(out * dout) too; Ulysses on the first inputs with each
    of `segments` {name: (whole (B, S) segment ids, right_padded)}. Outputs
    gathered whole."""
    from grasp_any_region_tpu_torch.core.mesh import MeshSpec, make_mesh
    from grasp_any_region_tpu_torch.parallel.ring import ring_attention
    from grasp_any_region_tpu_torch.parallel.sharding import constrain_seq, seq_gather
    from grasp_any_region_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = make_mesh(MeshSpec(seq=2), device="cpu")
    out = {}
    for tag, arrays in inputs.items():
        q, k, v, dout = (torch.from_numpy(x) for x in arrays)
        local = [constrain_seq(x, mesh) for x in (q, k, v)]
        for causal in (False, True):
            try:
                o = ulysses_attention(*local, mesh, causal=causal)
                out[f"ulysses_{tag}_{causal}"] = seq_gather(o, mesh).numpy()
            except ValueError as e:
                out[f"ulysses_{tag}_{causal}"] = str(e)
            qg, kg, vg = (x.clone().requires_grad_(True) for x in local)
            o = ring_attention(qg, kg, vg, mesh, causal=causal)
            (o * constrain_seq(dout, mesh)).sum().backward()
            out[f"ring_{tag}_{causal}"] = [seq_gather(t, mesh).numpy()
                                           for t in (o.detach(), qg.grad, kg.grad, vg.grad)]
    local = [constrain_seq(torch.from_numpy(x), mesh) for x in next(iter(inputs.values()))[:3]]
    for name, (seg, right_padded) in segments.items():
        o = ulysses_attention(*local, mesh, causal=True,
                              segment_ids=constrain_seq(torch.from_numpy(seg), mesh),
                              right_padded=right_padded)
        out[f"ulysses_segments_{name}"] = seq_gather(o, mesh).numpy()
    return out


def generate_job(rank: int, cases: list) -> dict:
    """`generate(mesh=)` at fp32 for each case (name, MeshSpec, cfg, flat
    params, batch fields, prompt lens, kwargs): each rank's tokens."""
    from grasp_any_region_tpu_torch.core.mesh import make_mesh
    from grasp_any_region_tpu_torch.models.generate import generate
    from grasp_any_region_tpu_torch.parallel.sharding import shard_params

    out = {}
    for name, spec, cfg, flat, fields, lens, kw in cases:
        mesh = make_mesh(spec, device="cpu")
        params = shard_params(_port_params(flat, cfg), mesh)
        res = generate(params, cfg, _batch(fields), torch.from_numpy(lens), mesh=mesh,
                       compute_dtype=F32, **kw)
        out[name] = dict(tokens=res.tokens.numpy(), num_generated=res.num_generated.numpy())
    return out


def trainer_job(rank: int, cfg, ann: str, work: str) -> dict:
    """A `Trainer` made on each of data, fsdp, tensor and seq = 2 (CPU,
    from an annotation file): {axis: (row groups, this rank's group, the
    seq multiple, this rank's rows of the first step)}."""
    from grasp_any_region_tpu_torch.core.mesh import MeshSpec
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.dataset import DatasetConfig, GraspAnyRegionDataset
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.train import OptimizerConfig
    from grasp_any_region_tpu_torch.train.trainer import Trainer, TrainerConfig

    tok = GARTokenizer.synthetic(cfg.prompt_numbers)
    dataset = GraspAnyRegionDataset(cfg, tok, DatasetConfig(annotation_paths=[ann]))
    params = init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for axis in ("data", "fsdp", "tensor", "seq"):
        tcfg = TrainerConfig(work_dir=os.path.join(work, axis), max_steps=1, batch_size=2,
                             mesh=MeshSpec(**{axis: 2}), device="cpu", resume=False)
        t = Trainer(cfg, params, dataset, OptimizerConfig(total_steps=1), tcfg)
        out[axis] = (t.n_procs, t.proc_id, t.seq_multiple, t.step_indices(0, 1))
    return out


def replace_text(cfg, **kw):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **kw))


def numpy_fields(batch) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in batch._asdict().items()}


def multi_job(rank: int, parts: list) -> list:
    """[job(rank, *args) for (job, args) in parts]: one spawn for several
    jobs of one world size."""
    return [job(rank, *args) for job, args in parts]


def pipeline_job(rank: int, cases: list) -> dict:
    """Each case (name, kind, MeshSpec, cfg, flat params, inputs, kwargs) on
    the mesh of its spec, at fp32. inputs: numpy "embeds", "positions" and,
    for kind "train", "labels" (whole batches; a rank takes its rows over
    data and fsdp), "segment_ids" optional. kind "prefill": the
    `pipeline_prefill` hidden of this rank's rows; kind "train":
    `pipeline_train(**kwargs)`'s loss, the leaves this stage holds gradients
    for right after it (d_llm's keys and the llm leaves with a `.grad`),
    then, after `reduce_gradients`, the whole gradients (rank 0's alone:
    they are the same on every rank) and this rank's rows of d_embeds
    (None past stage 0) with its row group."""
    from grasp_any_region_tpu_torch.core.mesh import MeshSpec, make_mesh
    from grasp_any_region_tpu_torch.parallel.pipeline import (make_pipeline_mesh,
                                                              pipeline_prefill, pipeline_train)
    from grasp_any_region_tpu_torch.parallel.sharding import full_grads, shard_params, shard_rows
    from grasp_any_region_tpu_torch.train.step import reduce_gradients

    meshes, flats, out = {}, {}, {}
    for name, kind, spec, cfg, flat, inputs, kw in cases:
        if flat not in flats:
            flats[flat] = dict(np.load(flat))
        if spec not in meshes:
            meshes[spec] = (make_pipeline_mesh(spec.pipe, device="cpu")
                            if spec == MeshSpec(pipe=spec.pipe) else make_mesh(spec, device="cpu"))
        mesh = meshes[spec]
        llm = shard_params(_port_params(flats[flat], cfg), mesh).llm
        rows = {k: shard_rows(torch.from_numpy(np.array(v)), ("data", "fsdp"), mesh)
                for k, v in inputs.items()}
        embeds = rows["embeds"] if mesh.coords["pipe"] == 0 else None
        args = (llm, cfg.text, embeds, rows["positions"])
        kw = dict(kw, segment_ids=rows.get("segment_ids"), dtype=F32)
        if kind == "prefill":
            out[name] = pipeline_prefill(*args, mesh, **kw).numpy()
            continue
        for p in llm.parameters():
            p.requires_grad_(True)
        loss, d_llm, d_embeds = pipeline_train(*args, rows["labels"], mesh, **kw)
        held = sorted(n for n, p in llm.named_parameters() if p.grad is not None)
        reduce_gradients(llm, mesh)
        grads = {k: v.numpy() for k, v in full_grads(llm, mesh).items()}
        out[name] = dict(loss=loss.item(), d_llm=sorted(d_llm), held=held,
                         grads=grads if rank == 0 else None,
                         d_embeds=None if d_embeds is None else d_embeds.numpy(),
                         row_group=mesh.index(("data", "fsdp")))
    return out


def step_summary_job(rank: int, cases: list, lr: float, params: tuple,
                     grads_of: tuple = ()) -> dict:
    """`train_job`, each case's result cut to its loss, grad_norm, specs and
    the whole parameters named in `params` after the step; for the cases
    named in grads_of, rank 0's whole gradients too."""
    return {name: dict(loss=r["loss"], grad_norm=r["grad_norm"], specs=r["specs"],
                       params={k: r["params"][k] for k in params},
                       grads=r["grads"] if rank == 0 and name in grads_of else None)
            for name, r in train_job(rank, cases, lr).items()}


def packed_steps_job(rank: int, spec, cfg, flat, packed_fields: dict, lr: float,
                     schedules: tuple, n_steps: int) -> dict:
    """{schedule: the losses of n_steps fp32 `make_packed_train_step` steps
    on the mesh of spec}, each schedule from the same parameters, and
    {"value": `packed_loss_fn`'s value on them}."""
    from grasp_any_region_tpu_torch.core.mesh import make_mesh
    from grasp_any_region_tpu_torch.data.builders import PackedTextBatch
    from grasp_any_region_tpu_torch.train import OptimizerConfig
    from grasp_any_region_tpu_torch.train.step import (init_state, make_packed_train_step,
                                                       packed_loss_fn)

    mesh = make_mesh(spec, device="cpu")
    packed = PackedTextBatch(**{k: torch.from_numpy(np.array(v))
                                for k, v in packed_fields.items()})
    out = {}
    for schedule in schedules:
        state, tx = init_state(_port_params(flat, cfg), OptimizerConfig(
            lr=lr, total_steps=10, warmup_ratio=0.0), device="cpu", mesh=mesh)
        out["value"] = packed_loss_fn(state.params, cfg, packed, F32, mesh).item()
        step = make_packed_train_step(cfg, tx, device="cpu", compute_dtype=F32, mesh=mesh,
                                      pipe_schedule=schedule)
        losses = []
        for _ in range(n_steps):
            state, metrics = step(state, packed)
            losses.append(metrics["loss"].item())
        out[schedule] = losses
    return out


def pipe_trainer_job(rank: int, args: list, work: str) -> dict:
    """`cli.train.main(args)` on a pipe = 2 mesh (CPU): under GPipe for 2
    steps in `work`/whole (its first save is step 1's), then under 1F1B to
    step 2 in `work`/resumed, resuming from a copy of that step-1
    checkpoint. {tag: (its history's losses, the lines this rank printed,
    its final step, the sha256 of each of its final parameters and
    moments)}."""
    import contextlib
    import hashlib
    import io
    import shutil

    from grasp_any_region_tpu_torch.cli.train import main

    os.environ["WORLD_SIZE"] = "2"  # as torch.distributed.run sets it
    out = {}
    for tag, schedule in (("whole", "gpipe"), ("resumed", "1f1b")):
        if tag == "resumed":
            shutil.copytree(os.path.join(work, "whole", f"rank{rank}", "1"),
                            os.path.join(work, tag, f"rank{rank}", "1"))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            tr = main(args + ["--pipe", "2", "--pipe-schedule", schedule, "--max-steps", "2",
                              "--work-dir", os.path.join(work, tag)])
        state = tr.state
        out[tag] = dict(
            losses=[h["loss"].item() for h in tr.history], printed=printed.getvalue(),
            step=state.step,
            params={n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                    for n, p in state.params.named_parameters()},
            moments=[hashlib.sha256(m.numpy().tobytes()).hexdigest()
                     for m in state.opt_state.mu + state.opt_state.nu])
    return out
