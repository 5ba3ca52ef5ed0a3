"""Multi-rank jobs for the port's CPU tests: `run_ranks` spawns gloo ranks
(one process each, torch and the port only, no JAX), runs a job in each
and returns each rank's result. The jobs below build everything from numpy
inputs the test made, so a test file spawns one job, in a module-scoped
fixture, for all its checks. Not collected by pytest (no test_ prefix)."""

from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
import traceback

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, job, args, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
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
    meanwhile (a test's references)."""

    def __init__(self, world: int, job, *args, timeout: float = 300.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        self._timeout = timeout
        port = _free_port()
        self._procs = [ctx.Process(target=_entry, args=(r, world, port, job, args, self._dir.name))
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
    from grasp_any_region_tpu_torch.core.weights import load_flat_params

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


def train_step(params, cfg, fields, labels, lr, mesh=None) -> dict:
    """One fp32 step of `make_train_step` (sharded where mesh is given):
    its metrics, the whole gradients it applied, the whole parameters
    after it, and this rank's parameter + moment bytes."""
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
    step = make_train_step(cfg, tx, mask_compat=False, device="cpu", compute_dtype=F32,
                           mesh=mesh)
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
    fields, labels), each on its own mesh over the job's ranks."""
    from grasp_any_region_tpu_torch.core.mesh import make_mesh

    return {name: train_step(_port_params(flat, cfg), cfg, fields, labels, lr,
                             make_mesh(spec, device="cpu"))
            for name, spec, cfg, flat, fields, labels in cases}


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
