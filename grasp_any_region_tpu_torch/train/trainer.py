"""Training orchestration: the loop over an annotation dataset
(`grasp_any_region_tpu/train/trainer.py`, its single-process, single-card
case).

  * one epoch, or `max_steps`, over `GraspAnyRegionDataset`, each epoch
    in a fresh length-grouped order from `np.random.default_rng([seed,
    epoch])`, the tail of n % batch_size items dropped;
  * a `PrefetchLoader` builds and collates the batches onto the state's
    device on worker threads while the card runs the step;
  * the step is `train/step.make_train_step`: on the card its attention
    runs the hand kernels (A and 5 in the tower, B, 17 and 18 in the
    decoder), with AdamW, clipping and gradient accumulation;
  * a log line every `log_interval` steps, checkpoints on the cadence and a
    forced one at the end (`train/checkpoints.py`), and resume from the
    newest checkpoint in `work_dir` when the trainer is made.

The mesh of JAX's trainer (data, fsdp, tensor, seq and pipeline axes) is
kept in the config; any axis above 1 raises: the port trains on one card
(ROADMAP.md item 1.10).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.config import GARConfig
from ..core.weights import require_device
from ..data.builders import collate_samples
from ..data.dataset import GraspAnyRegionDataset, length_grouped_indices
from ..data.loader import PrefetchLoader
from .checkpoints import CheckpointManager
from .optimizer import OptimizerConfig
from .step import init_state, make_train_step


@dataclass(frozen=True)
class MeshSpec:
    """JAX's mesh axes (`core/mesh.MeshSpec`); the port runs them at 1."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.tensor * self.seq * self.pipe


def require_one_card(mesh: Optional[MeshSpec]) -> None:
    """Raise unless every axis of `mesh` is 1 (or there is no mesh)."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"the port trains on one card: mesh {mesh} asks for {mesh.size}; data, fsdp, "
            "tensor, sequence and pipeline parallelism wait for ROADMAP.md item 1.10")


@dataclass
class TrainerConfig:
    work_dir: str = "./work_dirs/gar"
    max_steps: Optional[int] = None  # None = 1 epoch
    batch_size: int = 1  # per step
    log_interval: int = 100
    save_interval: int = 5000
    max_keep_ckpts: int = 2
    save_optimizer: bool = True
    seed: int = 42
    mesh: Optional[MeshSpec] = None
    resume: bool = True
    num_workers: int = 4  # the loader's threads
    prefetch_batches: int = 2
    pipe_schedule: str = "gpipe"
    device: str = "cuda"  # the card unless the caller asks for the CPU


class Trainer:
    def __init__(self, cfg: GARConfig, params, dataset: GraspAnyRegionDataset,
                 opt_cfg: OptimizerConfig, tcfg: TrainerConfig):
        require_one_card(tcfg.mesh)
        if tcfg.pipe_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipe_schedule {tcfg.pipe_schedule!r}")
        self.cfg = cfg
        self.dataset = dataset
        self.tcfg = tcfg
        self.device = require_device(tcfg.device)
        self.state, self.tx = init_state(params, opt_cfg, device=self.device)
        self.step_fn = make_train_step(cfg, self.tx, device=self.device)  # bf16 loss, as JAX's
        self.ckpt = CheckpointManager(tcfg.work_dir, save_interval=tcfg.save_interval,
                                      max_to_keep=tcfg.max_keep_ckpts,
                                      save_optimizer=tcfg.save_optimizer)
        self.history: List[dict] = []  # a record a step: loss tensor, host seconds
        if tcfg.resume:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                self.state = restored
                print(f"[trainer] resumed from step {self.state.step}")

    def _epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        return length_grouped_indices(self.dataset.modality_lengths(), self.tcfg.batch_size, rng)

    def max_steps(self) -> int:
        return self.tcfg.max_steps or max(1, len(self.dataset) // self.tcfg.batch_size)

    def step_indices(self, start_step: int, max_steps: int) -> List[int]:
        """The dataset indices of steps start_step .. max_steps - 1, batch
        after batch: each epoch a whole permutation keyed by (seed, epoch),
        so a resume past an epoch boundary reshuffles."""
        t = self.tcfg
        steps_per_epoch = max(1, len(self.dataset) // t.batch_size)
        order, order_epoch = None, None
        out = []
        for step in range(start_step, max_steps):
            epoch, pos = divmod(step, steps_per_epoch)
            if epoch != order_epoch:
                order = self._epoch_indices(np.random.default_rng([t.seed, epoch]))
                order_epoch = epoch
            lo = pos * t.batch_size
            # the modulo bites only when n_items < batch_size
            out.extend(int(order[(lo + k) % len(order)]) for k in range(t.batch_size))
        return out

    def collate(self, samples):
        return collate_samples(self.cfg, samples, with_labels=True, device=self.device)

    def train(self):
        t = self.tcfg
        max_steps = self.max_steps()
        start_step = self.state.step
        loader = PrefetchLoader(self.dataset, self.step_indices(start_step, max_steps),
                                batch_size=t.batch_size, collate_fn=self.collate,
                                num_workers=max(1, t.num_workers),
                                prefetch_batches=max(1, t.prefetch_batches))
        batches = iter(loader)
        it_times = []
        t_last = time.perf_counter()
        for step in range(start_step, max_steps):
            batch, _, labels = next(batches)
            wait_s = time.perf_counter() - t_last
            self.state, metrics = self.step_fn(self.state, batch, labels)
            log = (step + 1) % t.log_interval == 0 or step == start_step or step + 1 == max_steps
            if log:  # reading the metrics waits for the card
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            it_times.append(time.perf_counter() - t_last)
            if log:
                print(f"[trainer] step {step + 1}/{max_steps} loss {loss:.4f} grad_norm "
                      f"{gnorm:.3f} iter {np.mean(it_times[-t.log_interval:]):.2f}s "
                      f"(loader wait {wait_s:.3f}s)")
            self.history.append(dict(step=step + 1, loss=metrics["loss"], wait_s=wait_s,
                                     iter_s=it_times[-1]))
            self.ckpt.maybe_save(step + 1, self.state)
            t_last = time.perf_counter()
        # the final state always reaches disk (resume, export), whatever the cadence
        self.ckpt.maybe_save(max_steps, self.state, force=True)
        self.ckpt.wait()
        return self.state
