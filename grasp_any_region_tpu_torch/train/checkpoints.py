"""Training checkpoints with resume (`grasp_any_region_tpu/train/checkpoints.py`).

The semantics are those of JAX's orbax manager:
  * `maybe_save(step, state)` saves the first step this directory sees and
    then every `save_interval`-th step past the newest one saved; `force`
    saves any step not saved yet (the end of a run);
  * the newest `max_to_keep` steps stay on disk;
  * `save_optimizer=False` keeps the parameters and the step only, and
    `restore` then leaves the template's fresh optimizer state.

Orbax has no counterpart here, so the format is the port's own: step N is
the directory `N/` holding `params.safetensors` (the parameters under
their '/'-joined names, each in its dtype: bf16 stays bf16),
`opt_state.safetensors` (Adam's moments and, mid-window, the accumulated
gradient, keyed by the trainable leaf's index) and `state.json` (the step,
the optimizer's update count and window position, and each moment's
shape and dtype). A save copies the state to host memory, then a
background thread writes it under a temporary name and renames it into
place, so a step on disk is always whole; `wait` joins the writer and
raises what it raised.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional

import torch

from ..core.weights import read_safetensors_torch, write_safetensors
from .optimizer import OptState

STATE_FILE = "state.json"


def _host_copy(tensors) -> dict:
    return {name: t.detach().to("cpu", copy=True) for name, t in tensors.items()}


class CheckpointManager:
    def __init__(self, directory: str, *, save_interval: int = 5000, max_to_keep: int = 2,
                 save_optimizer: bool = True):
        if save_interval < 1 or max_to_keep < 1:
            raise ValueError(f"save_interval {save_interval} and max_to_keep {max_to_keep} "
                             "must be at least 1")
        self.directory = os.path.abspath(directory)
        self.save_interval = save_interval
        self.max_to_keep = max_to_keep
        self.save_optimizer = save_optimizer
        os.makedirs(self.directory, exist_ok=True)
        self._saved_steps = set(self.all_steps())
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: List[dict] = []  # one record a save: step, bytes, host copy and write seconds

    def all_steps(self) -> List[int]:
        """The steps whole on disk, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n,
                                                                     STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        last = max(self._saved_steps, default=None)
        if last is None:
            return True
        return step > last and step % self.save_interval == 0

    def maybe_save(self, step: int, state, force: bool = False) -> bool:
        """Save `state` (a train `TrainState`) as `step` when the cadence or
        `force` asks for it; returns whether it saved."""
        if force and step in self._saved_steps:
            return False  # the cadence already saved this step
        if not force and not self.should_save(step):
            return False
        t0 = time.perf_counter()
        params = _host_copy({n.replace(".", "/"): p for n, p in state.params.named_parameters()})
        meta = {"step": int(state.step)}
        opt = None
        if self.save_optimizer:
            o: OptState = state.opt_state
            opt = _host_copy({f"{kind}/{i:05d}": t for kind in ("mu", "nu")
                              for i, t in enumerate(getattr(o, kind))})
            if o.acc is not None and o.mini_step:  # at a window's end acc is all zeros
                opt.update(_host_copy({f"acc/{i:05d}": t for i, t in enumerate(o.acc)}))
            meta.update(count=o.count, mini_step=o.mini_step,
                        moments=[[list(t.shape), str(t.dtype)] for t in o.mu])
        copy_s = time.perf_counter() - t0
        self.wait()  # one write in flight
        self._saved_steps.add(step)
        self._writer = threading.Thread(target=self._write, args=(step, params, opt, meta, copy_s),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, params: dict, opt: Optional[dict], meta: dict,
               copy_s: float) -> None:
        try:
            t0 = time.perf_counter()
            final = os.path.join(self.directory, str(step))
            tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            n = write_safetensors(params, os.path.join(tmp, "params.safetensors"))
            if opt is not None:
                n += write_safetensors(opt, os.path.join(tmp, "opt_state.safetensors"))
            with open(os.path.join(tmp, STATE_FILE), "w") as f:
                json.dump(meta, f)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
            self.saves.append(dict(step=step, bytes=n, copy_s=copy_s,
                                   write_s=time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - handed to the trainer's thread by wait()
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("writing a checkpoint failed") from err

    @torch.no_grad()
    def restore(self, template, step: Optional[int] = None):
        """`template` (a `TrainState`) with the saved parameters, step and,
        when saved, optimizer state copied into its tensors; None when the
        directory holds no step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, STATE_FILE)) as f:
            meta = json.load(f)
        saved = read_safetensors_torch(os.path.join(path, "params.safetensors"))
        named = {n.replace(".", "/"): p for n, p in template.params.named_parameters()}
        if set(saved) != set(named):
            raise KeyError(f"checkpoint {path} holds other parameters: missing "
                           f"{sorted(set(named) - set(saved))[:5]}, unused "
                           f"{sorted(set(saved) - set(named))[:5]}")
        for name, p in named.items():
            _copy_into(p, saved[name], name)
        opt_state = template.opt_state
        if self.save_optimizer:
            o: OptState = template.opt_state
            want = [[list(t.shape), str(t.dtype)] for t in o.mu]
            if meta.get("moments") != want:
                raise ValueError(f"checkpoint {path}: its optimizer state is not the "
                                 "template's (another set of trainable leaves)")
            opt = read_safetensors_torch(os.path.join(path, "opt_state.safetensors"))
            for kind in ("mu", "nu"):
                for i, t in enumerate(getattr(o, kind)):
                    _copy_into(t, opt[f"{kind}/{i:05d}"], f"{kind}/{i}")
            if o.acc is not None:
                for i, t in enumerate(o.acc):
                    if meta["mini_step"]:
                        _copy_into(t, opt[f"acc/{i:05d}"], f"acc/{i}")
                    else:
                        t.zero_()
            opt_state = OptState(mu=o.mu, nu=o.nu, count=meta["count"], acc=o.acc,
                                 mini_step=meta["mini_step"])
        return template._replace(opt_state=opt_state, step=meta["step"])


def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"{name}: saved {tuple(src.shape)} {src.dtype}, the template holds "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)
