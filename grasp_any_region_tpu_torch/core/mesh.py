"""The device mesh over torch.distributed ranks (`grasp_any_region_tpu/core/mesh.py`).

JAX names its devices' axes in a `jax.sharding.Mesh` and lets XLA insert
the collectives. The port runs one process a rank (SPMD): the world's
ranks are laid out over the same named axes, in JAX's order,

  data   - data parallel, outermost
  fsdp   - ZeRO-3-style parameter and optimizer-state shards (and more rows)
  tensor - tensor parallel (heads and MLP columns)
  seq    - sequence parallel (Ulysses / ring attention), innermost with tensor
  pipe   - pipeline stages: the decoder's layers (parallel/pipeline.py), innermost

so rank = row-major index of its coordinates over (data, fsdp, tensor, seq,
pipe). `Mesh` holds one process group for every set of live axes (an axis
of size 1 needs none), e.g. "fsdp", "tensor" or ("data", "fsdp"), and the
collective layer (parallel/collectives.py) runs over them.

The backend is NCCL with one rank per card unless the caller names
another; gloo serves CPU ranks (the tests) and several ranks on one card.
The device is `cuda:LOCAL_RANK` unless the caller asks for another; nothing
falls back to the CPU because NCCL is missing.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor", "seq", "pipe")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1  # pipeline stages; composes with data and fsdp alone

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.tensor * self.seq * self.pipe

    def axis_sizes(self) -> Tuple[int, int, int, int, int]:
        return (self.data, self.fsdp, self.tensor, self.seq, self.pipe)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as JAX's `Mesh.shape` (what `sanitize_spec` reads)."""
        return dict(zip(AXES, self.axis_sizes()))


Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are {AXES}")
    return tuple(a for a in AXES if a in axes)


class Mesh:
    """This rank's place on the mesh: `shape` ({axis: size}), `coords`
    ({axis: index}), `device`, and `group(axes)`, the process group of the
    ranks that differ from this one only along `axes` (None where those
    axes hold one rank). Made by `make_mesh`."""

    def __init__(self, spec: MeshSpec, rank: int, device: torch.device):
        self.spec = spec
        self.shape = spec.shape
        self.axis_names = AXES
        self.size = spec.size
        self.rank = rank
        self.device = device
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, spec.axis_sizes()))))
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        if spec.size == 1:
            return
        # every rank creates every group, in one order (new_group is collective)
        grid = np.arange(spec.size).reshape(spec.axis_sizes())
        live = [a for a in AXES if self.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for sub in itertools.combinations(live, n):
                idx = [AXES.index(a) for a in sub]
                rest = [i for i in range(len(AXES)) if i not in idx]
                lists = np.moveaxis(grid, idx, list(range(len(rest), len(AXES)))).reshape(
                    -1, int(np.prod([self.shape[a] for a in sub])))
                mine = None
                for ranks in lists:
                    g = dist.new_group([int(r) for r in ranks])
                    if rank in ranks:
                        mine = g
                self._groups[sub] = mine

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index along `axes` (its rank in `group(axes)`)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes) -> Optional[dist.ProcessGroup]:
        """The process group along `axes`, without the axes of size 1; None
        when they hold one rank (the collectives skip it)."""
        live = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        return self._groups[live] if live else None

    def __repr__(self) -> str:
        return f"Mesh({self.spec}, rank {self.rank}, {self.device})"


def _default_device() -> torch.device:
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(spec: Optional[MeshSpec] = None, device=None) -> Mesh:
    """The mesh of `spec` over the initialised world (`initialize_distributed`);
    spec None puts every rank on fsdp, as JAX does. A spec of size 1 needs
    no process group. device: this rank's device (default cuda:LOCAL_RANK;
    a card that is missing raises)."""
    from .weights import require_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    spec = spec or MeshSpec(fsdp=world)
    if spec.size != world:
        raise ValueError(f"mesh spec {spec} needs {spec.size} ranks, the world has {world} "
                         "(initialize_distributed first)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(spec, rank, require_device(device if device is not None else _default_device()))


def single_device_mesh(device=None) -> Mesh:
    """The mesh of one rank: no process group, the one-card path."""
    from .weights import require_device

    return Mesh(MeshSpec(), 0, require_device(device if device is not None else
                                              _default_device()))


def initialize_distributed(*, backend: Optional[str] = None, device=None) -> torch.device:
    """Join the process group from the launcher's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as
    `torch.distributed.run` sets them) and return this rank's device.
    backend: NCCL for CUDA devices (one rank a card), gloo for CPU ones,
    unless named. device: default cuda:LOCAL_RANK."""
    from .weights import require_device

    device = require_device(device if device is not None else _default_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method="env://")
    return device
