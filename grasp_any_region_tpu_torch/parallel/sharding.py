"""Sharding rules: parameters and activations over the (data, fsdp, tensor,
seq) mesh (`grasp_any_region_tpu/parallel/sharding.py`).

The rule table is JAX's, as it is (megatron-style TP with fsdp on the
complementary matmul axis):

  decoder  wq/wk/wv (L, D, H*dh): (None, fsdp, tensor)  - heads on tensor
           wo       (L, H*dh, D): (None, tensor, fsdp)
           w_gate/up (L, D, M):   (None, fsdp, tensor)
           w_down   (L, M, D):    (None, tensor, fsdp)
           embed    (V, D):       (tensor, fsdp)         - vocab-parallel
  vision   wqkv     (L, D, 3D):   (None, fsdp, tensor)
           wo/fc2   (L, X, D):    (None, tensor, fsdp)
           fc1      (L, D, M):    (None, fsdp, tensor)
  scalars/norms/layerscale: replicated.

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names, or None, as JAX's `PartitionSpec`; `sanitize_spec` replicates a
dimension the mesh does not divide. `shard_params` turns a parameter tree
into this rank's shards, each leaf keeping its name and dtype and carrying
its sanitized spec as `leaf.spec`; the model's mesh paths gather a leaf
where it is used (`gather_leaf`, a decoder or tower layer's weights one
layer at a time, `gather_layer`), and the gradients come back to the
shards through the gathers' backward.
"""

from __future__ import annotations

import copy
import math
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from .collectives import all_gather, all_gather_rs, all_gather_split, own_chunk

Spec = Tuple[Any, ...]


def _pspec_for(path: str, ndim: int) -> Spec:
    """Rule table keyed on the flattened ('/'-joined) parameter path."""
    # --- decoder ---
    if path.endswith("llm/embed"):
        return ("tensor", "fsdp")
    if path.endswith("llm/lm_head"):
        return ("fsdp", "tensor")
    if "llm/blocks" in path:
        name = path.rsplit("/", 1)[-1]
        if name in ("wq", "wk", "wv", "w_gate", "w_up"):
            return (None, "fsdp", "tensor")
        if name in ("wo", "w_down"):
            return (None, "tensor", "fsdp")
        return (None,)  # norms (L, D)
    if path.endswith("llm/final_norm"):
        return ()
    # --- vision ---
    if "vision/blocks" in path:
        name = path.rsplit("/", 1)[-1]
        if name in ("wqkv", "fc1"):
            return (None, "fsdp", "tensor")
        if name in ("wo", "fc2"):
            return (None, "tensor", "fsdp")
        return (None,)  # biases, norms, layerscale (L, X)
    if "patch_embed/kernel" in path:
        return ("fsdp", "tensor")
    if "vision/pos_embed" in path or "cls_token" in path or "rope_freqs" in path:
        return ()
    # --- projector ---
    if path.endswith("projector/fc1"):
        return ("fsdp", "tensor")
    if path.endswith("projector/fc2"):
        return ("tensor", "fsdp")
    # --- mask embed ---
    if "mask_embed/kernel" in path:
        return ("fsdp", "tensor")
    return ()  # replicate everything else (norm scales, small biases)


def _leaves(params: Union[nn.Module, Mapping[str, Any]]) -> Iterable[Tuple[str, Any]]:
    if isinstance(params, nn.Module):
        return ((n.replace(".", "/"), p) for n, p in params.named_parameters())
    return params.items()


def param_pspecs(params, pipe: bool = False) -> Dict[str, Spec]:
    """{'a/b/c': spec} for every leaf of `params` (a module, or a flat
    {path: array or shape} dict). pipe: the decoder's stacked layer dim on
    'pipe' instead of the matmul dims (the pipeline's stages hold L / P
    whole layers)."""
    out = {}
    for path, x in _leaves(params):
        if pipe and "llm/blocks" in path:
            out[path] = ("pipe",)
        else:
            out[path] = _pspec_for(path, len(getattr(x, "shape", x)))
    return out


def sanitize_spec(spec: Optional[Spec], shape, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dimension: the dimension
    replicates instead (e.g. fsdp = 3 over a 64-wide tiny model). mesh:
    anything with JAX's `.shape` {axis: size} (`Mesh`, `MeshSpec`)."""
    if spec is None:
        return ()
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(entry if shape[i] % size == 0 else None)
    return tuple(out)


def param_shardings(params, mesh) -> Dict[str, Spec]:
    """{'a/b/c': the sanitized spec} of every leaf on `mesh`."""
    pipe = mesh.shape.get("pipe", 1) > 1
    specs = param_pspecs(params, pipe=pipe)
    return {path: sanitize_spec(specs[path], tuple(getattr(x, "shape", x)), mesh)
            for path, x in _leaves(params)}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor x under a sanitized spec."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            x = x.chunk(mesh.axis_size(axes), dim=dim)[mesh.index(axes)]
    return x


def shard_params(params: nn.Module, mesh) -> nn.Module:
    """A copy of the module tree whose leaves are this rank's shards on
    `mesh.device`, same names and dtypes, each with `.spec`, its sanitized
    spec. The leaves' full tensors are not copied (only the shards are
    moved), and `params` is left as it is. Int8 trees do not shard."""
    if any(not p.dtype.is_floating_point for p in params.parameters()):
        raise NotImplementedError("int8 trees (models/quantize.py) run on one card")
    specs = param_shardings(params, mesh)
    memo = {}
    for name, p in params.named_parameters():
        spec = specs[name.replace(".", "/")]
        with torch.no_grad():
            shard = local_slice(p, spec, mesh).to(mesh.device, copy=True).contiguous()
        leaf = nn.Parameter(shard, requires_grad=p.requires_grad)
        leaf.spec = spec
        memo[id(p)] = leaf
    return copy.deepcopy(params, memo)


def full_tensor(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard x (no autograd)."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            x = all_gather(x, mesh.group(axes), dim)
    return x


@torch.no_grad()
def unshard_params(params: nn.Module, mesh) -> nn.Module:
    """A copy of a sharded tree with every leaf whole again, on each rank
    (for export and checks)."""
    memo = {}
    for p in params.parameters():
        full = nn.Parameter(full_tensor(p.detach(), p.spec, mesh), requires_grad=False)
        memo[id(p)] = full
    return copy.deepcopy(params, memo)


def full_grads(params: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """{'a/b/c': the whole gradient} of a sharded tree's float leaves after a
    step's backward and reduction (zeros where a leaf has none)."""
    out = {}
    for name, p in params.named_parameters():
        if p.dtype.is_floating_point:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[name.replace(".", "/")] = full_tensor(g.detach(), p.spec, mesh)
    return out


# ---------------------------------------------------------------------------
# gathers where a leaf is used
# ---------------------------------------------------------------------------

KEEP, SUM, SPLIT = "keep", "sum", "split"  # what a gather does with a tensor-sharded dim


def gather_leaf(x: torch.Tensor, spec: Spec, mesh, tensor: str = SPLIT) -> torch.Tensor:
    """The leaf x (a shard, or a layer's view of one, with its spec) for use
    on this rank: gathered over fsdp (the gradient reduce-scattered back),
    and along its tensor-sharded dim as `tensor` says: KEEP leaves this
    rank's columns (an aligned tensor-parallel use), SUM gathers them for a
    use that is itself split over the tensor ranks (their gradients add),
    SPLIT gathers them for a use repeated on every tensor rank."""
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a == "fsdp":
                x = all_gather_rs(x, mesh.group("fsdp"), dim)
            elif a == "tensor" and tensor == SUM:
                x = all_gather_rs(x, mesh.group("tensor"), dim)
            elif a == "tensor" and tensor == SPLIT:
                x = all_gather_split(x, mesh.group("tensor"), dim)
            elif a != "tensor":
                raise ValueError(f"a parameter sharded over {a!r}: spec {spec}")
    return x


def layer_specs(group: nn.Module) -> Dict[str, Spec]:
    """{name: spec of one layer} of a stacked group's sharded leaves."""
    return {name: p.spec[1:] for name, p in group.named_parameters()}


def gather_layer(views: Mapping[str, torch.Tensor], specs: Mapping[str, Spec], mesh,
                 modes: Mapping[str, str] = {}) -> dict:
    """One layer's weights from its shards' views (`ParamGroup.layers()`):
    `gather_leaf` of each, modes {name: KEEP | SUM} (default SPLIT)."""
    return {name: gather_leaf(x, specs[name], mesh, modes.get(name, SPLIT))
            for name, x in views.items()}


def full_tree(module: nn.Module, mesh, skip: Tuple[str, ...] = ()):
    """A namespace mirroring `module` with every leaf gathered whole for
    use on every rank (`gather_leaf(..., SPLIT)`), the children named in
    `skip` kept as they are (a stacked group gathered a layer at a time)."""
    ns = SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, gather_leaf(p, p.spec, mesh))
    for name, child in module.named_children():
        setattr(ns, name, child if name in skip else full_tree(child, mesh, skip))
    return ns


def tensor_rows(n: int, mesh) -> Tuple[int, int]:
    """[lo, hi) of this rank's tensor-parallel part of n rows."""
    t = mesh.shape["tensor"]
    r = mesh.coords["tensor"]
    return r * n // t, (r + 1) * n // t


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def batch_pspecs(batch_tree) -> Any:
    """Every host-batch array shards on its leading (batch) axis: a tree of
    the batch's shape with specs for leaves (None stays None)."""
    def spec(x):
        if x is None:
            return None
        nd = x.dim() if isinstance(x, torch.Tensor) else len(getattr(x, "shape", ()))
        return (("data", "fsdp"),) + (None,) * (nd - 1) if nd >= 1 else ()

    if isinstance(batch_tree, tuple) and hasattr(batch_tree, "_fields"):
        return type(batch_tree)(*(spec(x) for x in batch_tree))
    return spec(batch_tree)


def dp_axes(b: int, mesh) -> Tuple[str, ...]:
    """The dp axes that b rows shard over: the live (data, fsdp) axes, or
    the largest dividing subgroup of them, as JAX's `_flash_sharded` picks."""
    live = tuple(a for a in ("data", "fsdp") if mesh.shape.get(a, 1) > 1)
    candidates = [live]
    if len(live) == 2:
        candidates += [(a,) for a in sorted(live, key=lambda a: -mesh.shape[a])]
    for cand in candidates:
        if b % math.prod(mesh.shape[a] for a in cand) == 0:
            return cand
    return ()


def shard_rows(x: Optional[torch.Tensor], axes: Tuple[str, ...], mesh):
    """This rank's rows of x over `axes` (None stays None)."""
    if x is None or not axes:
        return x
    return x.chunk(mesh.axis_size(axes), dim=0)[mesh.index(axes)]


def constrain_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's shard of the sequence axis (dim) over 'seq': the port's
    form of JAX's constraint, for activations equal on the seq ranks."""
    if mesh is None:
        return x
    return own_chunk(x, mesh.group("seq"), dim)


def seq_gather(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole sequence from the seq ranks' shards (no autograd)."""
    return all_gather(x, mesh.group("seq"), dim)
