"""The collectives of the sharded paths, as `torch.autograd.Function`s.

JAX has no counterpart: GSPMD inserts its collectives. The port runs one
process a rank and calls them itself. Gradients follow the Megatron
convention over `tensor`: activations outside a tensor-parallel region are
equal on every tensor rank and so are their gradients; `copy_to` enters a
region (identity, all-reduce of the gradient), `reduce_from` and
`all_gather_split` leave it (all-reduce, resp. all-gather, with the
gradient passed, resp. sliced, as it is). Over fsdp, data and seq each
rank holds other rows or tokens, so gradients add: `all_gather_rs`
(all-gather forward, reduce-scatter backward) gathers an fsdp shard, and
`reduce_from` over those axes makes a loss global while each rank
back-propagates its own part.

Every function takes a process group from `Mesh.group`; None (an axis of
one rank) makes it the identity. NCCL groups, and gloo groups for the
collectives, take CUDA tensors as they are; gloo's point-to-point sends do
not (on the H100 machine's torch 2.11 its all_reduce, all_gather,
reduce_scatter and all_to_all_single take them, batch_isend_irecv fails
writing a device address to its socket), so the point-to-point
`send_recv` (the ring's shift, the pipeline's ticks) and `broadcast` on a
gloo group stage CUDA tensors through pinned host memory, and only there:
the path of several ranks on one card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _host(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of x over the group (a new tensor)."""
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along dim, in group-rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk along dim of the sum of x over the group."""
    if group is None:
        return x
    chunks = [c.contiguous() for c in x.chunk(group_size(group), dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def all_to_all(x: torch.Tensor, group: Group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split x along split_dim into one chunk a rank, send chunk j to rank
    j, and concatenate the chunks received along concat_dim (JAX's tiled
    `all_to_all`)."""
    if group is None:
        return x
    send = torch.stack(x.chunk(group_size(group), dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def send_recv(sends: List[Tuple[int, torch.Tensor]], recvs: List[Tuple[int, torch.Tensor]],
              group: Group) -> List[torch.Tensor]:
    """One step's point-to-point traffic, posted as one `batch_isend_irecv`
    on each rank, so that two ranks that both send first cannot deadlock.
    sends: [(group rank of the peer, tensor)]; recvs: [(group rank of the
    peer, a tensor whose shape, dtype and device the received one takes)].
    Returns the received tensors in the order of recvs. Messages between
    one pair of ranks match in the order they are posted. Under NCCL the
    first call over a group must include every rank of it."""
    if not sends and not recvs:
        return []
    staged = _staged((sends or recvs)[0][1], group)
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged
            else torch.empty(t.shape, dtype=t.dtype, device=t.device) for _, t in recvs]
    ops = [dist.P2POp(dist.isend, _host(t) if staged else t.contiguous(),
                      dist.get_global_rank(group, peer), group) for peer, t in sends]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group)
            for (peer, _), buf in zip(recvs, bufs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(t.device) for buf, (_, t) in zip(bufs, recvs)] if staged else bufs


def ring_shift(tensors: List[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """Each tensor sent to the next rank of the group and received from the
    previous one (JAX's `ppermute` with perm j -> j + 1 mod n)."""
    if group is None:
        return list(tensors)
    n, r = group_size(group), group_rank(group)
    return send_recv([((r + 1) % n, t) for t in tensors], [((r - 1) % n, t) for t in tensors],
                     group)


def broadcast(x: torch.Tensor, group: Group, src: int) -> torch.Tensor:
    """x of the group's rank src on every rank of the group (in place on x,
    which the other ranks pass as the buffer of its shape and dtype)."""
    if group is None:
        return x
    staged = _staged(x, group)
    buf = _host(x) if staged else x
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return x.copy_(buf) if staged else x


def own_chunk(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk of x along dim (a view; plain slicing backward)."""
    if group is None:
        return x
    return x.chunk(group_size(group), dim=dim)[group_rank(group)]


# ---------------------------------------------------------------------------
# differentiable forms
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllGatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return own_chunk(g, ctx.group, ctx.dim).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient: x enters a region whose
    ranks each back-propagate a part of its gradient."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """All-reduce forward, the gradient passed as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather_rs(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """All-gather forward, reduce-scatter of the gradient: a shard gathered
    for ranks whose gradients add (an fsdp shard)."""
    return x if group is None else _AllGatherRS.apply(x, group, dim)


def all_gather_split(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """All-gather forward, this rank's chunk of the gradient: the ranks
    continue with equal values and equal gradients."""
    return x if group is None else _AllGatherSplit.apply(x, group, dim)


def all_to_all_df(x: torch.Tensor, group: Group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """`all_to_all`, its backward the inverse exchange."""
    return x if group is None else _AllToAll.apply(x, group, split_dim, concat_dim)
