"""Ulysses sequence-parallel attention over the 'seq' axis
(`grasp_any_region_tpu/parallel/ulysses.py`).

Each of the P ranks of the seq axis holds (B, S/P, H, D) of q, k, v. An
all-to-all trades sequence shards for head shards, (B, S, H/P, D); the
full-sequence attention runs on each rank's heads (`mha`: kernel B on the
card, its backward kernels 17 and 18 where a gradient is needed); the
inverse all-to-all restores the sequence shards. H and the kv head count
must divide P, the classic Ulysses constraint; ring attention
(parallel/ring.py) lifts it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import mha
from .collectives import all_gather, all_to_all_df


def ulysses_attention(
    q: torch.Tensor,  # (B, S/P, H, D) this rank's sequence shard
    k: torch.Tensor,  # (B, S/P, K, D)
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S/P) packed rows' ids, this shard's
    right_padded: bool = True,
    axis: str = "seq",
) -> torch.Tensor:
    """Sequence-parallel attention; returns this rank's (B, S/P, H, D). The
    shards' segment ids are all-gathered to the full (B, S) inside."""
    h, kh = q.shape[2], k.shape[2]
    p = mesh.shape[axis]
    if h % p or kh % p:
        raise ValueError(f"heads ({h} q / {kh} kv) must divide the {axis} axis size {p}")
    group = mesh.group(axis)
    # (B, S/P, H, D) -> (B, S, H/P, D): split the heads, gather the sequence
    qh, khh, vh = (all_to_all_df(x, group, split_dim=2, concat_dim=1) for x in (q, k, v))
    seg = None if segment_ids is None else all_gather(segment_ids, group, dim=1)
    out = mha(qh, khh, vh, causal=causal, segment_ids=seg, right_padded=right_padded)
    return all_to_all_df(out, group, split_dim=1, concat_dim=2)
