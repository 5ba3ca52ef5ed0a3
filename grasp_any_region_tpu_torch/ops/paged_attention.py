"""Paged attention for continuous-batching decode
(`grasp_any_region_tpu/ops/paged_attention.py`).

KV lives in fixed page_size-token pages of a global pool, head-major
(K, N, page_size, D) per layer, and each sequence owns an ordered list of
page ids (its block table, serve/paged_cache.py). `paged_attention_reference`
gathers a sequence's pages and runs masked attention over them; it is plain
torch on every device, as it is XLA in the JAX package, which has no paged
Pallas kernel. The serving engine's windows (serve/engine.py) gather the
pages into a dense cache once a window and decode through kernel C; this
path serves the per-token `decode_chunk=1` mode.

Query convention: q is the current token of each slot; `seq_lens[b]`
counts every cached token including the current one (its K/V appended
before the call). Positions >= seq_lens are masked; nothing newer than the
query is in the cache, so causality is implicit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF


def paged_attention_reference(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (K, N, page_size, D): one layer's pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (B, max_pages) int page ids (0 = the trash page)
    seq_lens: torch.Tensor,  # (B,) int tokens cached, the current one included
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather the pages of every row, then attention masked past seq_lens:
    q scaled in its own dtype, fp32 logits and softmax, probabilities cast
    to the pool's dtype before the fp32 PV product, as in JAX. Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    kh, _, ps, _ = k_pages.shape
    mp = block_table.shape[1]
    if scale is None:
        scale = d ** -0.5
    bt = block_table.long()
    k = k_pages[:, bt].reshape(kh, b, mp * ps, d)  # (K, B, MP*PS, D)
    v = v_pages[:, bt].reshape(kh, b, mp * ps, d)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, kh, h // kh, d)
    logits = torch.einsum("bkgd,kbsd->bkgs", qf.float(), k.float())
    valid = torch.arange(mp * ps, device=q.device)[None, :] < seq_lens[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,kbsd->bkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, h, d).to(q.dtype)
