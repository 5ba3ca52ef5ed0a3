"""Packed text-only rows for training (`grasp_any_region_tpu/data/builders.py`:
`PackedTextBatch`, `pack_text_batch`).

Many documents share each static (B, L) row and a block-diagonal segment
mask inside the flash kernel replaces the reference's varlen cu_seqlens:
padding has segment id 0, documents 1..n per row, positions restart at 0
per document. The packing is numpy (first-fit decreasing, as in JAX), then
the arrays become tensors on the device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import ASSISTANT_ROLE_ID, END_HEADER_ID, EOT_TOKEN_ID, NEWLINE2_ID, START_HEADER_ID
from ..core.weights import require_device
from ..train.losses import IGNORE_INDEX


class PackedTextBatch(NamedTuple):
    input_ids: torch.Tensor  # (B, L) int32
    positions: torch.Tensor  # (B, L) int32, reset per document
    segment_ids: torch.Tensor  # (B, L) int32, 0 = pad
    labels: torch.Tensor  # (B, L) int32, -100 where unsupervised


def mask_labels(input_ids: np.ndarray) -> np.ndarray:
    """Supervise only assistant spans: tokens strictly after
    [<|start_header_id|>, assistant, <|end_header_id|>, "\\n\\n"] up to and
    including <|eot_id|> (`grasp_any_region_tpu/data/chat.py:mask_labels`)."""
    start = np.array([START_HEADER_ID, ASSISTANT_ROLE_ID, END_HEADER_ID, NEWLINE2_ID])
    ids = np.asarray(input_ids)
    labels = np.full_like(ids, IGNORE_INDEX)
    i, n = 0, len(ids)
    while i < n:
        if i + 4 <= n and np.array_equal(ids[i:i + 4], start):
            s = i + 4
            ends = np.nonzero(ids[s:] == EOT_TOKEN_ID)[0]
            if len(ends) == 0:
                break
            e = s + int(ends[0])
            labels[s:e + 1] = ids[s:e + 1]
            i = e + 1
        else:
            i += 1
    return labels


def pack_text_batch(token_seqs: Sequence[np.ndarray], *, seq_len: int, pad_id: int = 0,
                    labels: Optional[Sequence[np.ndarray]] = None,
                    device="cuda") -> PackedTextBatch:
    """First-fit-decreasing packing of tokenized documents into rows of
    seq_len, each truncated to seq_len. labels default to the chat-template
    supervision (`mask_labels`). The tensors land on `device`, the card
    unless the caller asks for the CPU."""
    device = require_device(device)
    seqs = [np.asarray(s, np.int32)[:seq_len] for s in token_seqs]
    if labels is None:
        labs = [mask_labels(s) for s in seqs]
    else:
        if len(labels) != len(seqs):
            raise ValueError(f"{len(labels)} label arrays for {len(seqs)} documents")
        labs = [np.asarray(lab, np.int32)[:seq_len] for lab in labels]
        if any(len(lab) != len(s) for lab, s in zip(labs, seqs)):
            raise ValueError("each label array must match its document's length")

    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]), reverse=True)
    rows: List[List[int]] = []
    space: List[int] = []
    for i in order:
        n = len(seqs[i])
        for r, free in enumerate(space):
            if free >= n:
                rows[r].append(i)
                space[r] -= n
                break
        else:
            rows.append([i])
            space.append(seq_len - n)

    b = len(rows)
    ids = np.full((b, seq_len), pad_id, np.int32)
    pos = np.zeros((b, seq_len), np.int32)
    seg = np.zeros((b, seq_len), np.int32)
    lab = np.full((b, seq_len), IGNORE_INDEX, np.int32)
    for r, members in enumerate(rows):
        off = 0
        for s_no, i in enumerate(members, start=1):
            n = len(seqs[i])
            ids[r, off:off + n] = seqs[i]
            pos[r, off:off + n] = np.arange(n)
            seg[r, off:off + n] = s_no
            lab[r, off:off + n] = labs[i]
            off += n
    return PackedTextBatch(*(torch.from_numpy(a).to(device) for a in (ids, pos, seg, lab)))
