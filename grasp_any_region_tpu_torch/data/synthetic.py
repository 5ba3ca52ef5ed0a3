"""Synthetic GARBatch builder for tests and benchmarks
(`grasp_any_region_tpu/data/synthetic.py:synthetic_batch`).

A structurally valid region-captioning sample without a real image or
tokenizer: image placeholder runs sized to the tile grid, one 256
crop-token run per region, trailing answer tokens. The arrays come from
numpy with the same seed and draws as the JAX builder, so both packages
see the same batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import GARConfig
from ..core.weights import require_device
from ..models.gar import GARBatch

IGNORE_INDEX = -100


def synthetic_batch(
    cfg: GARConfig,
    *,
    batch: int = 1,
    grid: Tuple[int, int] = (2, 1),  # (ncw, nch)
    regions: int = 1,
    seed: int = 0,
    device="cuda",
) -> Tuple[GARBatch, torch.Tensor, torch.Tensor]:
    """Returns (batch, labels, prompt_lens) as tensors on `device` (the
    card unless the caller asks for the CPU). Rows are not padded: every
    row's prompt length is S."""
    device = require_device(device)
    rng = np.random.default_rng(seed)
    ncw, nch = grid
    n_tiles = 1 + ncw * nch  # thumbnail + grid
    t_bucket = max(1 + cfg.max_num_tiles, n_tiles)
    tok = cfg.tokens_per_tile
    r_max = cfg.prompt_numbers
    assert regions <= r_max

    n_img = n_tiles * tok
    run = 256
    prefix = 4  # bos + chat preamble stand-ins
    q_text = 16
    answer_len = 32
    s = prefix + n_img + q_text + regions * (run + 2) + answer_len

    ids = np.full((batch, s), 0, np.int32)
    labels = np.full((batch, s), IGNORE_INDEX, np.int32)
    seg = np.ones((batch, s), np.int32)
    positions = np.tile(np.arange(s, dtype=np.int32), (batch, 1))
    replay_pos = np.zeros((batch, r_max), np.int32)
    replay_valid = np.zeros((batch, r_max), bool)
    bboxes = np.zeros((batch, r_max, 4), np.float32)

    for b in range(batch):
        cur = 0
        ids[b, cur] = 128000  # <|begin_of_text|>
        cur += 1
        ids[b, cur : cur + prefix - 1] = rng.integers(10, 1000, prefix - 1)
        cur += prefix - 1
        ids[b, cur : cur + n_img] = cfg.image_token_id
        cur += n_img
        ids[b, cur : cur + q_text] = rng.integers(10, 1000, q_text)
        cur += q_text
        for r in range(regions):
            ids[b, cur] = 128256 + r  # <Prompt_r>
            cur += 1
            replay_pos[b, r] = cur
            replay_valid[b, r] = True
            ids[b, cur : cur + run] = cfg.crop_token_ids[r]
            cur += run
            ids[b, cur] = rng.integers(10, 1000)
            cur += 1
            x1, y1 = rng.uniform(0, 0.5, 2)
            x2, y2 = x1 + rng.uniform(0.1, 0.5), y1 + rng.uniform(0.1, 0.5)
            bboxes[b, r] = [x1, y1, min(x2, 1.0), min(y2, 1.0)]
        ans = rng.integers(10, 1000, answer_len)
        ids[b, cur : cur + answer_len] = ans
        labels[b, cur : cur + answer_len] = ans

    pix = rng.standard_normal((batch, t_bucket, 3, cfg.tile_size, cfg.tile_size))
    pix = pix.astype(np.float32)
    pix[:, n_tiles:] = 0.0
    msk = np.zeros((batch, t_bucket, 3, cfg.tile_size, cfg.tile_size), np.float32)
    msk[:, :n_tiles, :, 100:300, 100:300] = 1.0

    def t(a):
        return torch.from_numpy(a).to(device)

    gb = GARBatch(
        input_ids=t(ids),
        positions=t(positions),
        segment_ids=t(seg),
        pixel_values=t(pix),
        mask_values=t(msk),
        aspect_ratio=t(np.tile(np.array([[ncw, nch]], np.int32), (batch, 1))),
        bboxes=t(bboxes),
        replay_pos=t(replay_pos),
        replay_valid=t(replay_valid),
        num_tiles=t(np.full((batch,), n_tiles, np.int32)),
    )
    return gb, t(labels), t(np.full((batch,), s, np.int32))
