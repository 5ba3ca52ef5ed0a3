"""Synthetic data for tests, benchmarks and dry runs
(`grasp_any_region_tpu/data/synthetic.py`).

`synthetic_batch`: a structurally valid region-captioning sample without a
real image or tokenizer: image placeholder runs sized to the tile grid,
one 256 crop-token run per region, trailing answer tokens.
`write_synthetic_annotations`: an annotation file of synthetic items that
the training dataset reads. Both draw from numpy with the same seed and in
the same order as the JAX builders, so both packages see the same batch
and the same images, masks and conversations.
"""

from __future__ import annotations

import base64
import json
from typing import Tuple

import numpy as np
import torch

from ..core.config import GARConfig
from ..core.weights import require_device
from ..models.gar import GARBatch
from .png import write_png
from .rle import encode_rle

IGNORE_INDEX = -100


def write_synthetic_annotations(
    path: str,
    *,
    n_items: int = 64,
    image_size: Tuple[int, int] = (448, 336),  # (w, h)
    seed: int = 0,
) -> str:
    """Write a `GraspAnyRegionDataset` annotation JSON of synthetic
    region-captioning items (base64 PNG images, compressed-RLE masks,
    human / gpt conversations), so `cli/train.py --data` runs with no
    external asset. Items cycle through the three styles the dataset
    reads: per-region caption lists, a two-region <PromptK> conversation,
    and a whole-image caption. The PNGs come from `data/png.py` (JAX's from
    PIL: other bytes, the same pixels)."""
    rng = np.random.default_rng(seed)
    w, h = image_size

    def b64_image():
        pixels = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        return "data:base64," + base64.b64encode(write_png(pixels)).decode()

    def rand_masks(n):
        out = []
        for _ in range(n):
            m = np.zeros((h, w), np.uint8)
            x1, y1 = rng.integers(0, w // 2), rng.integers(0, h // 2)
            bw, bh = rng.integers(w // 8, w // 2), rng.integers(h // 8, h // 2)
            m[y1: min(y1 + bh, h), x1: min(x1 + bw, w)] = 1
            rle = encode_rle(m)
            out.append({"size": rle["size"], "counts": rle["counts"].decode()})
        return out

    nouns = ["box", "region", "patch", "area", "object", "shape"]
    adjs = ["red", "blue", "small", "large", "bright", "dark"]

    def caption():
        return f"a {rng.choice(adjs)} {rng.choice(nouns)}. It is {rng.choice(adjs)}."

    items = []
    for i in range(n_items):
        style = i % 3
        if style == 0:  # single-region captions (one Q/A pair per mask)
            k = int(rng.integers(1, 3))
            conv = []
            for _ in range(k):
                conv += [{"from": "human", "value": "placeholder"},
                         {"from": "gpt", "value": caption()}]
            items.append({"image": b64_image(), "mask_rle": rand_masks(k),
                          "conversations": conv})
        elif style == 1:  # multi-region relationship conversation
            items.append({
                "image": b64_image(),
                "mask_rle": rand_masks(2),
                "conversations": [
                    {"from": "human", "value": "Is <Prompt0> above <Prompt1>?"},
                    {"from": "gpt", "value": str(rng.choice(["Yes.", "No."]))},
                ],
            })
        else:  # whole-image caption (no masks)
            items.append({
                "image": b64_image(),
                "conversations": [
                    {"from": "human", "value": "placeholder"},
                    {"from": "gpt", "value": caption()},
                ],
            })
    with open(path, "w") as f:
        json.dump(items, f)
    return path


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
