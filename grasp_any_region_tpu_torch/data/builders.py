"""Model-input builders (`grasp_any_region_tpu/data/builders.py`).

(image, masks, question) -> `GARBatch`: `build_sample` and
`build_video_sample` preprocess one request in numpy, as the JAX package
does, so their arrays equal JAX's bit for bit; `collate_samples` pads a
list of them to the batch's static shapes (the tile bucket, the regions,
the prompt length rounded up to SEQ_BUCKET) and makes the tensors on the
device, the card unless the caller asks for the CPU. Any number of
samples batch together.

Also the packed text-only rows for training (`PackedTextBatch`,
`pack_text_batch`): many documents share each static (B, L) row and a
block-diagonal segment mask inside the flash kernel takes the place of
varlen sequence offsets: padding has segment id 0, documents 1..n per row,
positions restart at 0 per document. The packing is numpy (first-fit
decreasing, as in JAX), then the arrays become tensors on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import VIDEO_TOKEN_ID, GARConfig
from ..core.weights import require_device
from ..models.gar import GARBatch
from ..train.losses import IGNORE_INDEX
from .chat import ChatMessage, apply_chat_template, find_crop_runs, mask_labels
from .image_processor import GARImageProcessor
from .prompts import bbox_from_mask, multi_region_question, rasterize_prompts, single_region_question
from .tokenizer import GARTokenizer, reserved_special_token

__all__ = ["SEQ_BUCKET", "RegionSample", "VideoRegionSample", "build_sample", "collate_samples",
           "build_region_batch", "build_video_sample", "build_video_batch", "mask_labels",
           "PackedTextBatch", "pack_text_batch"]

SEQ_BUCKET = 128  # prompt lengths pad up to a multiple of this


@dataclass
class RegionSample:
    """One image request.

    image: (H, W, 3) uint8 RGB
    masks: prompt_id -> (H, W) binary mask
    question: text containing <PromptK> references (multi-region), or None
        for the canonical single-region caption question of the one mask
    instruction: the single-region instruction
    """

    image: np.ndarray
    masks: Dict[int, np.ndarray]
    question: Optional[str] = None
    instruction: str = "Describe this masked region in detail."


@dataclass
class VideoRegionSample:
    """One video region question: per-frame crop tokens
    reserved_{2 + frame index}.

    frames: list of (H, W, 3) uint8 RGB frames (sampled)
    masks: frame index -> (H, W) binary mask of the region in that frame
    question: free-form question about the region
    """

    frames: List[np.ndarray]
    masks: Dict[int, np.ndarray]
    question: str = "Describe this masked region in detail."


def build_sample(
    cfg: GARConfig,
    tok: GARTokenizer,
    proc: GARImageProcessor,
    sample: RegionSample,
    *,
    reference_bbox_compat: bool = False,
) -> dict:
    """Preprocess one sample into unpadded numpy arrays.

    reference_bbox_compat takes every region's box from the LAST mask, as
    the reference's multi-region evaluation did (a stale loop variable);
    only for bit-exact parity with its outputs.
    """
    img = np.asarray(sample.image)
    h, w = img.shape[:2]
    masks = {pid: np.asarray(m) for pid, m in sample.masks.items()}
    for pid, m in masks.items():
        assert m.shape[:2] == (h, w), f"mask {pid} shape {m.shape} != image {(h, w)}"

    if sample.question is None:
        assert len(masks) == 1, "single-region path expects exactly one mask"
        pid = next(iter(masks))
        text = single_region_question(pid, sample.instruction)
    else:
        text, order = multi_region_question(sample.question)
        assert set(order) == set(masks), (
            f"question references prompts {order} but masks given for {sorted(masks)}"
        )

    vp = rasterize_prompts(masks, h, w, cfg.prompt_numbers)
    pre = proc.preprocess(img, vp, max_num_tiles=cfg.max_num_tiles)
    n_tiles = pre["num_tiles"]

    msgs = [ChatMessage(role="user", content=tok.image_token + text)]
    ids = apply_chat_template(
        tok, msgs, add_generation_prompt=True,
        num_tiles_per_image=[n_tiles], tokens_per_tile=cfg.tokens_per_tile,
    )
    ids = np.asarray(ids, np.int32)

    runs = find_crop_runs(ids, cfg.crop_token_ids)
    bboxes = np.zeros((len(runs), 4), np.float32)
    replay_pos = np.zeros((len(runs),), np.int32)
    last_pid = max(masks) if masks else 0
    for i, (pid, start, length) in enumerate(runs):
        assert length == cfg.tokens_per_tile == 256, f"crop run {length} != 256"
        src = masks[last_pid] if reference_bbox_compat else masks[pid]
        bboxes[i] = bbox_from_mask(src)
        replay_pos[i] = start

    return {
        "input_ids": ids,
        "pixel_values": pre["pixel_values"],
        "mask_values": pre["mask_values"],
        "aspect_ratio": np.asarray(pre["aspect_ratio"], np.int32),
        "num_tiles": n_tiles,
        "bboxes": bboxes,
        "replay_pos": replay_pos,
    }


def collate_samples(
    cfg: GARConfig,
    samples: Sequence[dict],
    *,
    pad_id: int = 0,
    max_regions: Optional[int] = None,
    seq_bucket: int = SEQ_BUCKET,
    with_labels: bool = False,
    seq_multiple: int = 1,
    pad_to_len: Optional[int] = None,
    device="cuda",
) -> Tuple[GARBatch, torch.Tensor, Optional[torch.Tensor]]:
    """Pad per-sample arrays to the batch's static shapes, right padding
    throughout. Returns (GARBatch, prompt_lens, labels or None) as tensors
    on `device`. The tiles pad to 1 + max_num_tiles rows; seq_multiple
    also rounds the length up to a multiple of a sequence-parallel world
    size, and pad_to_len fixes it. `replay_tile` is set only when a sample
    carries one (video), else None.
    """
    device = require_device(device)
    b = len(samples)
    r_max = max_regions or cfg.prompt_numbers
    t_bucket = max(1 + cfg.max_num_tiles, max(s["pixel_values"].shape[0] for s in samples))
    s_max = max(len(s["input_ids"]) for s in samples)
    s_pad = ((s_max + seq_bucket - 1) // seq_bucket) * seq_bucket
    if seq_multiple > 1 and s_pad % seq_multiple:
        s_pad += seq_multiple - s_pad % seq_multiple
    if pad_to_len is not None:
        assert s_max <= pad_to_len, f"sample length {s_max} exceeds pad_to_len {pad_to_len}"
        assert pad_to_len % max(1, seq_multiple) == 0
        s_pad = pad_to_len
    ts = cfg.tile_size

    input_ids = np.full((b, s_pad), pad_id, np.int32)
    positions = np.zeros((b, s_pad), np.int32)
    segs = np.zeros((b, s_pad), np.int32)
    labels = np.full((b, s_pad), IGNORE_INDEX, np.int32)
    pix = np.zeros((b, t_bucket, 3, ts, ts), np.float32)
    msk = np.zeros((b, t_bucket, 3, ts, ts), np.float32)
    aspect = np.ones((b, 2), np.int32)
    bboxes = np.zeros((b, r_max, 4), np.float32)
    rpos = np.zeros((b, r_max), np.int32)
    rvalid = np.zeros((b, r_max), bool)
    ntiles = np.zeros((b,), np.int32)
    plens = np.zeros((b,), np.int32)
    has_video = any("replay_tile" in s for s in samples)
    rtile = np.zeros((b, r_max), np.int32)

    for i, s in enumerate(samples):
        n = len(s["input_ids"])
        input_ids[i, :n] = s["input_ids"]
        positions[i, :n] = np.arange(n)
        positions[i, n:] = max(n - 1, 0)
        segs[i, :n] = 1
        if with_labels:
            labels[i, :n] = mask_labels(s["input_ids"])
        t = s["pixel_values"].shape[0]
        pix[i, :t] = s["pixel_values"]
        if s.get("mask_values") is not None:
            msk[i, :t] = s["mask_values"]
        aspect[i] = s["aspect_ratio"]
        r = len(s["replay_pos"])
        assert r <= r_max
        bboxes[i, :r] = s["bboxes"]
        rpos[i, :r] = s["replay_pos"]
        rvalid[i, :r] = True
        if "replay_tile" in s:
            rtile[i, :r] = s["replay_tile"]
        ntiles[i] = s["num_tiles"]
        plens[i] = n

    def t(a):
        return torch.from_numpy(a).to(device)

    batch = GARBatch(
        input_ids=t(input_ids), positions=t(positions), segment_ids=t(segs),
        pixel_values=t(pix), mask_values=t(msk), aspect_ratio=t(aspect), bboxes=t(bboxes),
        replay_pos=t(rpos), replay_valid=t(rvalid), num_tiles=t(ntiles),
        replay_tile=t(rtile) if has_video else None,
    )
    return batch, t(plens), (t(labels) if with_labels else None)


def build_video_sample(
    cfg: GARConfig,
    tok: GARTokenizer,
    proc: GARImageProcessor,
    sample: VideoRegionSample,
) -> dict:
    """Preprocess one video sample: each frame is one 448 x 448 tile (no
    thumbnail and grid), the placeholders are <|video|>, and each annotated
    frame has its own crop run."""
    frames = [np.asarray(f) for f in sample.frames]
    n_frames = len(frames)
    pix = [proc.preprocess(f, max_num_tiles=1)["pixel_values"][0]  # the thumbnail is the tile
           for f in frames]
    pixel_values = np.stack(pix)  # (F, 3, T, T)

    runs_text = ""
    for fi in sorted(sample.masks):
        assert 0 <= fi < n_frames
        runs_text += f"Frame {fi}: {reserved_special_token(fi) * 256}\n"
    text = runs_text + sample.question

    msgs = [ChatMessage(role="user", content="<|video|>" + text)]
    ids_np = np.asarray(apply_chat_template(tok, msgs, add_generation_prompt=True), np.int32)
    # the one video placeholder expands to frames * tokens_per_tile
    vid_pos = int(np.nonzero(ids_np == VIDEO_TOKEN_ID)[0][0])
    expanded = np.concatenate([
        ids_np[:vid_pos],
        np.full(n_frames * cfg.tokens_per_tile, VIDEO_TOKEN_ID, np.int32),
        ids_np[vid_pos + 1:],
    ])

    runs = find_crop_runs(expanded, cfg.crop_token_ids)
    bboxes = np.zeros((len(runs), 4), np.float32)
    replay_pos = np.zeros((len(runs),), np.int32)
    replay_tile = np.zeros((len(runs),), np.int32)
    for i, (pid, start, length) in enumerate(runs):
        assert length == 256
        bboxes[i] = bbox_from_mask(np.asarray(sample.masks[pid]))
        replay_pos[i] = start
        replay_tile[i] = pid  # frame index == crop slot index

    return {
        "input_ids": expanded,
        "pixel_values": pixel_values,
        "mask_values": np.zeros_like(pixel_values),
        "aspect_ratio": np.asarray([1, 1], np.int32),
        "num_tiles": n_frames,
        "bboxes": bboxes,
        "replay_pos": replay_pos,
        "replay_tile": replay_tile,
    }


def build_video_batch(
    cfg: GARConfig,
    tok: GARTokenizer,
    proc: GARImageProcessor,
    samples: Sequence[VideoRegionSample],
    **collate_kw,
) -> Tuple[GARBatch, torch.Tensor]:
    built = [build_video_sample(cfg, tok, proc, s) for s in samples]
    batch, plens, _ = collate_samples(cfg, built, **collate_kw)
    return batch, plens


def build_region_batch(
    cfg: GARConfig,
    tok: GARTokenizer,
    proc: GARImageProcessor,
    samples: Sequence[RegionSample],
    **collate_kw,
) -> Tuple[GARBatch, torch.Tensor]:
    built = [build_sample(cfg, tok, proc, s) for s in samples]
    batch, plens, _ = collate_samples(cfg, built, **collate_kw)
    return batch, plens


class PackedTextBatch(NamedTuple):
    input_ids: torch.Tensor  # (B, L) int32
    positions: torch.Tensor  # (B, L) int32, reset per document
    segment_ids: torch.Tensor  # (B, L) int32, 0 = pad
    labels: torch.Tensor  # (B, L) int32, -100 where unsupervised


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
