"""The training dataset: region-caption and multi-region conversations from
annotation files (`grasp_any_region_tpu/data/dataset.py`).

  * sources: JSON list files, or `datasets.load_from_disk` directories for
    any other path (that package is imported only then); items carry
    `image` (a path, a `data:base64,` string or a PIL image),
    `conversations`, and optionally `mask_rle` (one COCO RLE dict or a list);
  * single-region items: the masks take shuffled prompt slots, one QA turn
    a mask with 256 crop tokens in its question, instruction augmentation,
    and now and then a "<PromptX> is not in the image" turn for a spare slot;
  * multi-region items: the conversations already reference <PromptK>;
    the objects preamble and the crop runs go before the first user turn;
  * items without masks caption the whole image;
  * first-fill-wins prompt ids and normalized boxes, the chat template,
    and a bounded refetch in `__getitem__`.

Every random draw is JAX's, in JAX's order, so `build_item` gives JAX's
arrays for the same file. Images decode through `data/png.py` when they are
PNGs; other formats need PIL, imported only for them. Masks decode through
the native RLE codec and images resize through the native resampler
(`data/native.py`), as JAX's do when its library is built.

Samples feed `data/builders.collate_samples(with_labels=True)`.
"""

from __future__ import annotations

import base64
import json
import random
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import GARConfig
from .chat import ChatMessage, apply_chat_template, find_crop_runs
from .image_processor import GARImageProcessor, ImageProcessorConfig
from .png import decode_image
from .prompts import augment_instruction, bbox_from_mask, negative_prompt_answer, rasterize_prompts
from .resize import resize_nearest
from .rle import decode_any
from .tokenizer import GARTokenizer, reserved_special_token

PROMPT_RE = re.compile(r"<Prompt(\d+)>")


@dataclass
class DatasetConfig:
    annotation_paths: Sequence[str] = ()
    max_length: int = 16384
    prompt_augmentation: bool = True
    negative_prob: float = 0.05
    repeat_time: int = 1
    seed: int = 42
    max_refetch: int = 1000


def load_image(entry) -> np.ndarray:
    """An item's `image` as (H, W, 3) uint8 RGB: a PIL image, a
    `data:base64,` string or a file path."""
    if hasattr(entry, "convert"):  # a PIL image (datasets rows)
        return np.asarray(entry.convert("RGB"))
    if isinstance(entry, str) and entry.startswith("data:base64,"):
        raw = base64.b64decode(entry[len("data:base64,"):])
    else:
        with open(entry, "rb") as f:
            raw = f.read()
    return decode_image(raw)


class GraspAnyRegionDataset:
    """Index-addressable training dataset."""

    def __init__(self, cfg: GARConfig, tok: GARTokenizer, ds_cfg: DatasetConfig,
                 proc: Optional[GARImageProcessor] = None):
        self.cfg = cfg
        self.tok = tok
        self.ds_cfg = ds_cfg
        self.proc = proc or GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles))
        self.sources: List = []
        self.lengths: List[int] = []
        for path in ds_cfg.annotation_paths:
            if path.endswith(".json"):
                with open(path) as f:
                    src = json.load(f)
            else:
                from datasets import load_from_disk

                src = load_from_disk(path)
            self.sources.append(src)
            self.lengths.append(len(src))
        self.total = sum(self.lengths)

    def __len__(self) -> int:
        return self.total * self.ds_cfg.repeat_time

    def modality_lengths(self) -> List[int]:
        """A length estimate an item for length-grouped batching: the
        conversation's characters / 4 plus 256 replay tokens a region; a
        constant where the annotations cannot be read without decoding."""
        per_source: List[List[int]] = []
        try:
            for src in self.sources:
                if isinstance(src, list):
                    convs = [a.get("conversations", []) for a in src]
                else:  # an arrow dataset: one column fetch, no image decode
                    convs = src["conversations"]
                lens = []
                for conv in convs:
                    chars = sum(len(c.get("value", "")) for c in conv)
                    n_regions = max(1, sum(1 for c in conv if c.get("from") == "gpt"))
                    lens.append(chars // 4 + 256 * n_regions)
                per_source.append(lens)
        except (KeyError, TypeError, AttributeError, ValueError):
            return [100] * len(self)
        flat = [n for lens in per_source for n in lens]
        return (flat * self.ds_cfg.repeat_time)[: len(self)]

    def _raw(self, index: int) -> dict:
        index = index % self.total
        for src, n in zip(self.sources, self.lengths):
            if index < n:
                return dict(src[index])
            index -= n
        raise IndexError(index)

    def _build_conversation(self, ann: dict, image: np.ndarray, rng: random.Random
                            ) -> Tuple[List[ChatMessage], Dict[int, np.ndarray]]:
        """(messages, prompt id -> mask)."""
        h, w = image.shape[:2]
        captions = [c["value"] for c in ann["conversations"] if c["from"] == "gpt"]
        if ann.get("mask_rle") is not None:
            masks = decode_any(ann["mask_rle"])
        else:
            masks = [np.ones((h, w), np.uint8)] * len(captions)
        masks = [m if m.shape == (h, w) else resize_nearest(m, h, w) for m in masks]

        conv_text = "\n".join(c["value"] for c in ann["conversations"])
        referenced = sorted({int(m) for m in PROMPT_RE.findall(conv_text)})
        if referenced:  # multi-region: the preamble and crop runs open the first turn
            objects_desc = "There are some objects I am curious about: "
            sub_desc = ""
            mask_by_pid: Dict[int, np.ndarray] = {}
            for pid in referenced:
                objects_desc += f"<Prompt{pid}>; "
                sub_desc += f"<Prompt{pid}>: {reserved_special_token(pid) * 256}\n"
                mask_by_pid[pid] = masks[pid]
            msgs: List[ChatMessage] = []
            for i, c in enumerate(ann["conversations"]):
                role = "user" if c["from"] == "human" else "assistant"
                value = c["value"]
                if i == 0:
                    value = objects_desc + "\n" + sub_desc + "\n" + value
                msgs.append(ChatMessage(role, value))
            return msgs, mask_by_pid

        # single-region: the masks take shuffled prompt slots
        slots = list(range(self.cfg.prompt_numbers))
        rng.shuffle(slots)
        n_sel = min(len(masks), self.cfg.prompt_numbers - 1)
        selected, spare = slots[:n_sel], slots[n_sel:]
        np_rng = np.random.default_rng(rng.getrandbits(32))

        def instruction(caption: str) -> str:
            if self.ds_cfg.prompt_augmentation:
                return augment_instruction(np_rng, caption)
            return "Describe this masked region in detail."

        objects_desc = ("There are some objects I am curious about: "
                        + "; ".join(f"<Prompt{p}>" for p in selected) + "; ")
        msgs = []
        mask_by_pid = {}
        none_prompt_left = bool(spare)
        for i in range(n_sel):
            pid = selected[i]
            q = f"<Prompt{pid}>: {reserved_special_token(pid) * 256}{instruction(captions[i])}"
            if i == 0:
                q = objects_desc + "\n" + q
            elif none_prompt_left and rng.random() < self.ds_cfg.negative_prob:
                neg = spare[0]
                msgs.append(ChatMessage("user", f"<Prompt{neg}>: {instruction(captions[i])}"))
                msgs.append(ChatMessage("assistant", negative_prompt_answer(neg)))
                none_prompt_left = False
            msgs.append(ChatMessage("user", q))
            msgs.append(ChatMessage("assistant", captions[i]))
            mask_by_pid[pid] = masks[i]
        return msgs, mask_by_pid

    def build_item(self, index: int, rng: Optional[random.Random] = None) -> dict:
        """One sample's numpy arrays (`data/builders.build_sample`'s fields)."""
        rng = rng or random.Random(self.ds_cfg.seed + index)
        ann = self._raw(index)
        image = load_image(ann["image"])
        h, w = image.shape[:2]
        msgs, mask_by_pid = self._build_conversation(ann, image, rng)

        vp = rasterize_prompts(mask_by_pid, h, w, self.cfg.prompt_numbers)
        pre = self.proc.preprocess(image, vp, max_num_tiles=self.cfg.max_num_tiles)
        n_tiles = pre["num_tiles"]
        # the image placeholder opens the first user turn
        msgs[0] = ChatMessage(msgs[0].role, self.tok.image_token + msgs[0].content)
        ids = np.asarray(apply_chat_template(self.tok, msgs, num_tiles_per_image=[n_tiles],
                                             tokens_per_tile=self.cfg.tokens_per_tile), np.int32)
        if len(ids) > self.ds_cfg.max_length:
            raise ValueError(f"sample {index} length {len(ids)} > max_length")

        runs = find_crop_runs(ids, self.cfg.crop_token_ids)
        bboxes = np.zeros((len(runs), 4), np.float32)
        replay_pos = np.zeros((len(runs),), np.int32)
        for i, (pid, start, length) in enumerate(runs):
            if length % 256:
                raise ValueError(f"sample {index}: a crop run of {length} tokens")
            bboxes[i] = bbox_from_mask(mask_by_pid[pid])
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

    def __getitem__(self, index: int) -> dict:
        """`build_item`, refetching a random other item (at most
        `max_refetch` times) when an item fails; the last error is raised."""
        rng = random.Random(self.ds_cfg.seed + index)
        last_err: Optional[Exception] = None
        for _ in range(self.ds_cfg.max_refetch):
            try:
                return self.build_item(index, rng)
            except Exception as e:  # noqa: BLE001 - a bad item is data, not a bug
                last_err = e
                index = rng.randrange(self.total)
        raise RuntimeError(f"exhausted refetch budget; last error: {last_err!r}") from last_err


def length_grouped_indices(lengths: Sequence[int], batch_size: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Shuffle, then sort by length within megabatches of 50 batches, so the
    samples of a step have similar lengths."""
    idx = rng.permutation(len(lengths))
    mega = 50 * batch_size
    out = []
    for i in range(0, len(idx), mega):
        chunk = idx[i: i + mega]
        out.append(chunk[np.argsort(np.asarray(lengths)[chunk], kind="stable")])
    return np.concatenate(out)
