"""GAR-Bench inference + VQA scoring (`grasp_any_region_tpu/evaluation/
garbench.py`).

Modes (GAR-Bench/inference.py:124-134):
  vqa      — multiple-choice, "Answer with the correct option's letter
             directly."; scored inline by exact match per category (:185-203)
  simple   — item's own question (GPT-4o judged downstream)
  detailed — fixed relationship question between <Prompt0> and <Prompt1>

Output json keeps the reference's schema (item + "model_output") so the
shipped judge scripts and golden caches interoperate. Images read through
`data/png.read_image` (PNG without PIL).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from ..data.builders import RegionSample
from ..data.png import read_image
from ..data.rle import decode_rle
from .engine import BatchedCaptioner, write_outputs

DETAILED_QUESTION = (
    "Describe <Prompt0> in detail, including the relationship with <Prompt1>."
)


def build_question(item: dict, mode: str) -> str:
    if mode == "vqa":
        q = f"Question: {item['question']}\nOptions:"
        for op in item["choices"]:
            q += f"\n{op}"
        q += "\nAnswer with the correct option's letter directly."
        return q
    if mode == "simple":
        return item["question"]
    if mode == "detailed":
        return DETAILED_QUESTION
    raise ValueError(mode)


def item_to_sample(item: dict, image_folder: str, mode: str) -> RegionSample:
    img = read_image(os.path.join(image_folder, item["image"]))
    masks = {}
    for pid, rle in enumerate(item["mask_rles"]):
        masks[pid] = decode_rle(rle)
    question = build_question(item, mode)
    # restrict masks to the prompts the question references
    refs = {int(m) for m in re.findall(r"<Prompt(\d+)>", question)}
    masks = {pid: m for pid, m in masks.items() if pid in refs} or masks
    if not refs:  # question without <PromptK>: treat mask 0 as <Prompt0>
        question = f"<Prompt0>: {question}"
        masks = {0: masks[0]}
        refs = {0}
    missing = refs - set(masks)
    if missing:
        raise ValueError(f"question references {missing} but item has "
                         f"{len(item['mask_rles'])} masks")
    return RegionSample(image=img, masks=masks, question=question)


def run_garbench(
    captioner: BatchedCaptioner,
    anno_file: str,
    image_folder: str,
    mode: str,
    out_path: str,
    limit: Optional[int] = None,
) -> List[dict]:
    with open(anno_file) as f:
        items = json.load(f)
    if limit:
        items = items[:limit]
    samples = [item_to_sample(it, image_folder, mode) for it in items]
    outputs = captioner.run(samples)
    for it, out in zip(items, outputs):
        it["model_output"] = out.replace("<|eot_id|>", "").strip()
    write_outputs(out_path, items)
    if mode == "vqa":
        print(json.dumps(score_vqa(items), indent=2))
    return items


def score_vqa(items: List[dict]) -> Dict[str, float]:
    """Exact-match accuracy per category + overall (:185-203)."""
    scores: Dict[str, float] = {}
    for category in sorted({x["type"] for x in items}):
        sub = [x for x in items if x["type"] == category]
        correct = sum(
            1 for x in sub if x["model_output"].lower() == x["answer"].lower()
        )
        scores[category] = round(correct / len(sub) * 100, 1)
    correct = sum(1 for x in items if x["model_output"].lower() == x["answer"].lower())
    scores["overall"] = round(correct / len(items) * 100, 1)
    scores["overall_count"] = f"{correct}/{len(items)}"
    return scores
