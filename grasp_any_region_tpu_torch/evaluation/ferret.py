"""Ferret-Bench refer_desc inference + judge input assembly
(`grasp_any_region_tpu/evaluation/ferret.py`).

Mirrors Ferret-Bench/inference.py: COCO val2017 images + box_refer_caption
annotations whose `annotation.segmentation` is a COCO polygon (or RLE).
Outputs LLaVA-review-style records for the pairwise GPT judge
(eval_gpt.py + summarize_gpt_review.py); load_gpt4_data() assembles the
judge triplets from the shipped ferret_gpt4_data/ bundle the same way
eval.sh wires eval_gpt.py (question/context/answer jsonls + rule.json).
Images read through `data/png.read_image` (PNG without PIL).
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

from ..data.builders import RegionSample
from ..data.png import read_image
from ..data.rle import segmentation_to_mask
from .engine import BatchedCaptioner, write_outputs


def run_ferret(
    captioner: BatchedCaptioner,
    anno_file: str,
    image_folder: str,
    out_path: str,
    limit: Optional[int] = None,
) -> List[dict]:
    with open(anno_file) as f:
        items = json.load(f)
    if limit:
        items = items[:limit]
    samples = []
    for it in items:
        img = read_image(os.path.join(image_folder, it["image"]))
        h, w = img.shape[:2]
        mask = segmentation_to_mask(it["annotation"]["segmentation"], h, w)
        samples.append(RegionSample(image=img, masks={1: mask}))
    outputs = captioner.run(samples)
    results = [
        {
            "question_id": it["question_id"],
            "image": it["image"],
            "category": it.get("category", "refer_desc"),
            "text": out.replace("<|eot_id|>", "").strip(),
        }
        for it, out in zip(items, outputs)
    ]
    write_outputs(out_path, results)
    return results


# Ferret's grounded answers embed box coords on a 0-1000 vocab grid
# (Ferret-Bench/eval_gpt.py:11-12).
VOCAB_IMAGE_W = VOCAB_IMAGE_H = 1000


def postprocess_answer(answer: str, category: str = "refer_desc") -> str:
    """Reference answer cleanup before judging (eval_gpt.py:56-85):
    refer_desc / refer_reason strip " [...]" coordinate spans from the
    model answer; ground_conv rescales 4-float vocab-grid boxes to 0-1
    (malformed boxes are dropped instead of crashing)."""
    if category in ("refer_desc", "refer_reason"):
        for match in re.findall(r"\[.*?\]", answer):
            answer = answer.replace(" " + match, "")
    elif category == "ground_conv":
        for match in re.findall(r"\[.*?\]", answer):
            parts = [s.strip() for s in match.strip("[]").split(",")]
            try:
                coor = [float(s) for s in parts]
            except ValueError:
                coor = []
            if len(coor) != 4:
                answer = answer.replace(match, "")
                continue
            scaled = [
                coor[0] / VOCAB_IMAGE_W,
                coor[1] / VOCAB_IMAGE_H,
                coor[2] / VOCAB_IMAGE_W,
                coor[3] / VOCAB_IMAGE_H,
            ]
            answer = answer.replace(
                match, "[" + ", ".join(f"{c:.3f}" for c in scaled) + "]"
            )
    return answer


def _read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_gpt4_data(
    gpt4_dir: str,
    predictions: List[dict],
    phase: str = "refer_desc",
) -> Tuple[List[dict], dict]:
    """Assemble pairwise-judge triplets from the reference's shipped
    `ferret_gpt4_data/<phase>/{question,context,answer}.jsonl` plus model
    predictions, aligned by line order exactly like eval_gpt.py:120-186
    (context keyed by image, GPT-4 answer = Assistant 1, postprocessed
    model answer = Assistant 2). Returns (triplets, rule) where rule is
    the phase's entry from rule.json.

    `predictions` accepts either run_ferret() records
    ({question_id, image, category, text}) or the reference
    model_outputs/*.json format ({image_path, caption}) — the same
    source-file conversion eval_gpt.py:119-133 performs inline.
    """
    phase_dir = os.path.join(gpt4_dir, phase)
    questions = _read_jsonl(os.path.join(phase_dir, "question.jsonl"))
    answers = _read_jsonl(os.path.join(phase_dir, "answer.jsonl"))
    contexts = _read_jsonl(os.path.join(phase_dir, "context.jsonl"))
    with open(os.path.join(gpt4_dir, "rule.json")) as f:
        rules = json.load(f)
    image_to_context = {c["image"]: c for c in contexts}

    triplets = []
    for ques, ans1, pred in zip(questions, answers, predictions):
        category = ques.get("category", phase)
        if "text" in pred:  # run_ferret output format
            pred_text = pred["text"]
        else:  # reference model_outputs format
            pred_text = pred["caption"]
        triplets.append(
            {
                "image_path": ques["image"],
                "dataset_name": category,
                "context": image_to_context[ques["image"]]["text"],
                "question": ques["text"],
                "answer": ans1["text"],
                "prediction": postprocess_answer(pred_text, category),
            }
        )
    categories = {t["dataset_name"] for t in triplets}
    if len(categories) != 1:
        raise ValueError(f"mixed categories in one phase: {categories}")
    rule = rules[categories.pop()]
    return triplets, rule
