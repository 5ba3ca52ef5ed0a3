"""GAR-Bench caption judges: GPT-judged semantic True/False
(`grasp_any_region_tpu/evaluation/judges/garbench_judge.py`).

Protocol parity with eval_simple.py / eval_detailed.py: the judge sees the
full image, then per region a focal crop (bbox grown to >=56 px, padded 3x)
and the mask crop, then a True/False instruction comparing model output to
ground truth. Results cache to *_eval.json and resume (judged items skipped).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ...data.png import read_image
from ...data.rle import decode_rle
from .client import JudgeClient, JudgeConfig, image_content

SIMPLE_PROMPT = """
You are a language model expert. Your task is to evaluate the correctness of the model's output based on the provided ground truth and given masks.

- Ground truth: "{answer}"
- Model Output: "{model_output}"

Please determine if the model's output conveys the same meaning as the provided ground truth. If the output is semantically correct, return "True", otherwise return "False".

Attention:
1. The ground truth and model output do not need to match exactly, as long as they convey the same meaning. Synonyms and different phrasings are acceptable.

2. Do not output any reasoning. Do not perform correction. Please output only "True" or "False".

"""

DETAILED_PROMPT = """
You are a language model expert. Your task is to evaluate whether the model's description of <Prompt0> is correct.

- Subject: "{subject_name}"
- Object: "{object_name}"
- Relationship: "{predicate_name}"

- Model Output: "{model_output}"

The model output must correctly identify the subject and correctly describe its relationship with the object. If both are correct, return "True", otherwise return "False".

Attention:
1. Exact wording is not required as long as the meaning matches. Synonyms and different phrasings are acceptable.

2. Do not output any reasoning. Do not perform correction. Please output only "True" or "False".

"""


def mask_to_box(mask: np.ndarray):
    nz = np.argwhere(mask)
    y0, x0 = nz.min(axis=0)
    y1, x1 = nz.max(axis=0) + 1
    return x0, y0, x1 - x0, y1 - y0


def region_evidence(img: np.ndarray, mask: np.ndarray, min_wh: int = 56):
    """Focal crop + mask crop for one region (eval_simple.py:131-160)."""
    h, w = mask.shape
    x0, y0, bw, bh = mask_to_box(mask)
    xc, yc = x0 + bw / 2, y0 + bh / 2
    bw, bh = max(bw, min_wh), max(bh, min_wh)
    x0, y0 = int(xc - bw / 2), int(yc - bh / 2)
    ys = slice(max(y0 - bh, 0), min(y0 + 2 * bh, h))
    xs = slice(max(x0 - bw, 0), min(x0 + 2 * bw, w))
    return img[ys, xs], (mask[ys, xs] * 255).astype(np.uint8)


def _judge_items(
    items: List[dict],
    image_folder: str,
    prompt_fn,
    client: JudgeClient,
    out_path: str,
) -> float:
    done: Dict[str, dict] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            for prev in json.load(f):
                done[prev.get("image", "") + prev.get("model_output", "")] = prev

    results = []
    n_true = 0
    for item in items:
        key = item.get("image", "") + item.get("model_output", "")
        if key in done and "eval_result" in done[key]:
            item = done[key]
        else:
            img = read_image(os.path.join(image_folder, item["image"]))
            content = [
                {"type": "text", "text": "\n1. The original image:\n"},
                image_content(img),
            ]
            for mi, rle in enumerate(item["mask_rles"]):
                mask = decode_rle(rle)
                crop, mcrop = region_evidence(img, mask)
                content += [
                    {"type": "text", "text": f"\n{2 * mi + 2}. <Prompt{mi}>:\n"},
                    image_content(crop),
                    {"type": "text", "text": f"\n{2 * mi + 3}. The mask of <Prompt{mi}>:\n"},
                    image_content(mcrop),
                ]
            content.append({"type": "text", "text": prompt_fn(item)})
            verdict = client.chat([{"role": "user", "content": content}]).strip()
            item = {**item, "eval_result": verdict}
        n_true += item["eval_result"] == "True"
        results.append(item)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=4)
    acc = n_true / max(len(results), 1)
    print(f"Accuracy: {acc}")
    return acc


def judge_simple(pred_file: str, image_folder: str,
                 judge_cfg: Optional[JudgeConfig] = None) -> float:
    with open(pred_file) as f:
        items = json.load(f)
    client = JudgeClient(judge_cfg or JudgeConfig())
    return _judge_items(
        items, image_folder,
        lambda it: SIMPLE_PROMPT.format(answer=it["answer"], model_output=it["model_output"]),
        client, pred_file.replace(".json", "_eval.json"),
    )


def judge_detailed(pred_file: str, image_folder: str,
                   judge_cfg: Optional[JudgeConfig] = None) -> float:
    with open(pred_file) as f:
        items = json.load(f)
    client = JudgeClient(judge_cfg or JudgeConfig())
    return _judge_items(
        items, image_folder,
        lambda it: DETAILED_PROMPT.format(
            subject_name=it["subject_name"], object_name=it["object_name"],
            predicate_name=it["predicate_name"], model_output=it["model_output"],
        ),
        client, pred_file.replace(".json", "_eval.json"),
    )
