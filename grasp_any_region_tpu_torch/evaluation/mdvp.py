"""MDVP-Bench inference (`grasp_any_region_tpu/evaluation/mdvp.py`):
single-region detailed captions across 6 domains.

Mirrors MDVP-Bench/inference.py (:108-160): each item has one RLE mask and a
GT caption; output records (image_path, caption, gt). transfer() reshapes
predictions into (question, answer, prediction) triplets for the pairwise
GPT judge (transfer.py). Images read through `data/png.read_image` (PNG
without PIL).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..data.builders import RegionSample
from ..data.png import read_image
from ..data.rle import decode_rle
from .engine import BatchedCaptioner, write_outputs


def run_mdvp(
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
        img = read_image(os.path.join(image_folder, it["image_path"]))
        samples.append(RegionSample(image=img, masks={1: decode_rle(it["mask_rle"])}))
    outputs = captioner.run(samples)
    results = [
        {
            "image_path": it["image_path"],
            "dataset_name": it.get("dataset_name"),
            "caption": out.replace("<|eot_id|>", "").strip(),
            "gt": it["caption"],
            # pass region geometry through for the judge's set-of-marks
            # markup ({"bbox": [[x,y,w,h],...]} or {"points": [[x,y],...]},
            # MDVP eval_gpt.py:125-135)
            "annotation": it.get("annotation"),
        }
        for it, out in zip(items, outputs)
    ]
    write_outputs(out_path, results)
    return results


# judge [Context] strings per domain (MDVP eval_gpt.py:75-85)
DOMAIN_CONTEXT = {
    "natural": "The image is a natural image.",
    "ocr": "The image contains text, and the user wishes to know the content of the text.",
    "screen": "The image is a screenshot from a mobile phone or webpage.",
    "panel": "The image is a multi-panel figure.",
    "android": "The image is an andriod screenshot.",
    "web": "The image is a webpage screenshot.",
}


def context_for(dataset_name: Optional[str]) -> Optional[str]:
    if not dataset_name:
        return None
    name = dataset_name.lower()
    for key, ctx in DOMAIN_CONTEXT.items():
        if key in name:
            return ctx
    return None


def load_gpt4v_eval_dir(phase_dir: str) -> List[dict]:
    """Load a reference-format `mdvp_for_gpt4v_eval/<phase>/` directory
    (question.json + answer.json + prediction.json aligned by index,
    MDVP-Bench/eval_gpt.py:102-120) into judge triplets — questions carry
    the region annotation ({"bbox": [[x,y,w,h],...]} or {"points": ...})
    used for set-of-marks painting, and the phase name drives the
    [Context] string."""
    with open(os.path.join(phase_dir, "question.json")) as f:
        questions = json.load(f)
    with open(os.path.join(phase_dir, "answer.json")) as f:
        answers = json.load(f)
    with open(os.path.join(phase_dir, "prediction.json")) as f:
        predictions = json.load(f)
    phase = os.path.basename(os.path.normpath(phase_dir))
    triplets = []
    for q, a, p in zip(questions, answers, predictions):
        triplets.append(
            {
                "image_path": q["image"],
                "dataset_name": q.get("category", phase),
                "question": q["text"],
                "answer": a["text"],
                "prediction": p["text"],
                "annotation": q.get("annotation"),
                "context": context_for(phase),
            }
        )
    return triplets


def transfer(results: List[dict], question: str = "Describe this masked region in detail.") -> List[dict]:
    """Prediction file -> judge triplets (MDVP-Bench/transfer.py), carrying
    the region annotation (for image markup) and domain context."""
    return [
        {
            "image_path": r["image_path"],
            "dataset_name": r.get("dataset_name"),
            "question": question,
            "answer": r["gt"],
            "prediction": r["caption"],
            "annotation": r.get("annotation"),
            "context": context_for(r.get("dataset_name")),
        }
        for r in results
    ]
