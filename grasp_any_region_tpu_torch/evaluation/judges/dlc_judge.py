"""DLC-Bench QA judge: per-object recognition gate + scored multiple choice
(`grasp_any_region_tpu/evaluation/judges/dlc_judge.py`).

Protocol parity with DLC-Bench/eval_gpt_with_image.py (:147-273, :440-489):
  * per annotation: a recognition question (is the described object the given
    class?) gates everything — an incorrect recognition clamps every scored
    answer to <= 0
  * then the positive/negative questions from qa.json, each with
    (choice, score) pairs; the judge answers with a letter/choice
  * robust answer parsing (:98-145): exact letter, exact text, substring
    (latest/longest match wins), reverse-substring
  * Pos = mean positive scores, Neg = mean negative scores, score = pooled
    mean; overall = averages over annotations (:467-481)
  * resume via the *_eval.json cache (response_override)

Runs with a multimodal judge (images attached) or text-only (the
Llama-3.1-8B local judge of eval_llama_without_image.py / serve_judge.sh)
via with_images=False.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ...data.png import read_image
from .client import JudgeClient, JudgeConfig, image_content
from .garbench_judge import region_evidence

EVAL_PROMPT = """You are evaluating a description of an object in an image.

Description: "{pred_caption}"

Based on the description, answer the following multiple-choice question. Answer with the letter of the single best choice.

{question_text}
"""

RECOGNITION_CHOICES = [["correct", "correct"], ["incorrect", "incorrect"]]


def parse_pred(pred: str, choices: List[str]) -> Optional[int]:
    """Robust multiple-choice answer parsing (reference :98-145)."""
    pred = pred.strip().lower()
    if not pred:
        return None
    letters = "abcde"
    subs = []
    for i, choice in enumerate(choices):
        c = choice.strip().lower()
        if c == pred or pred == f"{letters[i]}. {c}" or pred == letters[i]:
            return i
        if c in pred:
            subs.append((i, pred.index(c), len(c)))
    if len(subs) == 1:
        return subs[0][0]
    if len(pred) >= 2 and pred[0] in letters and pred[1] == ".":
        return letters.index(pred[0])
    if subs:
        last = max(s[1] for s in subs)
        tied = [s for s in subs if s[1] == last]
        return max(tied, key=lambda s: s[2])[0]
    rev = [(i, len(c.strip())) for i, c in enumerate(choices) if pred in c.strip().lower()]
    if rev:
        return max(rev, key=lambda r: r[1])[0]
    if pred[0] in letters and (len(pred) == 1 or pred[1] == "\n"):
        return letters.index(pred[0])
    return None


def evaluate_one(
    client: JudgeClient,
    question_dicts: List[dict],
    pred_caption: str,
    images: List,
    response_override: Optional[List[Optional[str]]] = None,
) -> dict:
    responses = []
    for idx, qd in enumerate(question_dicts):
        qtext = qd["question"] + "\n" + "".join(
            f"{'ABCDE'[i]}. {c}\n" for i, (c, _s) in enumerate(qd["choices"])
        )
        if response_override and idx < len(response_override) and response_override[idx] is not None:
            responses.append(response_override[idx])
            continue
        content = [image_content(im) for im in images]
        content.append(
            {"type": "text", "text": EVAL_PROMPT.format(pred_caption=pred_caption, question_text=qtext.strip())}
        )
        responses.append(client.chat([{"role": "user", "content": content}]).strip())

    pos, neg = [], []
    recognition = None
    for qd, resp in zip(question_dicts, responses):
        idx = parse_pred(resp, [c for c, _ in qd["choices"]])
        val = qd["choices"][idx][1] if idx is not None else 0
        if qd["type"] == "recognition":
            recognition = val == "correct"
        elif qd["type"] == "positive":
            pos.append(min(0, val) if recognition is False else val)
        elif qd["type"] == "negative":
            neg.append(min(0, val) if recognition is False else val)
    return {
        "responses": responses,
        "recognition_result": recognition,
        "score_pos": sum(pos) / len(pos) if pos else None,
        "score_neg": sum(neg) / len(neg) if neg else None,
        "score": (sum(pos) + sum(neg)) / max(len(pos) + len(neg), 1),
    }


def judge_dlc(
    pred_file: str,
    anno_file: str,
    qa_file: str,
    class_names_file: str,
    image_folder: Optional[str] = None,
    judge_cfg: Optional[JudgeConfig] = None,
    with_images: bool = True,
) -> dict:
    from ..coco import COCO

    with open(pred_file) as f:
        preds: Dict[str, str] = json.load(f)
    with open(qa_file) as f:
        qa: Dict[str, List[dict]] = json.load(f)
    with open(class_names_file) as f:
        class_names: Dict[str, str] = json.load(f)

    coco = COCO(anno_file)
    client = JudgeClient(judge_cfg or JudgeConfig())
    out_path = pred_file.replace(".json", "_eval.json")
    cache: Dict[str, dict] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            cache = json.load(f)

    results: Dict[str, dict] = {}
    for key, caption in preds.items():
        if key in cache and "score" in cache[key]:
            results[key] = cache[key]
            continue
        class_name = class_names.get(key, "object")
        recog = {
            "question": (
                f"The object in the image is {class_name}. Based on the image, "
                f"is it likely that the object in the description is given "
                f"class: {class_name} or object of a similar type?"
            ),
            "choices": RECOGNITION_CHOICES,
            "type": "recognition",
        }
        questions = [recog, *qa[key]]
        images = []
        if with_images and image_folder is not None:
            ann = coco.anns[int(key)]
            info = coco.imgs[ann["image_id"]]
            img = read_image(os.path.join(image_folder, "images", info["file_name"]))
            mask = coco.ann_to_mask(int(key))
            crop, mcrop = region_evidence(img, mask)
            images = [crop, mcrop]
        override = cache.get(key, {}).get("responses")
        results[key] = evaluate_one(client, questions, caption, images, override)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=4)

    pos = [r["score_pos"] for r in results.values() if r["score_pos"] is not None]
    neg = [r["score_neg"] for r in results.values() if r["score_neg"] is not None]
    summary = {
        "pos": sum(pos) / len(pos) if pos else None,
        "neg": sum(neg) / len(neg) if neg else None,
    }
    if pos and neg:
        summary["avg"] = (summary["pos"] + summary["neg"]) / 2
    print(json.dumps(summary, indent=2))
    return summary
