"""LLaVA-style pairwise review judge (Ferret-Bench, MDVP-Bench;
`grasp_any_region_tpu/evaluation/judges/pairwise_judge.py`).

Protocol parity with Ferret-Bench/eval_gpt.py + summarize_gpt_review.py and
MDVP-Bench/eval_gpt.py + summarize_gpt_score.py: the judge sees the question,
Assistant 1 (reference/GPT-4 answer) and Assistant 2 (model), returns two
1-10 scores on the first line; the benchmark metric is
mean(model) / mean(reference) * 100. Reviews append to a jsonl and already-
reviewed indices are skipped on resume (MDVP eval_gpt.py:108-115).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ...data.png import read_image
from .client import JudgeClient, JudgeConfig, image_content

DEFAULT_RULE = {
    "role": "Assistant",
    "prompt": (
        "We would like to request your feedback on the performance of two AI "
        "assistants in response to the user question displayed above. The "
        "user asks the question about referring regions in an image.\n"
        "Please rate the helpfulness, relevance, accuracy, level of details "
        "of their responses. Each assistant receives an overall score on a "
        "scale of 1 to 10, where a higher score indicates better overall "
        "performance.\nPlease first output a single line containing only two "
        "values indicating the scores for Assistant 1 and 2, respectively. "
        "The two scores are separated by a space.\nIn the subsequent line, "
        "please provide a comprehensive explanation of your evaluation."
    ),
}


def parse_scores(review: str) -> Optional[List[float]]:
    try:
        first = review.strip().split("\n")[0].replace(",", " ")
        parts = first.split()
        return [float(parts[0]), float(parts[1])]
    except (IndexError, ValueError):
        return None


def review_pairs(
    triplets: List[dict],
    out_jsonl: str,
    judge_cfg: Optional[JudgeConfig] = None,
    rule: Optional[dict] = None,
    image_folder: Optional[str] = None,
) -> dict:
    """triplets: [{question, answer (assistant 1), prediction (assistant 2),
    image_path?}] -> writes review jsonl, returns summary ratios."""
    rule = rule or DEFAULT_RULE
    client = JudgeClient(judge_cfg or JudgeConfig())

    reviewed: Dict[int, dict] = {}
    if os.path.exists(out_jsonl):
        with open(out_jsonl) as f:
            for line in f:
                rec = json.loads(line)
                reviewed[rec["index"]] = rec

    with open(out_jsonl, "a") as out:
        for idx, tri in enumerate(triplets):
            if idx in reviewed:
                continue
            content = []
            if image_folder and tri.get("image_path"):
                img = read_image(os.path.join(image_folder, tri["image_path"]))
                # MDVP set-of-marks: darken + numbered box/point markup so
                # the judge can ground "region N" (eval_gpt.py:125-137)
                if tri.get("annotation"):
                    from .paint import paint_annotation

                    img = paint_annotation(img, tri["annotation"])
                content.append(image_content(img))
            role = rule.get("role", "Assistant")
            context = (
                f"[Context]\n{tri['context']}\n\n" if tri.get("context") else ""
            )
            prompt = (
                f"{context}"
                f"[Question]\n{tri['question']}\n\n"
                f"[{role} 1]\n{tri['answer']}\n\n[End of {role} 1]\n\n"
                f"[{role} 2]\n{tri['prediction']}\n\n[End of {role} 2]\n\n"
                f"[System]\n{rule['prompt']}\n\n"
            )
            content.append({"type": "text", "text": prompt})
            review = client.chat([{"role": "user", "content": content}])
            rec = {
                "index": idx,
                "scores": parse_scores(review),
                "review": review,
                "dataset_name": tri.get("dataset_name"),
            }
            reviewed[idx] = rec
            out.write(json.dumps(rec) + "\n")
            out.flush()

    return summarize(list(reviewed.values()))


def summarize(records: List[dict]) -> dict:
    """mean(model)/mean(reference) * 100, overall and per dataset_name
    (Ferret summarize_gpt_review.py:60-66)."""
    def ratio(recs):
        pairs = [r["scores"] for r in recs if r.get("scores")]
        if not pairs:
            return None
        ref = sum(p[0] for p in pairs) / len(pairs)
        mod = sum(p[1] for p in pairs) / len(pairs)
        return round(mod / ref * 100, 1) if ref else None

    out = {"overall": ratio(records), "count": len(records)}
    names = {r.get("dataset_name") for r in records if r.get("dataset_name")}
    for name in sorted(names):
        out[name] = ratio([r for r in records if r.get("dataset_name") == name])
    return out
