"""Region-prompt construction: rasterization, bboxes and the questions
(`grasp_any_region_tpu/data/prompts.py`; its training-time instruction
augmentation is not ported yet)."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from .tokenizer import reserved_special_token

PROMPT_RE = re.compile(r"<Prompt(\d+)>")


def rasterize_prompts(
    masks: Dict[int, np.ndarray],  # prompt_id -> (H, W) binary mask
    height: int,
    width: int,
    prompt_numbers: int = 5,
) -> np.ndarray:
    """First-fill-wins prompt-id matrix; background = <NO_Prompt> id (= N):
    pixels covered by several masks keep the first prompt id written."""
    filled = np.full((height, width), -1, np.int16)
    for pid, mask in masks.items():
        if not 0 <= pid < prompt_numbers:
            # a prompt past the model's slot count is not rasterized (its
            # pixels stay <NO_Prompt>) and gets no feature replay (the
            # crop-token list covers prompt_numbers slots only)
            continue
        area = (filled == -1) & mask.astype(bool)
        filled[area] = pid
    filled[filled == -1] = prompt_numbers
    return filled.astype(np.uint8)


def bbox_from_mask(mask: np.ndarray) -> Tuple[float, float, float, float]:
    """Normalized (x1, y1, x2, y2) of the mask's nonzero extent. The max
    edge is the max pixel index itself (no +1), as the released checkpoints
    were trained with."""
    h, w = mask.shape
    nz = np.argwhere(mask)
    if len(nz) == 0:
        return (0.0, 0.0, 0.0, 0.0)
    y_min, x_min = nz.min(axis=0)
    y_max, x_max = nz.max(axis=0)
    return (x_min / w, y_min / h, x_max / w, y_max / h)


def single_region_question(
    prompt_idx: int = 1,
    instruction: str = "Describe this masked region in detail.",
    replay_tokens: int = 256,
) -> str:
    """The canonical single-region question."""
    pt = f"<Prompt{prompt_idx}>"
    crop = reserved_special_token(prompt_idx)
    return (
        f"There are some objects I am curious about: {pt};\n"
        f"{pt}: {crop * replay_tokens}{instruction}"
    )


def multi_region_question(
    question_str: str,
    replay_tokens: int = 256,
) -> Tuple[str, List[int]]:
    """Build the multi-region prompt around a user question containing
    <PromptK> references. Returns (full prompt text, prompt indices in
    order of first appearance)."""
    seen: List[int] = []
    for m in PROMPT_RE.finditer(question_str):
        idx = int(m.group(1))
        if idx not in seen:
            seen.append(idx)
    objects_desc = "There are some objects I am curious about: "
    sub_desc = ""
    for idx in seen:
        pt = f"<Prompt{idx}>"
        objects_desc += f"{pt}; "
        sub_desc += f"{pt}: {reserved_special_token(idx) * replay_tokens}\n"
    return objects_desc + "\n" + sub_desc + "\n" + question_str, seen
