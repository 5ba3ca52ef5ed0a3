"""Region-prompt construction: rasterization, bboxes, the questions and
the training-time instruction augmentation
(`grasp_any_region_tpu/data/prompts.py`)."""

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


# training-time prompt augmentation: varied caption instructions, some with
# a word- or sentence-count constraint read from the target

CAPTION_INSTRUCTIONS: Tuple[str, ...] = (
    "Describe this masked region in detail.",
    "Give a detailed description of the highlighted region.",
    "What is in the masked area? Describe it thoroughly.",
    "Provide a comprehensive description of the selected region.",
    "Explain what the marked region shows.",
    "Describe the contents of the outlined area in depth.",
    "Write a detailed caption for the masked region.",
    "Tell me everything you can about the highlighted area.",
    "Characterize the selected region in detail.",
    "Offer a rich description of the masked object.",
    "What does the marked region depict? Be specific.",
    "Summarize the appearance of the highlighted region.",
    "Describe the masked region's appearance and context.",
    "Give a fine-grained description of the selected area.",
    "Detail the visual features of the masked region.",
    "Describe the object or area under the mask.",
    "Provide an in-depth account of the highlighted region.",
    "What can you see in the masked portion of the image?",
    "Describe the region of interest in detail.",
    "Elaborate on what the masked region contains.",
    "Paint a verbal picture of the highlighted area.",
    "Describe the masked segment of this image.",
    "What is shown in the selected region? Describe fully.",
    "Give an exhaustive description of the marked area.",
    "Describe the appearance of the region under the mask.",
    "Report the contents of the highlighted region in detail.",
    "Provide a thorough visual description of the masked zone.",
    "Describe in detail what the selected mask covers.",
    "What details can you provide about the masked region?",
    "Fully describe the area indicated by the mask.",
)


def augment_instruction(
    rng: np.random.Generator,
    answer: str,
    word_suffix_prob: float = 0.25,
    sentence_suffix_prob: float = 0.25,
) -> str:
    """Pick a caption instruction; sometimes append a length constraint
    derived from the target answer (word or sentence count). Draws from
    `rng` in JAX's order: one integer, then one float."""
    ins = CAPTION_INSTRUCTIONS[int(rng.integers(len(CAPTION_INSTRUCTIONS)))]
    r = rng.random()
    if r < word_suffix_prob:
        n_words = len(answer.split())
        ins += f" Answer in around {n_words} words."
    elif r < word_suffix_prob + sentence_suffix_prob:
        n_sents = max(1, answer.count(".") + answer.count("!") + answer.count("?"))
        ins += f" Answer in around {n_sents} sentences."
    return ins


def negative_prompt_answer(prompt_idx: int) -> str:
    """The answer of a training sample's negative turn: a prompt slot that
    holds no mask is 'not in the image'."""
    return f"<Prompt{prompt_idx}> is not in the image."
