"""Llama-3 chat templating, image-token expansion and label masking
(`grasp_any_region_tpu/data/chat.py`), built straight from token ids:

  <|begin_of_text|>
  (<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>)*
  [<|start_header_id|>assistant<|end_header_id|>\n\n]   (generation prompt)

Each "<|image|>" placeholder in content expands to num_tiles * 256 copies
(the tiles include the thumbnail; 256 = (448 / 14 / 2)^2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..core.config import (
    BOT_TOKEN_ID,
    END_HEADER_ID,
    EOT_TOKEN_ID,
    NEWLINE2_ID,
    START_HEADER_ID,
)
from ..train.losses import IGNORE_INDEX
from .tokenizer import ROLE_TOKEN_IDS, GARTokenizer


@dataclass
class ChatMessage:
    role: str  # "user" | "assistant" | "system"
    content: str  # may contain "<|image|>" and crop-token runs


def expand_image_tokens(
    text: str, num_tiles_per_image: Sequence[int], image_token: str, tokens_per_tile: int = 256
) -> str:
    """Each <|image|> becomes num_tiles * tokens_per_tile copies."""
    parts = text.split(image_token)
    n_imgs = len(parts) - 1
    assert n_imgs == len(num_tiles_per_image), (
        f"{n_imgs} image tokens vs {len(num_tiles_per_image)} images"
    )
    out = parts[0]
    for i, nt in enumerate(num_tiles_per_image):
        out += image_token * (nt * tokens_per_tile) + parts[i + 1]
    return out


def apply_chat_template(
    tok: GARTokenizer,
    messages: Sequence[ChatMessage],
    *,
    add_generation_prompt: bool = False,
    num_tiles_per_image: Sequence[int] = (),
    tokens_per_tile: int = 256,
) -> List[int]:
    ids: List[int] = [BOT_TOKEN_ID]
    for m in messages:
        role_ids = (
            [ROLE_TOKEN_IDS[m.role]] if m.role in ROLE_TOKEN_IDS else tok.encode(m.role)
        )
        ids += [START_HEADER_ID] + role_ids + [END_HEADER_ID, NEWLINE2_ID]
        content = m.content
        if tok.image_token in content and num_tiles_per_image:
            content = expand_image_tokens(
                content, num_tiles_per_image, tok.image_token, tokens_per_tile
            )
        ids += tok.encode(content)
        ids.append(EOT_TOKEN_ID)
    if add_generation_prompt:
        ids += [START_HEADER_ID, ROLE_TOKEN_IDS["assistant"], END_HEADER_ID, NEWLINE2_ID]
    return ids


def mask_labels(input_ids: np.ndarray) -> np.ndarray:
    """Supervise only assistant spans: tokens strictly after
    [<|start_header_id|>, assistant, <|end_header_id|>, "\\n\\n"] up to and
    including <|eot_id|>."""
    start = np.array(
        [START_HEADER_ID, ROLE_TOKEN_IDS["assistant"], END_HEADER_ID, NEWLINE2_ID]
    )
    ids = np.asarray(input_ids)
    labels = np.full_like(ids, IGNORE_INDEX)
    i, n = 0, len(ids)
    while i < n:
        if i + 4 <= n and np.array_equal(ids[i:i + 4], start):
            s = i + 4
            ends = np.nonzero(ids[s:] == EOT_TOKEN_ID)[0]
            if len(ends) == 0:
                break
            e = s + int(ends[0])
            labels[s:e + 1] = ids[s:e + 1]
            i = e + 1
        else:
            i += 1
    return labels


def find_crop_runs(
    input_ids: np.ndarray, crop_token_ids: Sequence[int]
) -> List[Tuple[int, int, int]]:
    """Each region's crop-token run: [(prompt_id, start, length)] for every
    crop token present (each appears as one contiguous 256-token run)."""
    ids = np.asarray(input_ids)
    runs = []
    for pid, ct in enumerate(crop_token_ids):
        pos = np.nonzero(ids == ct)[0]
        if len(pos):
            runs.append((pid, int(pos.min()), int(pos.max()) - int(pos.min()) + 1))
    return runs
