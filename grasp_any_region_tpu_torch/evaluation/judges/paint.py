"""Set-of-marks image markup for the MDVP pairwise judge
(`grasp_any_region_tpu/evaluation/judges/paint.py`).

Reproduces the judge-visible semantics of the reference's
MDVP-Bench/paint_util.py (`paint_text_box` :78, `paint_text_point` :14, used
by eval_gpt.py:125-137): the full image is darkened, each annotated region
gets a numbered green box (or green dot), and the region index is drawn as
white text on a black label background. The markup is what lets GPT tie
"region N" in the question to pixels — without it MDVP judging is not
protocol-faithful (round-1 gap).

PIL implementation (cv2 is not in this environment); label font differs
from cv2's Hershey but position/colour/numbering semantics match. PIL is
imported at the first markup: the text rendering is PIL's, as in JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _load_font(size: int = 16):
    from PIL import ImageFont

    try:
        return ImageFont.truetype("DejaVuSans-Bold.ttf", size)  # PIL searches the system fonts
    except OSError:
        return ImageFont.load_default()


def _label(draw, x: int, y: int, text: str, font) -> None:
    """White text on a filled black rectangle (paint_util.py:52-68)."""
    bbox = draw.textbbox((x, y), text, font=font, anchor="ls")
    draw.rectangle(bbox, fill=(0, 0, 0))
    draw.text((x, y), text, fill=(255, 255, 255), font=font, anchor="ls")


def paint_text_box(
    image: np.ndarray,  # (H, W, 3) uint8 RGB
    bboxes: Sequence[Sequence[float]],  # [(x, y, w, h), ...]
    rgb: Tuple[int, int, int] = (0, 255, 0),
    rect_thickness: int = 2,
    alpha: float = 0.8,
) -> np.ndarray:
    """Darken the image by `alpha`, draw numbered boxes (1-indexed).

    Geometry mirrors paint_util.py:78-130: label at (x+4, y+20), pushed
    below the box if it would leave the top edge, clamped to the bottom.
    """
    from PIL import Image, ImageDraw

    h, w = image.shape[:2]
    out = Image.fromarray((image.astype(np.float32) * alpha).astype(np.uint8))
    draw = ImageDraw.Draw(out)
    font = _load_font()
    for i, (x, y, bw, bh) in enumerate(bboxes, start=1):
        x, y, bw, bh = int(x), int(y), int(bw), int(bh)
        for t in range(rect_thickness):
            draw.rectangle([x - t, y - t, x + bw + t, y + bh + t], outline=rgb)
        text_x, text_y = x + 4, y + 20
        if text_x < 0:
            text_x = 0
        if text_y < 0:
            text_y = y + bh + 15
        if text_y > h:
            text_y = h - 5
        _label(draw, text_x, text_y, str(i), font)
    return np.asarray(out)


def paint_text_point(
    image: np.ndarray,  # (H, W, 3) uint8 RGB
    points: Sequence[Sequence[float]],  # [(x, y), ...]
    rgb: Tuple[int, int, int] = (0, 255, 0),
    radius: int = 4,
    alpha: float = 0.7,
) -> np.ndarray:
    """Darken by `alpha`, draw numbered filled dots (paint_util.py:14-75):
    label beside the point, flipped inward near image edges."""
    from PIL import Image, ImageDraw

    h, w = image.shape[:2]
    out = Image.fromarray((image.astype(np.float32) * alpha).astype(np.uint8))
    draw = ImageDraw.Draw(out)
    font = _load_font()
    for i, (x, y) in enumerate(points, start=1):
        x, y = int(x), int(y)
        draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=rgb)
        text_x, text_y = x + 5, y - 5
        if text_x + 20 > w:
            text_x = x - 20
        if text_y - 10 < 0:
            text_y = y + 20
        if y + 10 > h:
            text_y = y - 20
        _label(draw, text_x, text_y, str(i), font)
    return np.asarray(out)


def paint_annotation(image: np.ndarray, annotation: dict) -> np.ndarray:
    """Dispatch on the MDVP annotation dict ({"bbox": ...} or {"points": ...},
    eval_gpt.py:125-135). Unknown/empty annotations return the image as-is."""
    if annotation.get("bbox"):
        return paint_text_box(image, annotation["bbox"])
    if annotation.get("points"):
        return paint_text_point(image, annotation["points"])
    return image
