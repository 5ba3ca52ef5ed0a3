"""Synthetic benchmark files in the four formats the evaluation loaders
read, drawn from a seed with numpy: PNG images (`data/png.write_png`) and

  * GAR-Bench items (`garbench.py`): a VQA file of single- and two-region
    multiple-choice items, and a file of two-region items with a question,
    an answer and subject / object / predicate names (the simple and
    detailed modes), masks as compressed RLE;
  * a DLC-Bench COCO file (`dlc.py`): polygon and RLE segmentations;
  * a Ferret `box_refer_caption` file (`ferret.py`): polygon and RLE;
  * an MDVP file (`mdvp.py`): an RLE mask, a ground-truth caption and the
    region's box for the judge's set-of-marks markup.

The tests and `chip_smoke.py` run the loaders on them; no benchmark asset
is needed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from ..data.png import write_png
from ..data.rle import encode_rle

CHOICES = ["A. red", "B. blue", "C. green", "D. gray"]
VQA_TYPES = ("color", "shape", "relation")


def _rle(mask: np.ndarray) -> dict:
    rle = encode_rle(mask)
    return {"size": rle["size"], "counts": rle["counts"].decode()}


def _box(rng, h: int, w: int) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of a box inside the image, at least an eighth of each side."""
    bw, bh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
    return int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh)), bw, bh


def _box_mask(h: int, w: int, box) -> np.ndarray:
    x, y, bw, bh = box
    m = np.zeros((h, w), np.uint8)
    m[y:y + bh, x:x + bw] = 1
    return m


def _polygon(box) -> list:
    """A diamond inscribed in the box, as a COCO polygon."""
    x, y, bw, bh = box
    return [[x + bw / 2, y, x + bw, y + bh / 2, x + bw / 2, y + bh, x, y + bh / 2]]


def write_benchmark_files(
    root: str,
    *,
    seed: int = 0,
    image_sizes: Sequence[Tuple[int, int]] = ((1344, 1008), (1792, 1792)),  # (w, h)
    n_vqa: int = 4,
    n_detailed: int = 2,
    n_dlc: int = 3,
    n_ferret: int = 2,
    n_mdvp: int = 2,
) -> Dict[str, str]:
    """Write the images and the annotation files under `root`; returns their
    paths: "images" (the GAR-Bench, Ferret and MDVP image folder), "dlc_root"
    (DLC's folder, holding images/), "garbench_vqa", "garbench_detailed",
    "dlc", "ferret", "mdvp". Items take the images in turn."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images = []
    for i, (w, h) in enumerate(image_sizes):
        name = f"img{i}.png"
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) * 255 // max(w + h - 2, 1)], axis=-1)
        noise = rng.integers(0, 64, (h, w, 3))
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(write_png(((base * 3 + noise) // 4).astype(np.uint8)))
        images.append((name, h, w))

    def image(k):
        return images[k % len(images)]

    def dump(name, obj):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        return path

    vqa = []
    for k in range(n_vqa):
        name, h, w = image(k)
        two = k % 2 == 1
        boxes = [_box(rng, h, w) for _ in range(2 if two else 1)]
        question = ("Which region is larger, <Prompt0> or <Prompt1>?" if two
                    else "What is the color of <Prompt0>?")
        vqa.append({"image": name, "question": question, "choices": CHOICES,
                    "answer": "ABCD"[int(rng.integers(4))], "type": VQA_TYPES[k % 3],
                    "mask_rles": [_rle(_box_mask(h, w, b)) for b in boxes]})
    detailed = []
    for k in range(n_detailed):
        name, h, w = image(k)
        boxes = [_box(rng, h, w) for _ in range(2)]
        detailed.append({"image": name, "question": "What is <Prompt0> next to?",
                         "answer": "a square", "subject_name": "patch",
                         "object_name": "square", "predicate_name": "next to",
                         "mask_rles": [_rle(_box_mask(h, w, b)) for b in boxes]})
    coco = {"images": [{"id": i + 1, "file_name": n, "height": h, "width": w}
                       for i, (n, h, w) in enumerate(images)],
            "annotations": [], "categories": [{"id": 1, "name": "patch"}]}
    for k in range(n_dlc):
        _, h, w = image(k)
        box = _box(rng, h, w)
        seg = _rle(_box_mask(h, w, box)) if k % 2 else _polygon(box)
        coco["annotations"].append({"id": 100 + k, "image_id": k % len(images) + 1,
                                    "category_id": 1, "area": float(box[2] * box[3]),
                                    "segmentation": seg})
    ferret = []
    for k in range(n_ferret):
        name, h, w = image(k)
        box = _box(rng, h, w)
        seg = _rle(_box_mask(h, w, box)) if k % 2 else _polygon(box)
        ferret.append({"question_id": k, "image": name, "category": "refer_desc",
                       "annotation": {"segmentation": seg}})
    mdvp = []
    for k in range(n_mdvp):
        name, h, w = image(k)
        box = _box(rng, h, w)
        mdvp.append({"image_path": name, "dataset_name": "mdvp_natural",
                     "caption": "A patch of colour.", "mask_rle": _rle(_box_mask(h, w, box)),
                     "annotation": {"bbox": [list(box)]}})
    return {"images": img_dir, "dlc_root": root,
            "garbench_vqa": dump("garbench_vqa.json", vqa),
            "garbench_detailed": dump("garbench_detailed.json", detailed),
            "dlc": dump("annotations.json", coco), "ferret": dump("ferret.json", ferret),
            "mdvp": dump("mdvp.json", mdvp)}
