"""DLC-Bench inference (`grasp_any_region_tpu/evaluation/dlc.py`): per-
annotation single-region detailed captions.

Mirrors DLC-Bench/inference.py (:109-167): iterate every annotation of the
o365-subset COCO file, caption its mask, key results by ann_id. Images
read through `data/png.read_image` (PNG without PIL). Judged
downstream by evaluation.judges (GPT-4o with images or a local
OpenAI-compatible Llama judge, DLC-Bench/serve_judge.sh).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..data.builders import RegionSample
from ..data.png import read_image
from .coco import COCO
from .engine import BatchedCaptioner


def run_dlc(
    captioner: BatchedCaptioner,
    anno_file: str,
    image_folder: str,
    out_path: str,
    limit: Optional[int] = None,
) -> Dict[str, str]:
    coco = COCO(anno_file)
    ann_ids: List[int] = []
    samples: List[RegionSample] = []
    for img_id in coco.get_img_ids():
        info = coco.imgs[img_id]
        img_path = os.path.join(image_folder, "images", info["file_name"])
        img = read_image(img_path)
        for ann_id in coco.get_ann_ids(img_id):
            samples.append(
                RegionSample(image=img, masks={1: coco.ann_to_mask(ann_id)})
            )
            ann_ids.append(ann_id)
            if limit and len(ann_ids) >= limit:
                break
        if limit and len(ann_ids) >= limit:
            break

    outputs = captioner.run(samples)
    results = {str(a): o.replace("<|eot_id|>", "").strip() for a, o in zip(ann_ids, outputs)}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=4, ensure_ascii=False)
    return results
