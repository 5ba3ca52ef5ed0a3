"""Minimal COCO-format annotation reader (`grasp_any_region_tpu/evaluation/
coco.py`; replaces pycocotools.coco.COCO for the benchmark data plane:
DLC-Bench o365 subset, Ferret COCO val2017)."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..data.rle import segmentation_to_mask


class COCO:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs: Dict[int, dict] = {im["id"]: im for im in d.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in d.get("annotations", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a["id"])

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return list(self.cats.keys())

    def get_ann_ids(self, img_id: int, area_min: Optional[float] = None,
                    area_max: Optional[float] = None) -> List[int]:
        ids = list(self.img_to_anns.get(img_id, []))
        if area_min is not None:
            ids = [i for i in ids if self.anns[i]["area"] >= area_min]
        if area_max is not None:
            ids = [i for i in ids if self.anns[i]["area"] <= area_max]
        return ids

    def ann_to_mask(self, ann_id: int) -> np.ndarray:
        ann = self.anns[ann_id]
        img = self.imgs[ann["image_id"]]
        return segmentation_to_mask(ann["segmentation"], img["height"], img["width"])
