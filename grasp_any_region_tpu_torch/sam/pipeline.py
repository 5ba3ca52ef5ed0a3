"""SAM's host pipeline (`grasp_any_region_tpu/sam/pipeline.py`):
preprocessing, prompt normalization, postprocessing and the points / box ->
mask entry point of the demos and the server.

`preprocess_sam` and `postprocess_mask` are numpy on the port's
`data/resize.resize_bicubic`, bit-equal to JAX's. `SamPredictor` runs the
port's SAM on its parameters' device (the card unless loaded for the CPU)
and caches the image embeddings of the last 8 images by the sha1 of their
pixels, so a further click on the same image pays the prompt encoder and
the mask decoder only.

Without weights the predictor is JAX's documented geometric stand-in (a
box becomes a filled rectangle, a point a disk), with a loud warning on
stderr. It concerns the model, not the device: `has_model` says which ran.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.resize import resize_bicubic
from .model import SAMConfig, decode_masks, encode_image, encode_points

SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_sam(image: np.ndarray, img_size: int = 1024):
    """Resize the longest side to img_size, normalize, zero-pad bottom and
    right. Returns (pixels (1, 3, S, S), scale, (new_h, new_w))."""
    h, w = image.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bicubic(image.astype(np.float32), nh, nw)
    resized = (resized - SAM_MEAN) / SAM_STD
    canvas = np.zeros((img_size, img_size, 3), np.float32)
    canvas[:nh, :nw] = resized
    return canvas.transpose(2, 0, 1)[None], scale, (nh, nw)


def postprocess_mask(logits: np.ndarray, scale_hw: Tuple[int, int],
                     orig_hw: Tuple[int, int], img_size: int = 1024) -> np.ndarray:
    """(256, 256) logits -> (H, W) binary mask at the original resolution."""
    nh, nw = scale_hw
    h, w = orig_hw
    up = resize_bicubic(logits.astype(np.float32), img_size, img_size)
    up = up[:nh, :nw]
    out = resize_bicubic(up, h, w)
    return (out > 0).astype(np.uint8)


@dataclass
class SamPredictor:
    params: Optional[object] = None  # sam/model.ParamTree
    cfg: Optional[SAMConfig] = None
    # sha1 of the pixels -> (embedding, scale, (nh, nw)), the oldest evicted
    _emb_cache: dict = None
    _emb_cache_max: int = 8

    @classmethod
    def load(cls, model_path: Optional[str], device="cuda") -> "SamPredictor":
        """The weights of an HF SAM checkpoint directory on `device` (the
        card unless the caller asks for the CPU); no path gives the
        geometric stand-in."""
        if model_path is None:
            return cls()
        from .weights import load_sam_checkpoint

        cfg, params = load_sam_checkpoint(model_path, device=device)
        return cls(params=params, cfg=cfg)

    @property
    def has_model(self) -> bool:
        return self.params is not None

    @property
    def device(self) -> torch.device:
        return self.params["prompt"]["pe_gaussian"].device

    @torch.inference_mode()
    def _embedding(self, image: np.ndarray):
        """Cached (embedding, scale, (nh, nw)) for this image."""
        if self._emb_cache is None:
            self._emb_cache = {}
        key = hashlib.sha1(image.tobytes()).hexdigest()
        hit = self._emb_cache.get(key)
        if hit is None:
            pix, scale, shp = preprocess_sam(image, self.cfg.img_size)
            dtype = self.params["prompt"]["pe_gaussian"].dtype
            pixels = torch.from_numpy(pix).to(self.device, dtype)
            hit = (encode_image(self.params, self.cfg, pixels), scale, shp)
            while len(self._emb_cache) >= self._emb_cache_max:
                self._emb_cache.pop(next(iter(self._emb_cache)))
            self._emb_cache[key] = hit
        return hit

    @torch.inference_mode()
    def predict(
        self,
        image: np.ndarray,  # (H, W, 3) uint8
        points: Optional[List[Tuple[float, float]]] = None,  # pixel coords
        point_labels: Optional[List[int]] = None,  # 1 fg / 0 bg
        box: Optional[Tuple[float, float, float, float]] = None,  # pixel xyxy
    ) -> np.ndarray:
        h, w = image.shape[:2]
        if self.has_model:
            emb, scale, (nh, nw) = self._embedding(image)
            s = self.cfg.img_size
            pts: List[Tuple[float, float]] = []
            labs: List[int] = []
            for (x, y), lab in zip(points or [], point_labels or []):
                pts.append((x * scale / s, y * scale / s))
                labs.append(lab)
            if box is not None:
                x1, y1, x2, y2 = box
                pts.append((x1 * scale / s, y1 * scale / s))
                labs.append(2)
                pts.append((x2 * scale / s, y2 * scale / s))
                labs.append(3)
            if not pts:
                raise ValueError("need at least one point or a box")
            sparse = encode_points(
                self.params,
                torch.from_numpy(np.asarray(pts, np.float32)[None]).to(self.device, emb.dtype),
                torch.from_numpy(np.asarray(labs, np.int32)[None]).to(self.device),
            )
            masks, iou = decode_masks(self.params, self.cfg, emb, sparse)
            # best multimask output, skipping index 0 (predict_mask's rule)
            best = int(np.argmax(iou[0, 1:].float().cpu().numpy())) + 1
            logits = masks[0, best].float().cpu().numpy()
            return postprocess_mask(logits, (nh, nw), (h, w), s)

        print(
            "[sam] WARNING: no SAM weights loaded — using geometric fallback "
            "(box -> rectangle, point -> disk). Pass --sam-path for real masks.",
            file=sys.stderr,
        )
        mask = np.zeros((h, w), np.uint8)
        if box is not None:
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            mask[max(y1, 0):min(y2, h), max(x1, 0):min(x2, w)] = 1
        elif points:
            r = max(8, min(h, w) // 20)
            yy, xx = np.mgrid[:h, :w]
            for (x, y), lab in zip(points, point_labels or [1] * len(points)):
                if lab == 1:
                    mask |= ((yy - y) ** 2 + (xx - x) ** 2 <= r * r).astype(np.uint8)
        return mask


def mask_contours(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (a visualization without cv2)."""
    m = mask.astype(bool)
    inner = np.zeros_like(m)
    inner[1:-1, 1:-1] = (
        m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
    )
    return (m & ~inner).astype(np.uint8)


def draw_mask_overlay(image: np.ndarray, mask: np.ndarray,
                      color=(255, 60, 60), alpha: float = 0.45) -> np.ndarray:
    out = image.astype(np.float32).copy()
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + np.asarray(color, np.float32) * alpha
    edge = mask_contours(mask).astype(bool)
    out[edge] = np.asarray(color, np.float32)
    return out.astype(np.uint8)
