"""Host-side image and mask preprocessing, the thumbnail + tile pipeline
(`grasp_any_region_tpu/data/image_processor.py`, in numpy as there):

  * the supported tile grids, enumerated by factors of each tile count
  * the canvas that fits the image with the largest upsample, or the
    closest aspect ratio when none fits
  * a thumbnail (one tile) and the aspect-fitted grid of tiles
  * rescale and normalize with mean = std = 0.5, to [-1, 1]

One processor takes the image and, optionally, the prompt-id matrix
(resized nearest) and returns pixel_values, mask_values and the aspect
ratio. Padding to the model's tile bucket happens in the builders.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Dict, List, Optional, Tuple

import numpy as np

from .resize import resize_bicubic, resize_nearest


@dataclass(frozen=True)
class ImageProcessorConfig:
    tile_size: int = 448
    max_num_tiles: int = 16  # GAR-1B 16, GAR-8B 8
    image_mean: float = 0.5
    image_std: float = 0.5


def _factors(n: int):
    return set(
        reduce(
            list.__add__,
            ([i, n // i] for i in range(1, int(n ** 0.5) + 1) if n % i == 0),
        )
    )


def find_supported_aspect_ratios(max_num_tiles: int) -> Dict[float, List[Tuple[int, int]]]:
    """All (ncw, nch) grids with ncw*nch <= max_num_tiles, grouped by ratio.
    The order breaks ties (a later grid wins in canvas fitting): tile counts
    descend."""
    asp: Dict[float, List[Tuple[int, int]]] = {}
    for chunks in range(max_num_tiles, 0, -1):
        for x in sorted(_factors(chunks)):
            ratio = (x, chunks // x)
            k = ratio[0] / ratio[1]
            asp.setdefault(k, []).append(ratio)
    return asp


def _fitted_size(img_w: int, img_h: int, target_w: int, target_h: int) -> Tuple[int, int]:
    """Aspect-preserving size inside the canvas."""
    scale = img_w / img_h
    rescale = min(target_w / img_w, target_h / img_h)
    if scale > 1.0:
        new_w = rescale * img_w
        new_h = int(np.floor(new_w / scale))
        new_w = new_w  # the width stays a float (only h floors)
    else:
        new_h = rescale * img_h
        new_w = int(np.floor(new_h * scale))
        new_h = new_h
    return new_w, new_h


def fit_image_to_canvas(img_w: int, img_h: int, tile_size: int, max_num_tiles: int) -> Optional[Tuple[int, int]]:
    """Pick the grid whose canvas fits the image without downsampling,
    preferring the one that upsamples the constrained edge most."""
    optimal = None
    optimal_wh = None
    scale = img_w / img_h
    arrangements = [
        r for lst in find_supported_aspect_ratios(max_num_tiles).values() for r in lst
    ]
    for n_w, n_h in arrangements:
        cw, ch = n_w * tile_size, n_h * tile_size
        if cw >= img_w and ch >= img_h:
            wh = _fitted_size(img_w, img_h, cw, ch)
            if optimal is None:
                optimal, optimal_wh = (n_w, n_h), wh
            else:
                if (scale < 1.0 and wh[0] >= optimal_wh[0]) or (
                    scale >= 1.0 and wh[1] >= optimal_wh[1]
                ):
                    optimal, optimal_wh = (n_w, n_h), wh
    return optimal


def find_closest_aspect_ratio(img_w: int, img_h: int, max_num_tiles: int) -> Tuple[int, int]:
    """Fallback when the image fits no canvas."""
    target = img_w / img_h
    asp = find_supported_aspect_ratios(max_num_tiles)
    if target >= 1:
        closest = min((k for k in asp if k <= target), key=lambda x: abs(x - target))
        return max(asp[closest], key=lambda r: r[0])
    closest = min((k for k in asp if k > target), key=lambda x: abs(1 / x - 1 / target))
    return max(asp[closest], key=lambda r: r[1])


def select_tile_grid(img_w: int, img_h: int, tile_size: int, max_num_tiles: int) -> Tuple[int, int]:
    if max_num_tiles <= 1:
        return (1, 1)
    grid = fit_image_to_canvas(img_w, img_h, tile_size, max_num_tiles)
    if grid is None:
        grid = find_closest_aspect_ratio(img_w, img_h, max_num_tiles)
    return grid


def _split_tiles_np(img: np.ndarray, ncw: int, nch: int) -> np.ndarray:
    """(H, W, C) canvas -> (nch*ncw, C, th, tw), row-major tiles."""
    h, w, c = img.shape
    th, tw = h // nch, w // ncw
    x = img.reshape(nch, th, ncw, tw, c)
    return x.transpose(0, 2, 4, 1, 3).reshape(nch * ncw, c, th, tw)


class GARImageProcessor:
    """images (+ prompt matrices) -> model-ready arrays."""

    def __init__(self, config: ImageProcessorConfig = ImageProcessorConfig()):
        self.config = config

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        c = self.config
        return ((x / 255.0) - c.image_mean) / c.image_std

    def preprocess(
        self,
        image: np.ndarray,  # (H, W, 3) uint8/float RGB
        visual_prompt: Optional[np.ndarray] = None,  # (H, W) uint8 prompt ids
        max_num_tiles: Optional[int] = None,
    ) -> dict:
        """Returns dict with:
        pixel_values: (1+ncw*nch, 3, T, T) float32 in [-1, 1]
        mask_values:  same shape (NEAREST + the same normalize; present if
                      visual_prompt is given): the normalized mask plane
                      that `decode_mask_values(compat=True)` reads
        aspect_ratio: (ncw, nch)
        """
        cfgt = self.config.tile_size
        mnt = max_num_tiles or self.config.max_num_tiles
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        h, w = img.shape[:2]
        was_uint8 = img.dtype == np.uint8

        def _resize(arr, oh, ow):
            out = resize_bicubic(arr, oh, ow)
            if was_uint8:
                # a uint8 image stays uint8 through the resize: the
                # overshoot rounds and clamps
                out = np.clip(np.round(out), 0, 255)
            return out.astype(np.float32)

        # thumbnail: 1-tile grid
        thumb = _resize(img, cfgt, cfgt)
        # tile grid
        ncw, nch = select_tile_grid(w, h, cfgt, mnt)
        canvas = _resize(img, nch * cfgt, ncw * cfgt)
        tiles = _split_tiles_np(canvas, ncw, nch)  # (n, 3, T, T)
        thumb_chw = thumb.transpose(2, 0, 1)[None]
        pixel_values = np.concatenate([thumb_chw, tiles], axis=0)
        pixel_values = self._normalize(pixel_values).astype(np.float32)

        out = {
            "pixel_values": pixel_values,
            "aspect_ratio": (ncw, nch),
            "num_tiles": 1 + ncw * nch,
        }
        if visual_prompt is not None:
            vp = np.asarray(visual_prompt)
            if vp.ndim == 2:
                vp = np.stack([vp] * 3, axis=-1)
            vthumb = resize_nearest(vp, cfgt, cfgt).astype(np.float32)
            vcanvas = resize_nearest(vp, nch * cfgt, ncw * cfgt).astype(np.float32)
            vtiles = _split_tiles_np(vcanvas, ncw, nch)
            mv = np.concatenate([vthumb.transpose(2, 0, 1)[None], vtiles], axis=0)
            out["mask_values"] = self._normalize(mv).astype(np.float32)
        return out
