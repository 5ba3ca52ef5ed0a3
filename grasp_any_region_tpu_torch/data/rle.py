"""COCO run-length-encoded masks and polygons (`grasp_any_region_tpu/data/rle.py`).

The COCO format, from its public spec:
  * masks flatten column-major (Fortran order);
  * `counts` alternates runs of 0s and 1s, starting with the 0-run;
  * compressed counts are 5-bit chunks with a continuation bit, offset by
    48 ('0'), each value past the first two a delta to counts[i - 2].

`decode_rle` and `encode_rle` run the C++ codec (`native/rle.cc` through
`data/native.py`) unless the caller passes use_native=False; the numpy
bodies are the reference. `encode_rle` gives JAX's count string byte for
byte either way.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _decode_counts(data: bytes) -> List[int]:
    counts: List[int] = []
    i = 0
    n = len(data)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = data[i] - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[len(counts) - 2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> bytes:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode_rle(rle: Dict, use_native: bool = True) -> np.ndarray:
    """COCO RLE dict -> (H, W) uint8 mask. Compressed counts go through the
    C++ codec when use_native (a failed build raises); counts given as a
    list of runs, and use_native=False, through numpy."""
    if use_native:
        from .native import decode_rle_native

        out = decode_rle_native(rle)
        if out is not None:
            return out
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    if isinstance(counts, (bytes, bytearray)):
        counts = _decode_counts(bytes(counts))
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE covers {total} pixels, expected {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape((h, w), order="F")


def _runs(mask: np.ndarray) -> List[int]:
    flat = np.asarray(mask, np.uint8).reshape(-1, order="F")
    if not flat.size:
        return [0]
    changes = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]])).tolist()
    return [0] + runs if flat[0] == 1 else runs


def encode_rle(mask: np.ndarray, compress: bool = True, use_native: bool = True) -> Dict:
    """(H, W) binary mask -> COCO RLE dict, the counts ASCII bytes when
    compressed (as JAX's), else the list of runs."""
    h, w = mask.shape
    if use_native:
        from .native import encode_runs_native

        runs = [int(r) for r in encode_runs_native(mask)]
    else:
        runs = _runs(mask)
    return {"size": [h, w], "counts": _encode_counts(runs) if compress else runs}


def rle_area(rle: Dict) -> int:
    return int(decode_rle(rle).sum())


def decode_any(rle_or_list: Union[Dict, List[Dict]]) -> List[np.ndarray]:
    """One RLE dict or a list of them -> the list of masks."""
    if isinstance(rle_or_list, dict):
        return [decode_rle(rle_or_list)]
    return [decode_rle(r) for r in rle_or_list]


def polygon_to_mask(polygons: List[List[float]], height: int, width: int) -> np.ndarray:
    """COCO polygon segmentation -> (H, W) binary mask: an even-odd scanline
    fill at pixel centres, the union over the polygon's parts (boundary
    pixels may differ from pycocotools' by one)."""
    mask = np.zeros((height, width), np.uint8)
    ys = np.arange(height) + 0.5
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)  # (N, 2) x, y
        if len(pts) < 3:
            continue
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            # edge crosses scanline yc if min(y0, y1) <= yc < max(y0, y1)
            cond = ((y0[None, :] <= ys[:, None]) & (y1[None, :] > ys[:, None])) | (
                (y1[None, :] <= ys[:, None]) & (y0[None, :] > ys[:, None]))
            t = (ys[:, None] - y0[None, :]) / (y1[None, :] - y0[None, :])
            xs = x0[None, :] + t * (x1[None, :] - x0[None, :])
        for row in range(height):
            cross = np.sort(xs[row][cond[row]])
            for a, b in zip(cross[0::2], cross[1::2]):
                lo = int(np.ceil(a - 0.5))
                hi = int(np.ceil(b - 0.5))
                if hi > lo:
                    mask[row, max(lo, 0): min(hi, width)] = 1
    return mask


def segmentation_to_mask(seg, height: int, width: int) -> np.ndarray:
    """Any COCO segmentation (RLE dict, uncompressed dict, or polygon list)."""
    if isinstance(seg, dict):
        return decode_rle(seg)
    return polygon_to_mask(seg, height, width)
