"""Host-side image resampling: separable bicubic (antialiased) and nearest
(`grasp_any_region_tpu/data/resize.py`, its numpy form).

RGB is resized bicubic with antialiasing, the prompt-id matrix nearest.
The bicubic is the classic separable algorithm of PIL and torchvision's
antialias: the Keys kernel (a = -0.5), its support scaled by the
downsampling factor, weights normalized per output pixel. The numpy body
is the JAX package's numpy path, so its outputs are bit-equal to it; as in
JAX, `resize_bicubic` dispatches to the multithreaded C++ form of the same
arithmetic (`native/resize.cc` through `data/native.py`) unless the caller
passes use_native=False. The numpy body stays as the reference.
"""

from __future__ import annotations

import numpy as np

_A = -0.5  # Keys cubic coefficient (PIL / torchvision convention)


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (_A + 2.0) * ax3 - (_A + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, _A * ax3 - 5.0 * _A * ax2 + 8.0 * _A * ax - 4.0 * _A, 0.0),
    )


def _axis_weights(in_size: int, out_size: int, antialias: bool = True):
    """Per-output-pixel (indices, weights) along one axis, PIL convention."""
    scale = in_size / out_size
    support = 2.0  # bicubic support
    filterscale = max(scale, 1.0) if antialias else 1.0
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 2

    out = np.arange(out_size, dtype=np.float64)
    center = (out + 0.5) * scale  # source-space center
    # PIL's window: xmin = int(center - support + 0.5) clipped at 0,
    # xmax = min(int(center + support + 0.5), in_size)
    xmin = np.floor(center - support + 0.5).astype(np.int64)
    xmin = np.clip(xmin, 0, None)
    xmax = np.minimum(np.floor(center + support + 0.5).astype(np.int64), in_size)
    sizes = xmax - xmin

    idx = xmin[:, None] + np.arange(ksize)[None, :]  # (out, ksize)
    valid = np.arange(ksize)[None, :] < sizes[:, None]
    idx_c = np.clip(idx, 0, in_size - 1)
    x = (idx + 0.5 - center[:, None]) / filterscale
    w = _cubic(x) * valid
    wsum = w.sum(axis=1, keepdims=True)
    wsum[wsum == 0] = 1.0
    w = w / wsum
    return idx_c, w.astype(np.float64)


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int, antialias: bool = True,
                   use_native: bool = True) -> np.ndarray:
    """img (H, W, C) or (H, W) float / uint8 -> (out_h, out_w[, C]) float64.
    The caller clamps and casts. use_native: the C++ resampler, built at
    first use (a failed build raises); else the numpy body."""
    if use_native:
        from . import native

        return native.resize_bicubic_native(img, out_h, out_w, antialias)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    data = img.astype(np.float64)
    idx, wt = _axis_weights(w, out_w, antialias)  # horizontal pass
    data = _apply_axis(data, idx, wt, axis=1)
    idx, wt = _axis_weights(h, out_h, antialias)  # vertical pass
    data = _apply_axis(data, idx, wt, axis=0)
    return data[:, :, 0] if squeeze else data


def _apply_axis(data: np.ndarray, idx: np.ndarray, wt: np.ndarray, axis: int) -> np.ndarray:
    """Weighted gather-sum along `axis`. data (H, W, C)."""
    if axis == 1:
        g = data[:, idx, :]  # (H, out, k, C)
        return np.einsum("hokc,ok->hoc", g, wt, optimize=True)
    g = data[idx, :, :]  # (out, k, W, C)
    return np.einsum("okwc,ok->owc", g, wt, optimize=True)


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL NEAREST: src = floor((dst + 0.5) * scale), clamped."""
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(out_h) + 0.5) * (h / out_h), h - 1).astype(np.int64)
    xs = np.minimum((np.arange(out_w) + 0.5) * (w / out_w), w - 1).astype(np.int64)
    return img[ys[:, None], xs[None, :]]
