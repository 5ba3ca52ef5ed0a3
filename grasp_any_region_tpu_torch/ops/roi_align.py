"""RoIAlign over one feature map with torchvision's semantics
(`grasp_any_region_tpu/ops/roi_align.py`), batched over regions:

  * `aligned=True` half-pixel convention (coords = box * scale - 0.5)
  * a fixed sampling_ratio x sampling_ratio sample grid per output bin
  * out-of-range sample points (y < -1 or y > H) contribute 0
  * boundary samples collapse to the last row / column (torchvision's
    `y_low >= H - 1` branch)

Plain torch on any device (JAX's is XLA: gathers and a mean, no kernel).
The GAR replay samples the tile array directly (`models/replay.py`); this
is the merged-map form it is held against.
"""

from __future__ import annotations

import torch

from ..models.replay import _bilinear_taps


def roi_align(
    feat: torch.Tensor,
    boxes: torch.Tensor,
    output_size: tuple = (16, 16),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """feat: (C, H, W); boxes: (R, 4) [x1, y1, x2, y2] in box coordinates
    (scaled by spatial_scale, as torchvision's). Returns (R, C, out_h,
    out_w) fp32."""
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio (<= 0) is not supported (GAR uses 2)")
    feat = feat.float()
    boxes = boxes.float()
    c, h, w = feat.shape
    ph, pw = output_size
    sr = sampling_ratio
    offset = 0.5 if aligned else 0.0
    start_w = boxes[:, 0] * spatial_scale - offset
    start_h = boxes[:, 1] * spatial_scale - offset
    roi_w = boxes[:, 2] * spatial_scale - offset - start_w
    roi_h = boxes[:, 3] * spatial_scale - offset - start_h
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_h = (roi_h / ph)[:, None, None]
    bin_w = (roi_w / pw)[:, None, None]
    frac = ((torch.arange(sr, dtype=torch.float32, device=feat.device) + 0.5) / sr)[None, None]
    py = torch.arange(ph, dtype=torch.float32, device=feat.device)[None, :, None]
    px = torch.arange(pw, dtype=torch.float32, device=feat.device)[None, :, None]
    ys = start_h[:, None, None] + py * bin_h + frac * bin_h  # (R, ph, sr)
    xs = start_w[:, None, None] + px * bin_w + frac * bin_w  # (R, pw, sr)
    yy = ys[:, :, :, None, None]  # the sample grid (R, ph, sr, pw, sr)
    xx = xs[:, None, None, :, :]
    flat = feat.reshape(c, h * w)
    out = feat.new_zeros((c,) + torch.broadcast_shapes(yy.shape, xx.shape))
    for y_i, x_i, wt in _bilinear_taps(yy, xx, h, w, float(h), float(w), 1.0 / (sr * sr)):
        idx = (y_i * w + x_i).expand(out.shape[1:])
        out = out + wt * flat[:, idx.reshape(-1)].reshape(out.shape)
    return out.sum(dim=(3, 5)).permute(1, 0, 2, 3)
