"""RoI-aligned feature replay, image mode (`grasp_any_region_tpu/models/replay.py`).

For each region, RoIAlign (torchvision `aligned=True`, sampling ratio 2,
written here in plain torch) samples a 16x16 crop of the region's box
straight off the tile array: global feature coordinates map to (tile, local)
indices, so bilinear taps that cross a tile border read the neighbouring
tile and the merged feature map is never built. The 256 crop vectors then
replace the embeddings of the region's crop-token run.

double_scale_compat=True reproduces the released checkpoints' double
scaling of the boxes (to feature coords, then by 1/28 once more).
Video mode waits for a later slice.
"""

from __future__ import annotations

import torch

from ..core.config import GARConfig, PIXELS_PER_POOLED_TOKEN, REPLAY_SIDE


def _roi_sample_coords(boxes: torch.Tensor, pooled: int, sampling_ratio: int):
    """Sample coordinates ys, xs, each (R, pooled, sampling_ratio) fp32.
    boxes: (R, 4) in feature coords."""
    start_w = boxes[:, 0] - 0.5
    start_h = boxes[:, 1] - 0.5
    bin_w = (boxes[:, 2] - boxes[:, 0]) / pooled
    bin_h = (boxes[:, 3] - boxes[:, 1]) / pooled
    p = torch.arange(pooled, dtype=torch.float32, device=boxes.device)
    frac = (torch.arange(sampling_ratio, dtype=torch.float32, device=boxes.device)
            + 0.5) / sampling_ratio
    grid = p[None, :, None] + frac[None, None, :]
    ys = start_h[:, None, None] + grid * bin_h[:, None, None]
    xs = start_w[:, None, None] + grid * bin_w[:, None, None]
    return ys, xs


def roi_align_tiled(
    tiles: torch.Tensor,  # (T, side, side, D) per-tile feature grids
    ncw: torch.Tensor,  # () int tile columns
    nch: torch.Tensor,  # () int tile rows
    boxes: torch.Tensor,  # (R, 4) in feature coords
    *,
    side: int = REPLAY_SIDE,
    pooled: int = REPLAY_SIDE,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign(aligned=True) over the row-major (nch*side, ncw*side) merge of
    the tiles, sampled off the tile array. Returns (R, pooled, pooled, D) fp32.
    ncw and nch may be device tensors: nothing here waits for the host."""
    t, sh, sw, d = tiles.shape
    assert sh == side and sw == side
    r = boxes.shape[0]
    h_i = (nch * side).long()
    w_i = (ncw * side).long()
    feat_h, feat_w = h_i.float(), w_i.float()
    flat = tiles.reshape(t * side * side, d).float()
    ys, xs = _roi_sample_coords(boxes.float(), pooled, sampling_ratio)
    out = torch.zeros((r, pooled, pooled, d), dtype=torch.float32, device=tiles.device)
    inv_count = 1.0 / (sampling_ratio * sampling_ratio)

    def gather_global(yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        """Integer global coords (R, pooled, pooled) -> (R, pooled, pooled, D);
        indices past the tile array are clamped (their weights are 0)."""
        tile_idx = (yy // side) * ncw + (xx // side)
        local = (yy % side) * side + (xx % side)
        gidx = (tile_idx * (side * side) + local).clamp(0, t * side * side - 1)
        return flat[gidx.reshape(-1)].reshape(r, pooled, pooled, d)

    for iy in range(sampling_ratio):
        for ix in range(sampling_ratio):
            y = ys[:, :, iy][:, :, None].expand(r, pooled, pooled)
            x = xs[:, :, ix][:, None, :].expand(r, pooled, pooled)
            oob = (y < -1.0) | (y > feat_h) | (x < -1.0) | (x > feat_w)
            yc = y.clamp(min=0.0)
            xc = x.clamp(min=0.0)
            y_low = torch.floor(yc).long()
            x_low = torch.floor(xc).long()
            y_clamp = y_low >= h_i - 1
            x_clamp = x_low >= w_i - 1
            y_low = torch.where(y_clamp, h_i - 1, y_low)
            x_low = torch.where(x_clamp, w_i - 1, x_low)
            y_high = torch.where(y_clamp, h_i - 1, y_low + 1)
            x_high = torch.where(x_clamp, w_i - 1, x_low + 1)
            yc = torch.where(y_clamp, y_low.float(), yc)
            xc = torch.where(x_clamp, x_low.float(), xc)
            ly, lx = yc - y_low, xc - x_low
            hy, hx = 1.0 - ly, 1.0 - lx
            zero = torch.zeros((), device=tiles.device)
            w1 = torch.where(oob, zero, hy * hx) * inv_count
            w2 = torch.where(oob, zero, hy * lx) * inv_count
            w3 = torch.where(oob, zero, ly * hx) * inv_count
            w4 = torch.where(oob, zero, ly * lx) * inv_count
            out = out + w1[..., None] * gather_global(y_low, x_low)
            out = out + w2[..., None] * gather_global(y_low, x_high)
            out = out + w3[..., None] * gather_global(y_high, x_low)
            out = out + w4[..., None] * gather_global(y_high, x_high)
    return out


def replay_features(
    cfg: GARConfig,
    image_features: torch.Tensor,  # (1+T, 256, Dt): thumbnail + T tiles
    aspect_ratio: torch.Tensor,  # (2,) int [ncw, nch]
    bboxes: torch.Tensor,  # (R, 4) normalized [x1, y1, x2, y2]
    *,
    double_scale_compat: bool = True,
) -> torch.Tensor:
    """-> (R, 256, Dt) fp32 replay features for R regions."""
    side = REPLAY_SIDE
    tiles = image_features[1:]  # thumbnail excluded
    t, n, dt = tiles.shape
    assert n == side * side
    grid = tiles.reshape(t, side, side, dt)
    ncw, nch = aspect_ratio[0], aspect_ratio[1]
    feat_w = (ncw * side).float()
    feat_h = (nch * side).float()
    boxes = bboxes.float()
    boxes_feat = torch.stack([boxes[:, 0] * feat_w, boxes[:, 1] * feat_h,
                              boxes[:, 2] * feat_w, boxes[:, 3] * feat_h], dim=-1)
    if double_scale_compat:
        boxes_feat = boxes_feat / PIXELS_PER_POOLED_TOKEN
    rois = roi_align_tiled(grid, ncw, nch, boxes_feat)
    # row-major flatten of the 16x16 crop
    return rois.reshape(-1, side * side, dt)


def scatter_replay(
    inputs_embeds: torch.Tensor,  # (B, S, Dt)
    replay: torch.Tensor,  # (B, R, 256, Dt)
    replay_pos: torch.Tensor,  # (B, R) int start of each crop run
    replay_valid: torch.Tensor,  # (B, R) bool
) -> torch.Tensor:
    """Write each valid region's 256 replay vectors at its crop-token span,
    regions in order (a later one wins an overlap). A start is clamped so
    the span fits, like jax.lax.dynamic_update_slice. Each write is an
    out-of-place scatter, so autograd sees every region's gather intact and
    the gradient reaches both the embeddings and the replay features."""
    b, s, d = inputs_embeds.shape
    r, n = replay.shape[1], replay.shape[2]
    out = inputs_embeds
    offs = torch.arange(n, device=out.device)
    for i in range(r):
        start = replay_pos[:, i].long().clamp(0, s - n)
        idx = (start[:, None] + offs)[:, :, None].expand(b, n, d)  # (B, n, D)
        cur = torch.gather(out, 1, idx)
        new = torch.where(replay_valid[:, i, None, None], replay[:, i].to(out.dtype), cur)
        out = out.scatter(1, idx, new)
    return out
