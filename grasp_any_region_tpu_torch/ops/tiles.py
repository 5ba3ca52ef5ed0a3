"""Tile split / merge as torch reshapes (`grasp_any_region_tpu/ops/tiles.py`).

Reference semantics:
  split: image_processing_perception_lm_fast.py:254-266  (canvas -> tiles)
  merge: grasp_any_region.py:233-245                     (tiles -> canvas)

The port's feature replay samples the tile array directly
(`models/replay.roi_align_tiled`); these are the merged-canvas forms it is
held against.
"""

from __future__ import annotations

import torch


def split_tiles(image: torch.Tensor, ncw: int, nch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, ncw*nch, C, H//nch, W//ncw), row-major tile order."""
    b, c, h, w = image.shape
    th, tw = h // nch, w // ncw
    x = image.reshape(b, c, nch, th, ncw, tw).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, nch * ncw, c, th, tw)


def merge_tiles(tiles: torch.Tensor, ncw: int, nch: int) -> torch.Tensor:
    """(B, ncw*nch, C, th, tw) -> (B, C, nch*th, ncw*tw). Inverse of split."""
    b, n, c, th, tw = tiles.shape
    if n != ncw * nch:
        raise ValueError(f"{n} tiles for a {ncw} x {nch} grid")
    x = tiles.reshape(b, nch, ncw, c, th, tw).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, nch * th, ncw * tw)


def merge_tiles_masked(tiles: torch.Tensor, ncw, nch, max_grid: int) -> torch.Tensor:
    """Merge onto a (max_grid x max_grid) canvas with the grid given as ints
    or device scalars: tile i goes to slot (i // ncw, i % ncw) when i <
    ncw * nch; the rest of the canvas is zero.

    tiles: (B, T, C, th, tw) with T >= ncw*nch; tiles past ncw*nch ignored.
    Returns (B, C, max_grid*th, max_grid*tw)."""
    b, t, c, th, tw = tiles.shape
    idx = torch.arange(t, device=tiles.device)
    valid = idx < ncw * nch
    slot = torch.where(valid, (idx // ncw) * max_grid + idx % ncw, 0)
    vals = torch.where(valid[None, :, None, None, None], tiles, torch.zeros((), dtype=tiles.dtype,
                                                                          device=tiles.device))
    canvas = tiles.new_zeros((b, max_grid * max_grid, c, th, tw))
    canvas.index_add_(1, slot, vals)
    canvas = canvas.reshape(b, max_grid, max_grid, c, th, tw).permute(0, 3, 1, 4, 2, 5)
    return canvas.reshape(b, c, max_grid * th, max_grid * tw)
