"""Rotary position embeddings: 1D (Llama-3 decoder) and 2D (PE ViT).

Half-rotation convention: rotate_half(x) = concat(-x2, x1) with
x = concat(x1, x2), x_rot = x * cos + rotate_half(x) * sin. Angles are fp32.
The 2D rope's learnable per-layer frequencies are initialised in
core/weights.py.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.config import TextConfig, VisionConfig


def llama_inv_freq(cfg: TextConfig, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, with optional llama3 scaling."""
    d = cfg.head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv = 1.0 / (cfg.rope_theta ** exponent)
    if cfg.rope_scaling_factor is None:
        return inv
    factor = cfg.rope_scaling_factor
    low = cfg.rope_low_freq_factor
    high = cfg.rope_high_freq_factor
    old_len = cfg.rope_original_max_position
    low_wavelen = old_len / low
    high_wavelen = old_len / high
    wavelen = 2.0 * math.pi / inv
    # llama3 rule: long wavelengths scaled by 1/factor, short kept, smooth between
    scaled = torch.where(wavelen > low_wavelen, inv / factor, inv)
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1 - smooth) / factor * inv + smooth * inv
    is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., head_dim) with duplicated halves."""
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) or (..., S, D); cos/sin broadcastable (..., S, D)."""
    if x.dim() == cos.dim() + 1:  # (..., S, H, D): insert the head axis
        cos = cos[..., :, None, :]
        sin = sin[..., :, None, :]
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def _grid_coords(cfg: VisionConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    gh, gw = cfg.grid_size
    ys = torch.arange(gh, dtype=torch.float32, device=device)
    xs = torch.arange(gw, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx.reshape(-1), yy.reshape(-1)


def axial_rope_angles(cfg: VisionConfig, device=None) -> torch.Tensor:
    """Non-learnable axial 2D rope: (num_patches, head_dim/2) angles shared by
    all blocks and heads; x drives the first d/4 pairs, y the rest."""
    d = cfg.head_dim
    t = torch.arange(0, d // 4, dtype=torch.float32, device=device)
    mag = 1.0 / (cfg.rope_temperature ** (t * 4.0 / d))
    xx, yy = _grid_coords(cfg, device)
    return torch.cat([xx[:, None] * mag, yy[:, None] * mag], dim=-1)


def mixed_rope_angles(freqs: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """freqs (depth, heads, d/2, 2) -> angles (depth, heads, num_patches, d/2)."""
    xx, yy = _grid_coords(cfg, freqs.device)
    coords = torch.stack([xx, yy], dim=-1)  # (N, 2)
    # ang[l,h,n,t] = fx[l,h,t]*x[n] + fy[l,h,t]*y[n]
    return torch.einsum("nc,lhtc->lhnt", coords, freqs.float())


def apply_rope_2d_tshd(
    x: torch.Tensor, angles: torch.Tensor, num_prefix: int = 1
) -> torch.Tensor:
    """Rotate the patch tokens of a (T, S, H, D) tensor; the prefix (CLS)
    tokens pass through unrotated. angles: (H, N, D/2) or (N, D/2)."""
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)  # (H|1, N, d/2)
    sin = torch.sin(angles)
    # -> (1, N, H|1, D)
    cos = torch.cat([cos, cos], dim=-1).permute(1, 0, 2)[None]
    sin = torch.cat([sin, sin], dim=-1).permute(1, 0, 2)[None]
    prefix, patches = x[:, :num_prefix], x[:, num_prefix:]
    pf = patches.to(cos.dtype)
    rotated = pf * cos + rotate_half(pf) * sin
    return torch.cat([prefix, rotated.to(x.dtype)], dim=1)


def rope_head_tables(
    angles: torch.Tensor, num_heads: int, num_prefix: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cos/sin tables for the fused-qkv ViT attention (kernel E,
    ops/vit_attention.vit_attention_fused_qkv).

    angles: (H|1, N, D/2), axial angles broadcast to H -> cos, sin (H, S, D)
    fp32 with duplicated halves, S = num_prefix + N; the prefix (CLS) rows
    are the identity rotation (cos 1, sin 0). The JAX package's
    `rope_pair_tables` holds the same values in a head-pair
    (H/2, S_pad, 2D) layout for the TPU's 128 lanes; the kernel here reads
    per head and needs no pad rows."""
    angles = angles.float().expand(num_heads, *angles.shape[-2:])
    prefix = (0, 0, num_prefix, 0)
    cos = torch.nn.functional.pad(torch.cos(angles).repeat(1, 1, 2), prefix, value=1.0)
    sin = torch.nn.functional.pad(torch.sin(angles).repeat(1, 1, 2), prefix)
    return cos, sin
