"""Perception-Encoder ViT tower (`grasp_any_region_tpu/models/vision.py`).

  patch_embed -> (+ mask_embeds) -> CLS + abs pos -> ln_pre ->
  blocks (2D rope per layer and head, CLS unroped) -> ln_post

Each block runs in one of the JAX package's two forms:

  * fused (`_fused_block`, the TPU default): four kernels per layer, D
    LayerNorm + qkv (ops/vit_block.py), E rope + attention read from the
    fused qkv buffer (ops/vit_attention.py), F wo + LayerScale + residual,
    G LayerNorm + fc1 + GELU + fc2 + LayerScale + residual (ops/vit_block.py);
  * unfused (`_block`): LayerNorm, rope, GELU and the qkv, wo and MLP
    products in plain torch, as XLA runs them, around kernel A (where a
    gradient is needed, `vit_attention_df`: A with its LSE forward, kernel 5
    backward).

Under a multi-rank mesh (`vision_forward(mesh=)`) the tower runs unfused,
each layer's weights gathered from their fsdp shards just before it; with
a tensor axis that divides the heads and the MLP width, each rank runs
kernel A (and kernel 5 backward) on its own heads and its own MLP columns,
megatron-style (`_sharded_block`).

Training runs the unfused form under remat: each block is checkpointed
(`torch.utils.checkpoint`, non-reentrant), or groups of blocks each
checkpointed around their checkpointed blocks (`remat_group`), as the JAX
package's `jax.checkpoint` scans do. The fused kernels have no backward;
the fused form is off under remat and raises where a gradient is needed.

All tiles of the batch are one leading dim (T, S, D).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import VisionConfig
from ..core.weights import ParamGroup, add_param
from ..ops.norms import layer_norm
from ..ops.rope import (apply_rope_2d_tshd, axial_rope_angles, mixed_rope_angles,
                        rope_head_tables)
from ..ops.vit_attention import E_MAX_SEQ, vit_attention_df, vit_attention_fused_qkv
from ..ops.vit_block import vit_ln_qkv, vit_mlp_residual, vit_wo_residual
from ..parallel.collectives import copy_to, reduce_from


class VisionParams(nn.Module):
    """Names and layouts of the JAX `params["vision"]` tree: (Din, Dout)
    kernels used as x @ W, blocks stacked on a leading L axis, and the
    channel-major (3*p*p, D) patch kernel."""

    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        d, m, L, p = cfg.width, cfg.mlp_hidden, cfg.depth, cfg.patch_size
        self.patch_embed = ParamGroup({"kernel": (p * p * 3, d), "bias": (d,)}, device, dtype)
        if cfg.use_ln_pre:
            self.ln_pre = ParamGroup({"scale": (d,), "bias": (d,)}, device, dtype)
        if cfg.use_ln_post:
            self.ln_post = ParamGroup({"scale": (d,), "bias": (d,)}, device, dtype)
        blocks = {
            "ln1_scale": (L, d), "ln1_bias": (L, d),
            "wqkv": (L, d, 3 * d), "bqkv": (L, 3 * d),
            "wo": (L, d, d), "bo": (L, d),
            "ln2_scale": (L, d), "ln2_bias": (L, d),
            "fc1": (L, d, m), "b1": (L, m),
            "fc2": (L, m, d), "b2": (L, d),
        }
        if cfg.init_values is not None:
            blocks.update(ls1=(L, d), ls2=(L, d))
        self.blocks = ParamGroup(blocks, device, dtype)
        if cfg.class_token:
            add_param(self, "cls_token", (1, 1, d), device, dtype)
        if cfg.use_abs_pos:
            add_param(self, "pos_embed", (cfg.seq_len, d), device, dtype)
        if cfg.use_rope and cfg.rope_mixed:
            # learned rope frequencies stay fp32, as in the JAX tree
            add_param(self, "rope_freqs", (L, cfg.num_heads, cfg.head_dim // 2, 2),
                      device, torch.float32)


def patchify(pixel_values: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """(T, 3, H, W) -> (T, gh*gw, 3*p*p) patch pixels, row-major patches,
    channel-major within a patch (c, ph, pw)."""
    t, c, h, w = pixel_values.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = pixel_values.reshape(t, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(t, gh * gw, c * p * p)


def _block(cfg: VisionConfig, x: torch.Tensor, bp: dict,
           angles: Optional[torch.Tensor], tp=None) -> torch.Tensor:
    """One transformer block. x: (T, S, D); angles: (H|1, N, d/2) or None.
    tp: the tensor group of a tensor-parallel block, whose bp holds this
    rank's heads' q, k, v columns and wo rows and its MLP columns (cfg
    giving its heads); None on one rank."""
    t, s, d = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    n_prefix = 1 if cfg.class_token else 0

    y = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    if tp is not None:
        y = copy_to(y, tp)
    qkv = (y @ bp["wqkv"].to(y.dtype) + bp["bqkv"].to(y.dtype)).reshape(t, s, 3, h, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if angles is not None:
        q = apply_rope_2d_tshd(q, angles, n_prefix)
        k = apply_rope_2d_tshd(k, angles, n_prefix)
    attn = vit_attention_df(q, k, v)
    attn = attn.reshape(t, s, -1) @ bp["wo"].to(x.dtype)
    if tp is not None:
        attn = reduce_from(attn, tp)
    attn = attn + bp["bo"].to(x.dtype)
    if "ls1" in bp:
        attn = attn * bp["ls1"].to(attn.dtype)
    x = x + attn

    y = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    if tp is not None:
        y = copy_to(y, tp)
    y = y @ bp["fc1"].to(y.dtype) + bp["b1"].to(y.dtype)
    y = F.gelu(y, approximate="tanh" if cfg.fast_gelu else "none")
    y = y @ bp["fc2"].to(y.dtype)
    if tp is not None:
        y = reduce_from(y, tp)
    y = y + bp["b2"].to(y.dtype)
    if "ls2" in bp:
        y = y * bp["ls2"].to(y.dtype)
    return x + y


def _sharded_block(cfg: VisionConfig, blocks: nn.Module, mesh):
    """block(cfg, x, views, angles) of a multi-rank mesh: gathers the
    layer's weights from their shards' views (inside the caller's
    checkpoint, so again in the backward), then `_block`. With a tensor
    axis that divides the heads and the MLP width, the rank keeps its own
    heads and MLP columns: wqkv is gathered whole (its tensor shards split
    [q | k | v] and not the heads) and this rank's q, k, v columns taken,
    the replicated biases and per-head rope angles enter the region through
    `copy_to`; wo and fc2 sum their parts over the tensor ranks."""
    from ..parallel.sharding import KEEP, SUM, gather_layer, layer_specs, tensor_rows

    specs = layer_specs(blocks)
    t, h, m = mesh.shape["tensor"], cfg.num_heads, cfg.mlp_hidden
    if t == 1 or h % t or m % t:
        return lambda cfg, x, views, angles: _block(cfg, x, gather_layer(views, specs, mesh),
                                                    angles)
    tp = mesh.group("tensor")
    d, (h0, h1), (m0, m1) = cfg.width, tensor_rows(h, mesh), tensor_rows(m, mesh)
    dh = cfg.head_dim
    cols = torch.cat([torch.arange(j * d + h0 * dh, j * d + h1 * dh) for j in range(3)])
    lcfg = dataclasses.replace(cfg, width=(h1 - h0) * dh, num_heads=h1 - h0)
    modes = {"wqkv": SUM, "wo": KEEP, "fc1": KEEP, "fc2": KEEP}

    def block(cfg, x, views, angles):
        bp = gather_layer(views, specs, mesh, modes)
        idx = cols.to(x.device)
        bp["wqkv"] = bp["wqkv"].index_select(1, idx)
        bp["bqkv"] = copy_to(bp["bqkv"], tp).index_select(0, idx)
        bp["b1"] = copy_to(bp["b1"], tp)[m0:m1]
        if angles is not None and angles.shape[0] > 1:
            angles = copy_to(angles, tp)[h0:h1]
        return _block(lcfg, x, bp, angles, tp)

    return block


def _fused_block(cfg: VisionConfig, x: torch.Tensor, bp: dict,
                 angles: torch.Tensor) -> torch.Tensor:
    """One block as the four fused kernels D, E, F, G (the JAX package's
    `vision_forward(fused_blocks=True)` body). x: (T, S, D); angles:
    (H|1, N, d/2). S is not padded: the kernels mask the ragged rows."""
    n_prefix = 1 if cfg.class_token else 0
    cos, sin = rope_head_tables(angles, cfg.num_heads, n_prefix)
    qkv = vit_ln_qkv(x, bp["ln1_scale"], bp["ln1_bias"], bp["wqkv"], bp["bqkv"])
    attn = vit_attention_fused_qkv(qkv, cos, sin, cfg.num_heads, cfg.head_dim)
    x = vit_wo_residual(attn, x, bp["wo"], bp["bo"], bp.get("ls1"))
    return vit_mlp_residual(x, bp["ln2_scale"], bp["ln2_bias"], bp["fc1"], bp["b1"],
                            bp["fc2"], bp["b2"], bp.get("ls2"), fast_gelu=cfg.fast_gelu)


def vision_embed(
    params: VisionParams,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,
    mask_embeds: Optional[torch.Tensor] = None,
    *,
    compute_dtype=torch.bfloat16,
):
    """patchify + patch embed + mask-embed injection + CLS + abs pos +
    ln_pre, plus the per-layer rope angles.

    Returns (x (T, S, D), angles (L, H|1, N, d/2) or None)."""
    t = pixel_values.shape[0]
    d = cfg.width
    x = patchify(pixel_values.to(compute_dtype), cfg)
    x = x @ params.patch_embed.kernel.to(compute_dtype)
    x = x + params.patch_embed.bias.to(compute_dtype)
    if mask_embeds is not None:
        x = x + mask_embeds.to(compute_dtype)
    if cfg.class_token:
        cls = params.cls_token.to(compute_dtype).expand(t, 1, d)
        x = torch.cat([cls, x], dim=1)
    if cfg.use_abs_pos:
        x = x + params.pos_embed.to(compute_dtype)
    if cfg.use_ln_pre:
        x = layer_norm(x, params.ln_pre.scale, params.ln_pre.bias)

    if not cfg.use_rope:
        return x, None
    if cfg.rope_mixed:
        return x, mixed_rope_angles(params.rope_freqs, cfg)  # (L, H, N, d/2)
    ax = axial_rope_angles(cfg, x.device)  # (N, d/2)
    return x, ax[None, None].expand(cfg.depth, 1, *ax.shape)


def vision_forward(
    params: VisionParams,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,
    mask_embeds: Optional[torch.Tensor] = None,
    *,
    remat: bool = False,
    remat_group: int = 1,
    compute_dtype=torch.bfloat16,
    fused_blocks: Optional[bool] = None,
    mesh=None,
) -> torch.Tensor:
    """pixel_values: (T, 3, H, W), all tiles of the batch; mask_embeds:
    (T, N, D) added right after the patch embed. Returns (T, S, D) final
    hidden states, CLS still at index 0.

    remat: checkpoint every block (its activations are recomputed in the
    backward); remat_group > 1 also checkpoints groups of that many blocks
    (the trailing depth % g blocks stay singly checkpointed), so only
    ceil(depth / g) + g block inputs are live, for one more tower forward.

    fused_blocks: run each layer as the four fused kernels. None = auto, as
    the JAX package decides it with "on the TPU" read as "on a CUDA tensor":
    on for head_dim 64, an even head count and rope (so gar_1b on the card
    is fused and gar_8b, head_dim 96, is not), and off under remat. Off too
    past kernel E's E_MAX_SEQ tokens a tile, which it keeps in shared memory
    (gar_1b has 1025). True on a CPU tensor runs the kernels' plain
    versions.

    mesh: a multi-rank mesh runs `_sharded_block` (unfused) over this rank's
    tiles, params then being `parallel/sharding.full_tree` of the sharded
    tree (its `blocks` still the shards)."""
    multi = mesh is not None and mesh.size > 1
    if multi and fused_blocks:
        raise ValueError("the fused ViT block has no sharded form: a mesh runs it unfused")
    x, angles = vision_embed(params, cfg, pixel_values, mask_embeds,
                             compute_dtype=compute_dtype)
    if multi:
        fused_blocks = False
    if fused_blocks is None:
        fused_blocks = (not remat and x.device.type == "cuda" and cfg.head_dim == 64
                        and cfg.num_heads % 2 == 0 and cfg.use_rope
                        and x.shape[1] <= E_MAX_SEQ)
    if fused_blocks and angles is None:
        raise ValueError("the fused ViT block needs rope (use_rope=True)")
    if fused_blocks and torch.is_grad_enabled() and any(
            p.requires_grad for p in params.parameters()):
        raise ValueError("the fused ViT block has no backward: train with remat=True or "
                         "fused_blocks=False")
    block = _fused_block if fused_blocks else _block
    if multi:
        block = _sharded_block(cfg, params.blocks, mesh)
    layers = params.blocks.layers()
    angle_layers = [None] * cfg.depth if angles is None else angles.unbind(0)

    def run(x, lo, hi):
        for i in range(lo, hi):
            if remat:
                x = checkpoint(block, cfg, x, layers[i], angle_layers[i], use_reentrant=False)
            else:
                x = block(cfg, x, layers[i], angle_layers[i])
        return x

    g = remat_group if remat else 1
    n_grouped = cfg.depth - cfg.depth % g if g > 1 else 0
    for lo in range(0, n_grouped, g):
        x = checkpoint(run, x, lo, lo + g, use_reentrant=False)
    x = run(x, n_grouped, cfg.depth)
    if cfg.use_ln_post:
        x = layer_norm(x, params.ln_post.scale, params.ln_post.bias)
    return x
