"""Analytic matmul-FLOP accounting for achieved-TFLOP/s claims: the port's
copy of `grasp_any_region_tpu/utils/flops.py:gar_flops` (pure Python).

Counts matmul FLOPs only (elementwise passes and norms are bandwidth, not
tensor-core work, and are <1% of the total at these shapes).

Conventions:
  * a matmul contributing P parameter entries to a token costs 2*P
    FLOPs/token forward;
  * backward costs 2x forward (dX and dW products);
  * remat recompute costs +1x forward of the checkpointed span — the ViT
    blocks, decoder blocks and the chunked-CE head are all checkpointed,
    i.e. ~the whole forward;
  * causal flash attention executes ~half the full S^2 score/value
    products (the kernel skips fully-masked blocks).
"""

from __future__ import annotations

from typing import Dict

from ..core.config import GARConfig


def gar_flops(
    cfg: GARConfig,
    *,
    batch: int,
    seq: int,
    tiles: int,
    train: bool = True,
) -> Dict[str, float]:
    """Per-step matmul FLOPs for the GAR forward (and train step).

    tiles: total ViT tile count across the batch (thumbnail + crops;
    the standard 4x4-grid sample is 17 per image).
    Returns a breakdown dict; key "total" is the MFU numerator.
    """
    t = cfg.text
    v = cfg.vision

    # ---- decoder ----
    d, f = t.hidden_size, t.intermediate_size
    q_dim = t.num_heads * t.head_dim
    kv_dim = t.num_kv_heads * t.head_dim
    per_layer = d * q_dim + 2 * d * kv_dim + q_dim * d + 3 * d * f
    dec_proj = 2.0 * per_layer * t.num_layers * batch * seq
    # causal flash: ~S^2/2 of the 2*(QK^T)+2*(AV) products
    dec_attn = 0.5 * 4.0 * seq * seq * q_dim * t.num_layers * batch

    # ---- vision tower ----
    vt = (v.img_size[0] // v.patch_size) ** 2 + (1 if v.class_token else 0)
    vw = v.width
    v_per_layer = 4 * vw * vw + 2 * vw * int(v.mlp_ratio * vw)
    vit_proj = 2.0 * v_per_layer * v.depth * tiles * vt
    vit_attn = 4.0 * vt * vt * vw * v.depth * tiles
    patch = 2.0 * (v.patch_size**2 * 3) * vw * tiles * vt

    # ---- projector (2x2 pool then MLP to d) ----
    pooled = tiles * vt // (cfg.projector_pooling_ratio**2)
    proj = 2.0 * (vw * d + d * d) * pooled

    # ---- LM head (tied embedding contraction in chunked CE) ----
    head = 2.0 * d * cfg.padded_vocab_size * batch * seq

    fwd = dec_proj + dec_attn + vit_proj + vit_attn + patch + proj + head
    out = {
        "decoder": dec_proj + dec_attn,
        "vision": vit_proj + vit_attn + patch,
        "projector": proj,
        "lm_head": head,
        "fwd": fwd,
    }
    # bwd = 2x fwd; remat recompute = +1x fwd (blocks + CE head all
    # checkpointed) => a train step executes ~4x the forward matmul FLOPs
    out["total"] = 4.0 * fwd if train else fwd
    return out
