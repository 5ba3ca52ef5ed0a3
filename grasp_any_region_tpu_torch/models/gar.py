"""GAR model assembly (`grasp_any_region_tpu/models/gar.py`).

  1. mask patch embedding: a patchify-matmul over the binary prompt plane
  2. PE-ViT over all tiles with the mask embeds injected after patch embed
  3. projector (+2x pool) -> 256 tokens per tile
  4. order-preserving scatter of the image features into the token embeds
  5. RoI feature replay over each region's crop-token run
  6. Llama prefill / decode

Shapes are static: tiles are padded to a bucket, regions to R_max, and
validity masks make padding inert. Batch is a first-class axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..core.config import GARConfig
from ..core.weights import ParamGroup
from ..utils.profiling import annotate
from .llama import KVCache, LlamaParams, embed_tokens, llama_decode_step, llama_prefill, lm_logits
from .projector import ProjectorParams, projector_forward
from .replay import replay_features, replay_features_video, scatter_replay
from .vision import VisionParams, patchify, vision_forward


class GARBatch(NamedTuple):
    """Host-prepared, static-shape model inputs (one or more samples).

    input_ids:    (B, S) int32, right-padded with pad_id
    positions:    (B, S) int32
    segment_ids:  (B, S) int32, 1 for real tokens, 0 for padding
    pixel_values: (B, T, 3, H, W), T = 1 (thumbnail) + tile bucket
    mask_values:  (B, T, 3, H, W) prompt plane: normalized to [-1, 1]
                  (compat mode) or already binary {0, 1}
    aspect_ratio: (B, 2) int32 [ncw, nch]
    bboxes:       (B, R, 4) fp32 normalized region boxes
    replay_pos:   (B, R) int32 start of each region's 256-crop-token run
    replay_valid: (B, R) bool
    num_tiles:    (B,) int32, 1 + ncw*nch valid entries of pixel_values
    replay_tile:  (B, R) int32 frame of each region's crop run (video mode
                  only; None in image mode). `map_batch` passes None through.
    """

    input_ids: torch.Tensor
    positions: torch.Tensor
    segment_ids: torch.Tensor
    pixel_values: torch.Tensor
    mask_values: torch.Tensor
    aspect_ratio: torch.Tensor
    bboxes: torch.Tensor
    replay_pos: torch.Tensor
    replay_valid: torch.Tensor
    num_tiles: torch.Tensor
    replay_tile: Optional[torch.Tensor] = None


def map_batch(fn, *batches: GARBatch) -> GARBatch:
    """GARBatch of fn over the batches' fields, field by field. A field that
    is None in every batch stays None; batches that differ there raise."""
    fields = []
    for xs in zip(*batches):
        if any(x is None for x in xs):
            if not all(x is None for x in xs):
                raise ValueError("batches differ in which fields are None")
            fields.append(None)
        else:
            fields.append(fn(*xs))
    return GARBatch(*fields)


class GARParams(nn.Module):
    """The JAX `init_gar_params` tree: vision, projector, llm, mask_embed.
    q8 / drop_bf16: the int8 decoder tree; lora: (targets, rank) of an
    unmerged LoRA tree (`LlamaParams`)."""

    def __init__(self, cfg: GARConfig, device=None, dtype=None, *,
                 q8: Optional[Sequence[str]] = None, drop_bf16: bool = False,
                 lora: Optional[Tuple[Sequence[str], int]] = None):
        super().__init__()
        kh, kw = cfg.mask_patch_kernel
        self.vision = VisionParams(cfg.vision, device, dtype)
        self.projector = ProjectorParams(cfg, device, dtype)
        self.llm = LlamaParams(cfg.text, cfg.padded_vocab_size, device, dtype, q8=q8,
                               drop_bf16=drop_bf16, lora=lora)
        self.mask_embed = ParamGroup(
            {"kernel": (kh * kw * cfg.mask_in_channels, cfg.vision.width)}, device, dtype)


def decode_mask_values(cfg: GARConfig, mask_values: torch.Tensor, *,
                       compat: bool = True) -> torch.Tensor:
    """Binary region-vs-background plane. compat=True undoes the image
    normalization: ids = clamp(round((x+1)/2*255), 0, N); binary = ids != N.
    compat=False expects {0, 1} input already."""
    if not compat:
        return mask_values.float()
    n = cfg.prompt_numbers
    ids = torch.round((mask_values.float() + 1.0) / 2.0 * 255.0).clamp(0, n)
    return (ids != n).float()


def mask_patch_embed(params: GARParams, cfg: GARConfig,
                     binary_mask: torch.Tensor) -> torch.Tensor:
    """(T, 3, H, W) binary plane -> (T, N_patches, Dv)."""
    x = patchify(binary_mask, cfg.vision)
    return x @ params.mask_embed.kernel.to(x.dtype)


def encode_images(
    params: GARParams,
    cfg: GARConfig,
    pixel_values: torch.Tensor,  # (T, 3, H, W)
    mask_values: Optional[torch.Tensor] = None,
    *,
    mask_compat: bool = True,
    remat: bool = False,
    remat_group: int = 1,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """-> (T, tokens_per_tile, Dt): tower with mask embeds, CLS dropped,
    projected and pooled (the range "vision" under `utils/profiling.trace`).
    remat, remat_group: `vision_forward`'s."""
    with annotate("vision"):
        mask_embeds = None
        if mask_values is not None:
            binary = decode_mask_values(cfg, mask_values, compat=mask_compat)
            mask_embeds = mask_patch_embed(params, cfg, binary.to(compute_dtype))
        hidden = vision_forward(params.vision, cfg.vision, pixel_values, mask_embeds,
                                remat=remat, remat_group=remat_group,
                                compute_dtype=compute_dtype)
        if cfg.vision_use_cls_token:
            hidden = hidden[:, 1:, :]
        return projector_forward(params.projector, cfg, hidden)


def scatter_image_features(
    input_ids: torch.Tensor,  # (B, S)
    token_embeds: torch.Tensor,  # (B, S, D)
    image_features: torch.Tensor,  # (B, T, tok, D), valid tiles first
    media_token_id: int,
) -> torch.Tensor:
    """Order-preserving scatter: the j-th media placeholder of a row takes
    the j-th feature row of that sample."""
    b, t, tok, d = image_features.shape
    flat = image_features.reshape(b, t * tok, d)
    is_img = input_ids == media_token_id
    idx = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, t * tok - 1)
    feats = torch.gather(flat, 1, idx[:, :, None].expand(b, idx.shape[1], d))
    return torch.where(is_img[:, :, None], feats.to(token_embeds.dtype), token_embeds)


def build_prefill_embeds(
    params: GARParams,
    cfg: GARConfig,
    batch: GARBatch,
    *,
    mask_compat: bool = True,
    double_scale_compat: bool = True,
    remat: bool = False,
    remat_group: int = 1,
    compute_dtype=torch.bfloat16,
    video_mode: bool = False,
) -> torch.Tensor:
    """Token embeds + image-feature scatter + feature replay -> (B, S, Dt).
    Every step is differentiable (gather, where, the replay's out-of-place
    scatters, RoIAlign's gathers), so gradients reach the tower, the
    projector and the mask embed as in JAX.

    video_mode: the pixel_values rows are FRAMES (no thumbnail), the
    placeholders are video_token_id, and each region's replay samples its
    own frame (batch.replay_tile) instead of the merged tile grid."""
    b, t = batch.pixel_values.shape[:2]
    pix = batch.pixel_values.reshape((b * t,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((b * t,) + batch.mask_values.shape[2:])
    feats = encode_images(params, cfg, pix, msk, mask_compat=mask_compat, remat=remat,
                          remat_group=remat_group,
                          compute_dtype=compute_dtype)  # (B*T, tok, Dt)
    feats = feats.reshape(b, t, feats.shape[-2], feats.shape[-1])
    tok_embeds = embed_tokens(params.llm, batch.input_ids, compute_dtype)
    media_id = cfg.video_token_id if video_mode else cfg.image_token_id
    embeds = scatter_image_features(batch.input_ids, tok_embeds, feats, media_id)
    if video_mode:
        if batch.replay_tile is None:
            raise ValueError("video_mode needs batch.replay_tile (build_video_batch sets it)")
        replay = torch.stack([
            replay_features_video(cfg, feats[i], batch.replay_tile[i], batch.bboxes[i],
                                  double_scale_compat=double_scale_compat)
            for i in range(b)
        ])
    else:
        replay = torch.stack([
            replay_features(cfg, feats[i], batch.aspect_ratio[i], batch.bboxes[i],
                            double_scale_compat=double_scale_compat)
            for i in range(b)
        ])  # (B, R, 256, Dt)
    return scatter_replay(embeds, replay, batch.replay_pos, batch.replay_valid)


def gar_prefill(
    params: GARParams,
    cfg: GARConfig,
    batch: GARBatch,
    *,
    mask_compat: bool = True,
    double_scale_compat: bool = True,
    compute_dtype=torch.bfloat16,
    video_mode: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full multimodal prefill. Returns (hidden (B, S, D), (k, v)) with k/v
    (L, B, S, K, Dh). video_mode: `build_prefill_embeds`'."""
    embeds = build_prefill_embeds(params, cfg, batch, mask_compat=mask_compat,
                                  double_scale_compat=double_scale_compat,
                                  compute_dtype=compute_dtype, video_mode=video_mode)
    return llama_prefill(params.llm, cfg.text, embeds, batch.positions,
                         segment_ids=batch.segment_ids)


def gar_decode_step(
    params: GARParams,
    cfg: GARConfig,
    token_ids: torch.Tensor,  # (B,) current tokens
    cache: KVCache,
    prompt_pad: int,
    *,
    compute_dtype=torch.bfloat16,
    use_kernel: Union[bool, str, None] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. Returns (logits (B, V) fp32, the cache advanced in
    place). use_kernel picks the decode form (`llama_decode_step`): None
    is the fused form on a CUDA tensor and the XLA form on the CPU."""
    embeds = embed_tokens(params.llm, token_ids[:, None], compute_dtype)
    hidden, cache = llama_decode_step(params.llm, cfg.text, embeds, cache, prompt_pad,
                                      use_kernel=use_kernel)
    logits = lm_logits(params.llm, cfg.text, hidden[:, 0],
                       valid_vocab=cfg.extended_vocab_size)
    return logits, cache


def seed_cache_from_prefill(
    cfg: GARConfig,
    kv: Tuple[torch.Tensor, torch.Tensor],
    seq_lens: torch.Tensor,  # (B,) true prompt lengths
    max_len: int,
    dtype=torch.bfloat16,
    quantize_kv: bool = False,
) -> KVCache:
    """Place prefill K/V (L, B, S, K, Dh) into an unpaired head-major cache
    of max_len columns: the prompt block fills columns [0, S) and
    write_pos starts at S (== prompt_pad). The cache is bf16 by default,
    as in the JAX package.

    quantize_kv: store it int8 with one static fp32 scale per (layer,
    batch row, kv-head pair), the JAX package's granularity on its paired
    layout (`grasp_any_region_tpu/models/gar.py:seed_cache_from_prefill`):
    the amax over both heads of the pair and all max_len columns (the
    right-pad columns of short rows and the zero tail included), taken
    after the cast to `dtype`, with 1.5x headroom so the columns decode
    appends (quantized in kernel C8 with the same scale) survive moderate
    outliers. Heads 2p and 2p + 1 share scale p, so K must be even."""
    ks, vs = kv
    L, b, s, kh, dh = ks.shape
    assert max_len >= s
    k = ks.new_zeros((L, b, kh, max_len, dh), dtype=dtype)
    v = vs.new_zeros((L, b, kh, max_len, dh), dtype=dtype)
    k[:, :, :, :s] = ks.transpose(2, 3)
    v[:, :, :, :s] = vs.transpose(2, 3)
    k_scale = v_scale = None
    if quantize_kv:
        if kh % 2:
            raise ValueError(f"an int8 cache pairs kv heads; {kh} kv heads is odd")
        k, k_scale = _quantize_pairs(k)
        v, v_scale = _quantize_pairs(v)
    return KVCache(
        k=k, v=v,
        prompt_lens=seq_lens.to(device=ks.device, dtype=torch.int32),
        write_pos=torch.tensor(s, dtype=torch.int32, device=ks.device),
        k_scale=k_scale, v_scale=v_scale,
    )


def _quantize_pairs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, B, K, S, D) -> int8 values and (L, B, K/2, 1, 1) fp32 scales,
    one layer at a time (the fp32 copy of a whole gar_1b cache at B = 24
    would take 4 GB)."""
    L, b, kh, s, d = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((L, b, kh // 2, 1, 1), dtype=torch.float32, device=x.device)
    for i in range(L):
        xf = x[i].float().reshape(b, kh // 2, 2 * s * d)
        sc = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * 1.5 / 127.0, min=1e-8)
        q[i] = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8).reshape(b, kh, s, d)
        scale[i] = sc[..., None]
    return q, scale
