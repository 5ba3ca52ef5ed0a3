"""Model configuration: the dataclasses, presets and token-id constants of
the JAX package (`grasp_any_region_tpu/core/config.py`), restated here in
pure Python so that this package never imports jax, with the same dict /
JSON round trip, dotted overrides and HF `config.json` mapping, so that a
`config.json` written by either package loads in the other.

tests/test_torch_ops.py holds every preset equal, field for field, to the
JAX one; tests/test_torch_checkpoint.py the I/O.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Token-id invariants shared with the reference checkpoints.
IMAGE_TOKEN_ID = 128002
VIDEO_TOKEN_ID = 128003
BASE_VOCAB_SIZE = 128256  # Llama-3 vocab; <Prompt_i>/<NO_Prompt> appended after
# <|reserved_special_token_{pid+2}|> ids for prompt slots 0..4:
CROP_TOKEN_IDS_5 = (128004, 128005, 128008, 128010, 128011)
# Llama-3 chat-template structural ids
BOT_TOKEN_ID = 128000  # <|begin_of_text|>
START_HEADER_ID = 128006
END_HEADER_ID = 128007
EOT_TOKEN_ID = 128009  # <|eot_id|>
ASSISTANT_ROLE_ID = 78191  # token for "assistant"
NEWLINE2_ID = 271  # token for "\n\n"

# Exactly 256 replay tokens per region: roi_align output 16x16 == crop-token
# run length.
REPLAY_TOKENS_PER_REGION = 256
REPLAY_SIDE = 16
# Each pooled vision token spans 28 original pixels.
PIXELS_PER_POOLED_TOKEN = 28


def crop_token_ids(prompt_numbers: int) -> Tuple[int, ...]:
    """ids of `<|reserved_special_token_{pid+2}|>` for pid in [0, prompt_numbers).

    Reserved tokens 0..4 of the prompt slots are the fixed list above; past
    it, reserved_k = 128005 + k, so prompt pid >= 5 maps to 128007 + pid.
    """
    if prompt_numbers <= len(CROP_TOKEN_IDS_5):
        return CROP_TOKEN_IDS_5[:prompt_numbers]
    extra = tuple(128007 + pid for pid in range(5, prompt_numbers))
    return CROP_TOKEN_IDS_5 + extra


@dataclass(frozen=True)
class VisionConfig:
    """Perception-Encoder ViT tower."""

    width: int = 1024
    depth: int = 23
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: Tuple[int, int] = (448, 448)
    class_token: bool = True
    use_abs_pos: bool = True
    use_rope: bool = True
    rope_mixed: bool = True  # per-block learned 2D rope freqs
    rope_temperature: float = 100.0
    ref_feat_shape: Tuple[int, int] = (32, 32)
    init_values: Optional[float] = 0.1  # LayerScale init; None = no LayerScale
    use_ln_pre: bool = True
    use_ln_post: bool = True
    qkv_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    attn_pool: bool = False
    fast_gelu: bool = False  # tanh-approximate GELU (gar_1b / gar_8b)
    dtype: str = "bfloat16"

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.class_token else 0)

    @property
    def head_dim(self) -> int:
        assert self.width % self.num_heads == 0
        return self.width // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class TextConfig:
    """Llama-3-family decoder."""

    vocab_size: int = BASE_VOCAB_SIZE
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    # Llama-3.x rope scaling ("llama3" type)
    rope_scaling_factor: Optional[float] = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    dtype: str = "bfloat16"

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class GARConfig:
    """Full GAR model: PE-ViT + projector + Llama decoder + mask patch embed +
    prompt vocabulary + feature replay."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    projector_pooling_ratio: int = 2
    vision_use_cls_token: bool = True
    image_token_id: int = IMAGE_TOKEN_ID
    video_token_id: int = VIDEO_TOKEN_ID
    prompt_numbers: int = 5
    tile_size: int = 448
    max_num_tiles: int = 16
    mask_in_channels: int = 3  # rasterized prompt matrix arrives as 3-channel

    @property
    def crop_token_ids(self) -> Tuple[int, ...]:
        return crop_token_ids(self.prompt_numbers)

    @property
    def extended_vocab_size(self) -> int:
        return BASE_VOCAB_SIZE + self.prompt_numbers + 1

    @property
    def padded_vocab_size(self) -> int:
        """Embedding rows padded to a multiple of 256; rows past
        extended_vocab_size are dead (their logits are masked)."""
        v = self.extended_vocab_size
        return ((v + 255) // 256) * 256

    @property
    def mask_patch_kernel(self) -> Tuple[int, int]:
        """Kernel/stride of the mask patch embed: img_size // ref_feat_shape,
        which equals patch_size so the mask embeds add onto patch tokens."""
        kh = self.vision.img_size[0] // self.vision.ref_feat_shape[0]
        kw = self.vision.img_size[1] // self.vision.ref_feat_shape[1]
        return (kh, kw)

    @property
    def tokens_per_tile(self) -> int:
        g = self.tile_size // self.vision.patch_size // self.projector_pooling_ratio
        return g * g  # 256 at 448/14/2


def gar_1b() -> GARConfig:
    """GAR-1B: PE-Core-L/14@448 + Llama-3.2-1B-shaped decoder."""
    return GARConfig(
        vision=VisionConfig(width=1024, depth=23, num_heads=16, mlp_ratio=4.0,
                            fast_gelu=True),
        text=TextConfig(
            vocab_size=BASE_VOCAB_SIZE,
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
            tie_word_embeddings=True,
            rope_scaling_factor=32.0,
        ),
        max_num_tiles=16,
    )


def gar_8b() -> GARConfig:
    """GAR-8B: PE-Core-G/14@448 + Llama-3.1-8B-shaped decoder."""
    return GARConfig(
        vision=VisionConfig(
            width=1536, depth=47, num_heads=16, mlp_ratio=5.833333333333333,
            fast_gelu=True,
        ),
        text=TextConfig(
            vocab_size=BASE_VOCAB_SIZE,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            tie_word_embeddings=False,
            rope_scaling_factor=8.0,
        ),
        max_num_tiles=8,
    )


def gar_tiny() -> GARConfig:
    """Tiny config for tests."""
    return GARConfig(
        vision=VisionConfig(
            width=64,
            depth=2,
            num_heads=4,
            mlp_ratio=2.0,
            patch_size=14,
            img_size=(448, 448),
            ref_feat_shape=(32, 32),
        ),
        text=TextConfig(
            vocab_size=BASE_VOCAB_SIZE,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            tie_word_embeddings=True,
            rope_scaling_factor=None,
        ),
        max_num_tiles=4,
    )


PRESETS = {"gar_1b": gar_1b, "gar_8b": gar_8b, "gar_tiny": gar_tiny}


# ---------------------------------------------------------------------------
# dict / JSON round trip and dotted overrides
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = hints[k]
        if f.name == "vision":
            v = _from_dict(VisionConfig, v)
        elif f.name == "text":
            v = _from_dict(TextConfig, v)
        elif isinstance(v, list) and f.type and "Tuple" in str(f.type):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def gar_config_from_dict(d: dict) -> GARConfig:
    return _from_dict(GARConfig, d)


def save_config(cfg: GARConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(path: str) -> GARConfig:
    with open(path) as f:
        return gar_config_from_dict(json.load(f))


def apply_overrides(cfg: GARConfig, overrides: dict[str, Any]) -> GARConfig:
    """Apply dotted-key overrides, e.g. {"text.num_layers": 4}."""
    d = to_dict(cfg)
    for key, value in overrides.items():
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown override key: {key}")
        node[parts[-1]] = value
    return gar_config_from_dict(d)


def from_hf_config(hf: dict) -> GARConfig:
    """Map an HF Perception-LM / GAR `config.json` dict onto GARConfig: the
    bare PLM layout (vision_config / text_config at the top level) or the
    GAR export layout (nested under "mllm_config")."""
    if "mllm_config" in hf:
        prompt_numbers = hf.get("prompt_numbers", 5)
        hf = hf["mllm_config"]
    else:
        prompt_numbers = 5
    vc = hf.get("vision_config", {})
    margs = vc.get("model_args", {}) or {}
    tc = hf.get("text_config", {})

    img_size = tuple(margs.get("img_size", (448, 448)))
    ref_feat = tuple(margs.get("ref_feat_shape", (32, 32)))
    width = margs.get("embed_dim", vc.get("num_features", 1024))
    vision = VisionConfig(
        width=width,
        depth=margs.get("depth", 23),
        num_heads=margs.get("num_heads", 16),
        mlp_ratio=margs.get("mlp_ratio", 4.0),
        patch_size=margs.get("patch_size", 14),
        img_size=img_size,
        ref_feat_shape=ref_feat,
        class_token=margs.get("class_token", True),
        use_rope=margs.get("use_rot_pos_emb", True),
        rope_mixed=margs.get("rope_mixed", True),
        rope_temperature=margs.get("rope_temperature", 100.0),
        init_values=margs.get("init_values", 0.1),
    )
    rs = tc.get("rope_scaling") or {}
    text = TextConfig(
        vocab_size=tc.get("vocab_size", BASE_VOCAB_SIZE),
        hidden_size=tc.get("hidden_size", 2048),
        intermediate_size=tc.get("intermediate_size", 8192),
        num_layers=tc.get("num_hidden_layers", 16),
        num_heads=tc.get("num_attention_heads", 32),
        num_kv_heads=tc.get("num_key_value_heads", 8),
        head_dim=tc.get("head_dim", tc.get("hidden_size", 2048) // tc.get("num_attention_heads", 32)),
        rope_theta=tc.get("rope_theta", 500000.0),
        rms_norm_eps=tc.get("rms_norm_eps", 1e-5),
        max_position_embeddings=tc.get("max_position_embeddings", 131072),
        tie_word_embeddings=tc.get("tie_word_embeddings", True),
        rope_scaling_factor=rs.get("factor"),
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_position=rs.get("original_max_position_embeddings", 8192),
    )
    return GARConfig(
        vision=vision,
        text=text,
        projector_pooling_ratio=hf.get("projector_pooling_ratio", 2),
        vision_use_cls_token=hf.get("vision_use_cls_token", True),
        image_token_id=hf.get("image_token_id", IMAGE_TOKEN_ID),
        video_token_id=hf.get("video_token_id", VIDEO_TOKEN_ID),
        prompt_numbers=prompt_numbers,
    )
