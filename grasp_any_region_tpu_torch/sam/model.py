"""Segment-Anything (SAM) on torch tensors (`grasp_any_region_tpu/sam/model.py`):
a click or a box -> the mask that GAR captions.

The three SAM stages, from the published architecture, as the JAX package
writes them:

  * ImageEncoderViT: a 1024² / 16 ViT with windowed attention (window 14)
    and decomposed relative position biases, global attention at a few
    blocks, a 1x1 + 3x3 conv neck to 256-d embeddings (64 x 64);
  * PromptEncoder: random-Fourier encoding of points and box corners and
    learned type embeddings;
  * MaskDecoder: the two-way transformer (tokens <-> image), the IoU head,
    the hypernetwork mask heads and 4x upscaling.

The parameters keep JAX's tree (`encoder` / `prompt` / `decoder`, matmul
(Din, Dout) kernels, the same leaf names) as a `ParamTree` of `nn.Module`s,
read by key as JAX reads its dicts, so JAX's numpy tree carries over leaf
for leaf (`sam/weights.sam_params_from_numpy`).

Precision: every product is an fp32 matmul, as in JAX. The convs are
matmuls too: the neck's 3x3 conv is nine shifted products, and each 2x2,
stride-2 transposed conv of the decoder one product (its taps never
overlap). So on the card everything goes through cuBLAS at torch's fp32
matmul precision ("highest", no TF32, unless the caller has changed
`torch.backends.cuda.matmul.allow_tf32`); cuDNN's TF32 default for convs
never applies. JAX has no Pallas kernel here (XLA einsums and convs), and
neither has the port: SAM launches no kernel of `ops/`. LayerNorm is the
plain `ops/norms.layer_norm`, as JAX calls its XLA form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.weights import require_device
from ..ops.norms import layer_norm


@dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768  # vit-b (vit-l: 1024, vit-h: 1280)
    depth: int = 12  # vit-l: 24, vit-h: 32
    num_heads: int = 12  # vit-l/h: 16
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    # vit-l: (5, 11, 17, 23); vit-h: (7, 15, 23, 31)
    out_chans: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size  # 64


def sam_vit_b() -> SAMConfig:
    return SAMConfig()


def sam_vit_l() -> SAMConfig:
    return SAMConfig(embed_dim=1024, depth=24, num_heads=16,
                     global_attn_indexes=(5, 11, 17, 23))


def sam_vit_h() -> SAMConfig:
    return SAMConfig(embed_dim=1280, depth=32, num_heads=16,
                     global_attn_indexes=(7, 15, 23, 31))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A node of JAX's SAM parameter tree: a dict's keys become attributes
    (leaves as parameters that need no gradient, dicts as child trees,
    lists as `nn.ModuleList`s), and `node[key]` reads them, so the
    functions below index the tree as JAX indexes its dicts. Parameter
    names are JAX's paths with '.' (`encoder.blocks.0.wqkv`)."""

    def __init__(self, tree: Mapping, device=None, dtype=None):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value, device, dtype))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v, device, dtype) for v in value))
            else:
                leaf = value if isinstance(value, torch.Tensor) else \
                    torch.from_numpy(np.array(value))
                self.register_parameter(key, nn.Parameter(
                    leaf.to(device=device, dtype=dtype), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _param_shapes(cfg: SAMConfig) -> dict:
    """JAX `init_sam_params`' tree of (shape, init) leaves: init is the
    normal's std, or "ones" / "zeros"."""
    d, g, c = cfg.embed_dim, cfg.grid, cfg.out_chans
    dh = d // cfg.num_heads

    def ln(n):
        return {"scale": ((n,), "ones"), "bias": ((n,), "zeros")}

    def block(window: bool):
        size = cfg.window_size if window else g
        return {
            "ln1": ln(d),
            "wqkv": ((d, 3 * d), 0.02), "bqkv": ((3 * d,), "zeros"),
            "wo": ((d, d), 0.02), "bo": ((d,), "zeros"),
            "rel_h": ((2 * size - 1, dh), 0.02), "rel_w": ((2 * size - 1, dh), 0.02),
            "ln2": ln(d),
            "fc1": ((d, 4 * d), 0.02), "b1": ((4 * d,), "zeros"),
            "fc2": ((4 * d, d), 0.02), "b2": ((d,), "zeros"),
        }

    enc = {
        "patch_embed": {"kernel": ((cfg.patch_size * cfg.patch_size * 3, d), 0.02),
                        "bias": ((d,), "zeros")},
        "pos_embed": ((g, g, d), 0.02),
        "blocks": [block(i not in cfg.global_attn_indexes) for i in range(cfg.depth)],
        "neck": {"conv1": ((d, c), 0.02), "ln1": ln(c),
                 "conv2": ((3 * 3 * c, c), 0.02), "ln2": ln(c)},
    }
    pe = {"pe_gaussian": ((2, c // 2), 1.0), "point_embeds": ((4, c), 0.02),
          "not_a_point": ((1, c), 0.02), "no_mask": ((1, c), 0.02)}

    def attn():
        return {f"{w}{k}": ((c, c), 0.02) if w == "w" else ((c,), "zeros")
                for k in ("q", "k", "v", "o") for w in ("w", "b")}

    def twoway_block():
        return {
            "self_attn": attn(), "ln1": ln(c), "cross_t2i": attn(), "ln2": ln(c),
            "mlp_fc1": ((c, cfg.decoder_mlp_dim), 0.02),
            "mlp_b1": ((cfg.decoder_mlp_dim,), "zeros"),
            "mlp_fc2": ((cfg.decoder_mlp_dim, c), 0.02), "mlp_b2": ((c,), "zeros"),
            "ln3": ln(c), "cross_i2t": attn(), "ln4": ln(c),
        }

    def mlp3(n_out):
        return {"fc1": ((c, c), 0.02), "b1": ((c,), "zeros"), "fc2": ((c, c), 0.02),
                "b2": ((c,), "zeros"), "fc3": ((c, n_out), 0.02), "b3": ((n_out,), "zeros")}

    nm = cfg.num_multimask_outputs + 1
    dec = {
        "iou_token": ((1, c), 0.02), "mask_tokens": ((nm, c), 0.02),
        "blocks": [twoway_block() for _ in range(cfg.decoder_depth)],
        "final_t2i": attn(), "ln_final": ln(c),
        "upscale1": ((c, c // 4, 2, 2), 0.02),  # conv-transpose 2x
        "up_ln": ln(c // 4),
        "upscale2": ((c // 4, c // 8, 2, 2), 0.02),
        "hyper_mlps": [mlp3(c // 8) for _ in range(nm)],
        "iou_mlp": mlp3(nm),
    }
    return {"encoder": enc, "prompt": pe, "decoder": dec}


def init_sam_params(cfg: SAMConfig, generator: torch.Generator, device="cuda",
                    dtype=torch.float32) -> ParamTree:
    """Seeded random SAM weights in JAX's tree and initial values (normals
    of std 0.02, the Fourier table's of std 1, LayerNorms at 1 / 0, biases
    0), drawn in fp32 from `generator` and cast to `dtype`, on `device`:
    the card unless the caller asks for the CPU."""
    device = require_device(device)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        shape, init = node
        if init == "ones":
            return torch.ones(shape, device=device, dtype=dtype)
        if init == "zeros":
            return torch.zeros(shape, device=device, dtype=dtype)
        return (torch.randn(shape, generator=generator, device=device) * init).to(dtype)

    return ParamTree(draw(_param_shapes(cfg)), device, dtype)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def _rel_pos_bias(rel: torch.Tensor, size: int) -> torch.Tensor:
    """(2*size-1, dh) table -> (size, size, dh) per (q, k) offset."""
    q = torch.arange(size, device=rel.device)[:, None]
    k = torch.arange(size, device=rel.device)[None, :]
    return rel[q - k + (size - 1)]


def _windowed_attn(x: torch.Tensor, bp, heads: int) -> torch.Tensor:
    """x: (B, H, W, D), already window-partitioned to (B*nw, ws, ws, D)
    for a windowed block. Logits in fp32 plus the decomposed relative
    position bias (SAM's add_decomposed_rel_pos): (B, heads, H*W, H*W)
    each, 1 GiB apiece in a global ViT-H block."""
    b, hh, ww, d = x.shape
    dh = d // heads
    qkv = x.reshape(b, hh * ww, d) @ bp["wqkv"] + bp["bqkv"]
    qkv = qkv.reshape(b, hh * ww, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, dh)
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * dh ** -0.5).float(), k.float())
    rh = _rel_pos_bias(bp["rel_h"], hh)  # (hh, hh, dh)
    rw = _rel_pos_bias(bp["rel_w"], ww)
    qr = q.reshape(b, heads, hh, ww, dh)
    bias_h = torch.einsum("bhywd,ykd->bhywk", qr, rh.to(qr.dtype))  # (B, hd, hh, ww, hh)
    bias_w = torch.einsum("bhywd,wkd->bhywk", qr, rw.to(qr.dtype))  # (B, hd, hh, ww, ww)
    bias = bias_h[..., :, None] + bias_w[..., None, :]  # (B, hd, hh, ww, hh, ww)
    logits += bias.reshape(b, heads, hh * ww, hh * ww)
    del bias
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    out = out.permute(0, 2, 1, 3).reshape(b, hh * ww, d)
    out = out @ bp["wo"] + bp["bo"]
    return out.reshape(b, hh, ww, d)


def _window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, D) -> (B * windows, ws, ws, D), zero-padded bottom and
    right to multiples of ws (64 -> 70 at ws = 14); returns the padded size."""
    b, h, w, d = x.shape
    ph = (ws - h % ws) % ws
    pw = (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, d)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, d)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, ws: int, padded, orig):
    hp, wp = padded
    h, w = orig
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def encoder_block(bp, cfg: SAMConfig, x: torch.Tensor, global_attn: bool) -> torch.Tensor:
    """One ViT block of `encode_image`, x (B, g, g, D)."""
    g = x.shape[1]
    shortcut = x
    y = layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"])
    if global_attn:
        y = _windowed_attn(y, bp, cfg.num_heads)
    else:
        yw, padded = _window_partition(y, cfg.window_size)
        yw = _windowed_attn(yw, bp, cfg.num_heads)
        y = _window_unpartition(yw, cfg.window_size, padded, (g, x.shape[2]))
    x = shortcut + y
    y = layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"])
    y = F.gelu(y @ bp["fc1"] + bp["b1"], approximate="none")
    return x + (y @ bp["fc2"] + bp["b2"])


def _conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 cross-correlation, stride 1, zero padding 1 (JAX's
    `conv_general_dilated(..., "SAME")` with an HWIO kernel w (3, 3, C,
    O)): nine products of shifted views, fp32 matmuls on the card."""
    _, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + h, dx:dx + wd] @ w[dy, dx]
            out = term if out is None else out + term
    return out


def _conv_transpose2x2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC transposed conv, stride 2, kernel 2, "VALID", as JAX's
    `lax.conv_transpose` applies the (Cin, Cout, 2, 2) kernel w (HWIO after
    its transpose(2, 3, 0, 1), no transpose_kernel): spatially flipped
    against torch's conv_transpose2d, out[2i + a, 2j + b] = x[i, j] @
    w[:, :, 1 - a, 1 - b]. The taps never overlap, so it is one product
    of x with the (Cin, 2 * 2 * Cout) kernel."""
    b, h, wd, _ = x.shape
    cout = w.shape[1]
    wk = torch.flip(w, dims=(2, 3)).permute(0, 2, 3, 1).reshape(w.shape[0], 4 * cout)
    y = (x @ wk).reshape(b, h, wd, 2, 2, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * wd, cout)


def encode_image(params, cfg: SAMConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, 3, 1024, 1024), SAM-normalized -> (B, 256, 64, 64)."""
    b = pixels.shape[0]
    p, g = cfg.patch_size, cfg.grid
    x = pixels.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g, g, 3 * p * p)
    enc = params["encoder"]
    x = x @ enc["patch_embed"]["kernel"] + enc["patch_embed"]["bias"]
    x = x + enc["pos_embed"]
    for i, bp in enumerate(enc["blocks"]):
        x = encoder_block(bp, cfg, x, i in cfg.global_attn_indexes)
    neck = enc["neck"]
    x = x @ neck["conv1"]
    x = layer_norm(x, neck["ln1"]["scale"], neck["ln1"]["bias"])
    x = _conv3x3_same(x, neck["conv2"].reshape(3, 3, x.shape[-1], -1))
    x = layer_norm(x, neck["ln2"]["scale"], neck["ln2"]["bias"])
    return x.permute(0, 3, 1, 2)  # (B, 256, 64, 64)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _fourier_pe(params, coords: torch.Tensor) -> torch.Tensor:
    """coords in [0,1]^2 (..., 2) -> (..., 256) random Fourier features."""
    x = (2.0 * coords - 1.0) @ params["prompt"]["pe_gaussian"]  # (..., 128)
    x = 2 * math.pi * x
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def encode_points(params, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """points (B, N, 2) in [0,1] image coords, labels (B, N): 1 fg, 0 bg,
    -1 pad, 2 / 3 box corners -> (B, N, 256)."""
    pe = _fourier_pe(params, points)
    pp = params["prompt"]
    lab = labels[..., None]
    emb = pe
    for i in range(4):
        emb = emb + torch.where(lab == i, pp["point_embeds"][i], 0.0)
    return torch.where(lab == -1, pp["not_a_point"][0] + torch.zeros_like(pe), emb)


def image_pe(params, cfg: SAMConfig) -> torch.Tensor:
    g = cfg.grid
    dev = params["prompt"]["pe_gaussian"].device
    ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    return _fourier_pe(params, torch.stack([xx, yy], -1))  # (g, g, 256)


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)
# ---------------------------------------------------------------------------

def _attn(ap, q, k, v, heads: int):
    b, nq, c = q.shape
    dh = c // heads
    qq = (q @ ap["wq"] + ap["bq"]).reshape(b, nq, heads, dh).permute(0, 2, 1, 3)
    kk = (k @ ap["wk"] + ap["bk"]).reshape(b, -1, heads, dh).permute(0, 2, 1, 3)
    vv = (v @ ap["wv"] + ap["bv"]).reshape(b, -1, heads, dh).permute(0, 2, 1, 3)
    # matmuls, not einsums: the ONNX export of the decoder (sam/onnx_export.py)
    # runs this function, and onnxruntime-web builds may lack Einsum
    logits = (qq * dh ** -0.5).float() @ kk.float().transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1)
    out = probs.to(vv.dtype) @ vv
    out = out.permute(0, 2, 1, 3).reshape(b, nq, c)
    return out @ ap["wo"] + ap["bo"]


def decode_masks(params, cfg: SAMConfig, image_embed: torch.Tensor,
                 sparse_prompt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embed (B, 256, 64, 64), sparse_prompt (B, N, 256) ->
    (masks (B, 4, 256, 256) logits, iou (B, 4))."""
    dec = params["decoder"]
    b = image_embed.shape[0]
    c, g, heads = cfg.out_chans, cfg.grid, cfg.decoder_heads

    tokens = torch.cat([dec["iou_token"], dec["mask_tokens"]], dim=0)
    nm = tokens.shape[0]
    tokens = torch.cat([tokens[None].expand(b, nm, c), sparse_prompt], dim=1)  # (B, nm+N, C)

    src = image_embed.reshape(b, c, g * g).permute(0, 2, 1)  # (B, g*g, C)
    src = src + params["prompt"]["no_mask"][0]  # dense prompt (no mask): no_mask everywhere
    pos = image_pe(params, cfg).reshape(1, g * g, c)

    q = tokens
    for bp in dec["blocks"]:
        q = q + _attn(bp["self_attn"], q, q, q, heads)
        q = layer_norm(q, bp["ln1"]["scale"], bp["ln1"]["bias"])
        q = q + _attn(bp["cross_t2i"], q, src + pos, src, heads)
        q = layer_norm(q, bp["ln2"]["scale"], bp["ln2"]["bias"])
        m = F.relu(q @ bp["mlp_fc1"] + bp["mlp_b1"])
        q = q + (m @ bp["mlp_fc2"] + bp["mlp_b2"])
        q = layer_norm(q, bp["ln3"]["scale"], bp["ln3"]["bias"])
        src = src + _attn(bp["cross_i2t"], src + pos, q, q, heads)
        src = layer_norm(src, bp["ln4"]["scale"], bp["ln4"]["bias"])

    q = q + _attn(dec["final_t2i"], q, src + pos, src, heads)
    q = layer_norm(q, dec["ln_final"]["scale"], dec["ln_final"]["bias"])

    iou_tok = q[:, 0]
    mask_toks = q[:, 1:1 + cfg.num_multimask_outputs + 1]  # (B, 4, C)

    # upscale the image features 4x: two stride-2 transposed convs, NHWC
    feat = src.reshape(b, g, g, c)
    feat = _conv_transpose2x2(feat, dec["upscale1"])
    feat = layer_norm(feat, dec["up_ln"]["scale"], dec["up_ln"]["bias"])
    feat = F.gelu(feat, approximate="none")
    feat = _conv_transpose2x2(feat, dec["upscale2"])
    feat = F.gelu(feat, approximate="none")  # (B, 4g, 4g, c//8)

    hyper = []
    for i, mp in enumerate(dec["hyper_mlps"]):
        t = mask_toks[:, i]
        t = F.relu(t @ mp["fc1"] + mp["b1"])
        t = F.relu(t @ mp["fc2"] + mp["b2"])
        hyper.append(t @ mp["fc3"] + mp["b3"])
    hyper = torch.stack(hyper, dim=1)  # (B, 4, c//8)
    h4 = feat.shape[1]
    masks = (hyper @ feat.reshape(b, h4 * h4, -1).transpose(-1, -2)).reshape(b, -1, h4, h4)

    im = dec["iou_mlp"]
    t = F.relu(iou_tok @ im["fc1"] + im["b1"])
    t = F.relu(t @ im["fc2"] + im["b2"])
    iou = t @ im["fc3"] + im["b3"]
    return masks, iou


def predict_mask(params, cfg: SAMConfig, pixels: torch.Tensor, points: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole pipeline on (1, 3, 1024, 1024) pixels and (1, N) prompts ->
    (best mask logits (1, 256, 256), best iou (1,)): the best of the
    multimask outputs by IoU, skipping index 0 (the single-mask output)."""
    emb = encode_image(params, cfg, pixels)
    sparse = encode_points(params, points, labels)
    masks, iou = decode_masks(params, cfg, emb, sparse)
    best = torch.argmax(iou[:, 1:], dim=-1) + 1
    bidx = torch.arange(masks.shape[0], device=masks.device)
    return masks[bidx, best], iou[bidx, best]
