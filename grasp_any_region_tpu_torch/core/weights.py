"""Parameters: the JAX tree's names and layouts as `nn.Module`s, the loader
from its flattened numpy form, and a seeded random init.

The JAX package flattens its parameter tree to numpy with
`core/weights.flatten_params`, under '/'-joined names such as
`llm/blocks/wq`. The port's modules hold the same tensors under the same
names ('.'-joined) and layouts: (Din, Dout) kernels used as x @ W, blocks
stacked on a leading L axis, the channel-major patch kernel. So loading is
a name-for-name copy.

The int8 trees of `grasp_any_region_tpu/models/quantize.py` load the same
way: their `*_q8` leaves are int8 and their `*_scale` leaves fp32 whatever
the working dtype, held as `nn.Parameter(..., requires_grad=False)` like
every other leaf (so `named_parameters`, `.to(device)` and the loader's
name check treat them alike).

The entry points that make the port's tensors (`load_flat_params`,
`init_gar_params`, and `data/synthetic.synthetic_batch`,
`models/quantize.init_gar_serving_int8`) build on the card unless the
caller asks for the CPU, and raise where there is no card.

Training (`train/step.init_state`) turns on `requires_grad` for every
float leaf, as `jax.value_and_grad` differentiates the whole tree; the
optimizer's mask decides which leaves move. `flat_grads` gives the
gradients back under the flat JAX names.

Checkpoints keep the JAX package's native layout (`core/weights.py`
there): `config.json` holding {"gar_tpu_config": the config dict} and
`model.safetensors` keyed by the '/'-joined names, bf16 leaves stored as
fp32, so either package reads the other's files. HF-exported GAR and
Perception-LM checkpoints convert onto the same names
(`convert_hf_state_dict`). The safetensors format is read and written here
with numpy (`read_safetensors`, `write_safetensors`), so checkpoints need
no package beyond numpy.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import GARConfig, from_hf_config, gar_config_from_dict, to_dict


def require_device(device) -> torch.device:
    """The device an entry point builds on. A CUDA device without a card
    raises: the port never moves to the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for (the default) but torch.cuda.is_available() "
                           "is false; pass device='cpu' to build on the CPU")
    return dev


def add_param(module: nn.Module, name: str, shape, device=None, dtype=None) -> None:
    """Register an uninitialised, non-trainable tensor on `module` (an int8
    one too: a Parameter that needs no gradient may hold any dtype)."""
    module.register_parameter(
        name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                           requires_grad=False))


class ParamGroup(nn.Module):
    """The tensors of one node of the JAX parameter tree."""

    def __init__(self, shapes: Mapping[str, tuple], device=None, dtype=None):
        super().__init__()
        for name, shape in shapes.items():
            add_param(self, name, shape, device, dtype)

    def layer(self, i: int) -> dict:
        """Views of layer i of tensors stacked on a leading L axis."""
        return {name: p[i] for name, p in self.named_parameters()}

    def layers(self) -> list:
        """Every layer's views, from one `unbind` per stacked tensor. Under
        autograd the backward of each is one `stack` of the layers'
        gradients, where L calls of `layer(i)` would each add a zero-filled
        (L, ...) gradient."""
        names, tensors = zip(*self.named_parameters())
        return [dict(zip(names, views)) for views in zip(*(p.unbind(0) for p in tensors))]


def _int8_layout(flat: Mapping[str, np.ndarray], cfg: GARConfig) -> dict:
    """The `GARParams` int8 arguments a flat tree's names call for: `q8`,
    the decoder matmuls with `*_q8` leaves (None for a tree without the
    int8 head, i.e. not quantized), and `drop_bf16`, whether the bf16
    head (the tied embedding or `lm_head`) was dropped."""
    from ..models.llama import DECODE_MATMULS

    if "llm/lm_head_q8" not in flat:
        return dict(q8=None, drop_bf16=False)
    head = "llm/embed" if cfg.text.tie_word_embeddings else "llm/lm_head"
    return dict(q8=tuple(n for n in DECODE_MATMULS if f"llm/blocks/{n}_q8" in flat),
                drop_bf16=head not in flat)


def _lora_layout(flat: Mapping[str, np.ndarray]):
    """The `GARParams` lora argument a flat tree's names call for: None, or
    (targets, rank) read from its `llm/blocks/{target}_lora_a` leaves (JAX
    `train/lora.add_lora_params`)."""
    from ..models.llama import DECODE_MATMULS

    targets = tuple(n for n in DECODE_MATMULS if f"llm/blocks/{n}_lora_a" in flat)
    if not targets:
        return None
    return targets, int(np.shape(flat[f"llm/blocks/{targets[0]}_lora_a"])[-1])


def load_flat_params(flat: Mapping[str, np.ndarray], cfg: GARConfig,
                     device="cuda", dtype=torch.float32):
    """Build `GARParams` from a flat {'a/b/c': array} dict, bf16 or int8
    (`_int8_layout` reads which from the names), with or without LoRA
    adapters (`_lora_layout`).

    Raises KeyError on a missing or unused name, ValueError on a shape
    mismatch and TypeError on a float array for an int8 leaf. The learned
    rope frequencies, the int8 scales, the adapters and `llm/lora_scaling`
    stay fp32 and the `*_q8` leaves int8, as in the JAX tree.
    """
    from ..models.gar import GARParams

    params = GARParams(cfg, device=require_device(device), dtype=dtype,
                       **_int8_layout(flat, cfg), lora=_lora_layout(flat))
    expected = {name.replace(".", "/"): p for name, p in params.named_parameters()}
    missing = sorted(set(expected) - set(flat))
    unused = sorted(set(flat) - set(expected))
    if missing or unused:
        raise KeyError(f"parameter names differ: missing {missing}, unused {unused}")
    for key, p in expected.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected {tuple(p.shape)}")
        if p.dtype == torch.int8:
            if arr.dtype != np.int8:
                raise TypeError(f"{key}: an int8 leaf, got {arr.dtype}")
            arr = arr.copy()  # writable, as torch.from_numpy wants
        else:
            arr = arr.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.from_numpy(arr))
    return params


def flat_grads(params: nn.Module) -> dict:
    """{'a/b/c': fp32 numpy gradient} for every float leaf, under the names
    of the JAX package's `flatten_params`; a leaf with no gradient (unused by
    the loss) gives zeros, as `jax.grad` does."""
    out = {}
    for name, p in params.named_parameters():
        if p.dtype.is_floating_point:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[name.replace(".", "/")] = g.detach().float().cpu().numpy()
    return out


_ONES = {"scale", "ln1_scale", "ln2_scale", "attn_norm", "mlp_norm", "final_norm"}
_ZEROS = {"bias", "ln1_bias", "ln2_bias", "bqkv", "bo", "b1", "b2"}


def _mixed_rope_freqs(cfg, generator, device) -> torch.Tensor:
    """(depth, heads, d/2, 2): base magnitudes theta^(-4t/d), each head given
    a random planar rotation so the x and y axes mix."""
    d = cfg.head_dim
    t = torch.arange(0, d // 4, dtype=torch.float32, device=device)
    mag = 1.0 / (cfg.rope_temperature ** (t * 4.0 / d))
    ang = torch.empty((cfg.depth, cfg.num_heads, 1), device=device)
    ang.uniform_(0.0, 2 * math.pi, generator=generator)
    fx = torch.cat([mag * torch.cos(ang), mag * torch.cos(ang + math.pi / 2)], dim=-1)
    fy = torch.cat([mag * torch.sin(ang), mag * torch.sin(ang + math.pi / 2)], dim=-1)
    return torch.stack([fx, fy], dim=-1)


def init_leaf(name: str, p: torch.Tensor, cfg: GARConfig, generator: torch.Generator) -> None:
    """Fill one bf16/fp32 leaf of `GARParams` (dotted name) by the JAX
    package's init rules."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "mask_embed.kernel" or leaf in _ZEROS:
        p.zero_()
    elif leaf in _ONES:
        p.fill_(1.0)
    elif leaf in ("ls1", "ls2"):
        p.fill_(cfg.vision.init_values)
    elif leaf == "rope_freqs":
        p.copy_(_mixed_rope_freqs(cfg.vision, generator, p.device))
    else:
        w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
        p.copy_(w)


@torch.no_grad()
def init_gar_params(cfg: GARConfig, generator: torch.Generator, device="cuda",
                    dtype=torch.float32):
    """Random `GARParams` by the JAX package's init rules: truncated normal
    (std 0.02, cut at 2 std) for kernels and embeddings, ones for norm
    scales, zeros for biases, LayerScale at `init_values`, zero `mask_embed`.
    The numbers differ from jax.random's; tests load JAX params instead."""
    from ..models.gar import GARParams

    params = GARParams(cfg, device=require_device(device), dtype=dtype)
    for name, p in params.named_parameters():
        init_leaf(name, p, cfg, generator)
    return params


# ---------------------------------------------------------------------------
# the safetensors format: an 8-byte little-endian header length, a JSON
# header {name: {dtype, shape, data_offsets}}, then the raw little-endian
# bytes, each tensor at its offsets from the end of the header
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def _st_array(x) -> Tuple[str, np.ndarray]:
    """(safetensors dtype name, little-endian numpy array of the stored
    bytes) of a numpy array or a torch tensor; a bf16 tensor is stored as
    BF16, its bits as uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "BF16", x.contiguous().view(torch.int16).numpy().view("<u2")
        x = x.numpy()
    a = np.asarray(x)
    le = a.dtype.newbyteorder("<")
    if le not in _ST_NAMES:
        raise TypeError(f"dtype {a.dtype} has no safetensors name here")
    return _ST_NAMES[le], a.astype(le, copy=False)


def write_safetensors(tensors: Mapping[str, object], path: str) -> int:
    """Write {name: numpy array or torch tensor} as one safetensors file,
    names in sorted order; returns the bytes written. A bf16 tensor is
    written as BF16 (numpy has no bf16: store a numpy bf16 array as fp32,
    as save_checkpoint does). Raises TypeError for a dtype the reader here
    would not give back."""
    header, arrays, offset = {}, [], 0
    for name in sorted(tensors):
        try:
            dt, a = _st_array(tensors[name])
        except TypeError as e:
            raise TypeError(f"{name}: {e}") from None
        header[name] = {"dtype": dt, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in arrays:
            f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)
    return 8 + len(raw) + offset


def _st_entries(path: str):
    """(name, dtype name, numpy array of the stored elements) of each tensor
    of one safetensors file, read straight from its offsets (BF16 as uint16
    bits)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            shape, dt = tuple(meta["shape"]), meta["dtype"]
            if dt != "BF16" and dt not in _ST_DTYPES:
                raise TypeError(f"{path}: tensor {name} has dtype {dt}, which is not read here")
            raw = np.dtype("<u2" if dt == "BF16" else _ST_DTYPES[dt])
            f.seek(8 + n + begin)
            a = np.fromfile(f, raw, (end - begin) // raw.itemsize)
            yield name, dt, a.astype(a.dtype.newbyteorder("="), copy=False).reshape(shape)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of one safetensors file. BF16 tensors widen to fp32
    (exactly: a bf16 value is the high half of its fp32 bits)."""
    out = {}
    for name, dt, a in _st_entries(path):
        out[name] = (a.astype(np.uint32) << 16).view(np.float32) if dt == "BF16" else a
    return out


def read_safetensors_torch(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one safetensors file, each in its stored dtype
    (BF16 as torch.bfloat16, bit for bit)."""
    out = {}
    for name, dt, a in _st_entries(path):
        t = torch.from_numpy(np.array(a))  # writable, as torch.from_numpy wants
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


# ---------------------------------------------------------------------------
# the native checkpoint
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A leaf as a numpy array: torch tensors leave the device, bf16 widens
    to fp32 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a/b/c': numpy array} of a `GARParams` (its parameter names,
    '.' -> '/') or of a nested dict of arrays (the JAX tree's form); None
    leaves are dropped, as in JAX."""
    if isinstance(params, nn.Module):
        return {prefix + name.replace(".", "/"): _host(p) for name, p in params.named_parameters()}
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            if v is not None:
                out.update(flatten_params(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = _host(params)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_checkpoint(path: str, cfg: GARConfig, params) -> None:
    """Write `path/config.json` and `path/model.safetensors` (JAX
    `save_checkpoint`'s layout: float leaves fp32, int8 leaves int8)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"gar_tpu_config": to_dict(cfg)}, f, indent=2)
    write_safetensors(flatten_params(params), os.path.join(path, "model.safetensors"))


def read_checkpoint(path: str) -> Tuple[GARConfig, Dict[str, np.ndarray]]:
    """(config, flat numpy tree) of a checkpoint directory, native or
    HF-exported (converted onto the native names), on the host."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    tensors: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            tensors.update(read_safetensors(os.path.join(path, name)))
    if "gar_tpu_config" in raw:
        return gar_config_from_dict(raw["gar_tpu_config"]), tensors
    cfg = from_hf_config(raw)
    return cfg, flatten_params(convert_hf_state_dict(cfg, tensors))


def load_checkpoint(path: str, device="cuda", dtype=torch.float32):
    """(config, `GARParams`) of a checkpoint directory (`read_checkpoint`,
    then `load_flat_params` on `device`: the card unless the caller asks
    for the CPU)."""
    device = require_device(device)
    cfg, flat = read_checkpoint(path)
    return cfg, load_flat_params(flat, cfg, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# HF / torch names -> native (JAX `core/weights.py`): torch Linear stores
# (out, in), the native matmuls (in, out); per-layer tensors stack on a
# leading L axis; the ViT patch conv (D, C, p, p) flattens channel-major to
# (C*p*p, D); embedding rows pad up to cfg.padded_vocab_size
# ---------------------------------------------------------------------------

def _strip_prefixes(name: str) -> str:
    """Drop the wrapper prefixes of the GAR export, PLM and train-time
    state dicts."""
    for p in ("mllm.model.", "mllm.", "model.model.", "model."):
        if name.startswith(p):
            name = name[len(p):]
    return name


def _taker(t: Mapping[str, np.ndarray]):
    def take(name: str, transpose: bool = False) -> Optional[np.ndarray]:
        if name not in t:
            return None
        x = np.asarray(t[name])
        return x.T if transpose else x

    def stack(fmt: str, n: int, transpose: bool = False) -> Optional[np.ndarray]:
        xs = []
        for i in range(n):
            x = take(fmt.format(i), transpose)
            if x is None:
                return None
            xs.append(x)
        return np.stack(xs)

    return take, stack


def convert_hf_llama(text_cfg, tensors: Mapping[str, np.ndarray],
                     vocab_rows: Optional[int] = None,
                     already_stripped: bool = False) -> Optional[dict]:
    """An HF Llama(-3) decoder state dict (bare `LlamaForCausalLM` names, or
    `language_model.`-prefixed inside a GAR / PLM export) as the native
    `llm` tree; None when it holds no decoder weights."""
    L = text_cfg.num_layers
    t = tensors if already_stripped else {_strip_prefixes(k): v for k, v in tensors.items()}
    take, stack = _taker(t)

    lm = None
    for prefix in ("language_model.", "language_model.model.", ""):
        if take(prefix + "embed_tokens.weight") is not None:
            lm = prefix
            break
    if lm is None:
        return None
    embed = take(lm + "embed_tokens.weight")
    rows = vocab_rows or embed.shape[0]
    if embed.shape[0] < rows:
        embed = np.concatenate(
            [embed, np.zeros((rows - embed.shape[0], embed.shape[1]), embed.dtype)])
    llm = {
        "embed": embed,
        "blocks": {
            "attn_norm": stack(lm + "layers.{}.input_layernorm.weight", L),
            "wq": stack(lm + "layers.{}.self_attn.q_proj.weight", L, transpose=True),
            "wk": stack(lm + "layers.{}.self_attn.k_proj.weight", L, transpose=True),
            "wv": stack(lm + "layers.{}.self_attn.v_proj.weight", L, transpose=True),
            "wo": stack(lm + "layers.{}.self_attn.o_proj.weight", L, transpose=True),
            "mlp_norm": stack(lm + "layers.{}.post_attention_layernorm.weight", L),
            "w_gate": stack(lm + "layers.{}.mlp.gate_proj.weight", L, transpose=True),
            "w_up": stack(lm + "layers.{}.mlp.up_proj.weight", L, transpose=True),
            "w_down": stack(lm + "layers.{}.mlp.down_proj.weight", L, transpose=True),
        },
        "final_norm": take(lm + "norm.weight"),
    }
    head = take("lm_head.weight")
    if head is None:
        head = take("language_model.lm_head.weight")
    if head is not None and not text_cfg.tie_word_embeddings:
        h = head.T  # (D, V)
        if h.shape[1] < rows:
            h = np.concatenate([h, np.zeros((h.shape[0], rows - h.shape[1]), h.dtype)], axis=1)
        llm["lm_head"] = h
    return llm


def convert_hf_state_dict(cfg: GARConfig, tensors: Mapping[str, np.ndarray]) -> dict:
    """An HF-exported GAR (or Perception-LM) state dict as the native nested
    tree. Raises ValueError when the tower, projector or decoder is missing;
    a missing mask embed is zero, as at init."""
    VL = cfg.vision.depth
    t = {_strip_prefixes(k): v for k, v in tensors.items()}
    take, stack = _taker(t)
    params: dict = {}

    vt = "vision_tower.timm_model."
    pe = take(vt + "patch_embed.proj.weight")
    if pe is not None:
        d = pe.shape[0]
        vision = {
            "patch_embed": {
                "kernel": pe.reshape(d, -1).T,  # (C*p*p, D) channel-major
                "bias": take(vt + "patch_embed.proj.bias"),
            },
            "blocks": {
                "ln1_scale": stack(vt + "blocks.{}.norm1.weight", VL),
                "ln1_bias": stack(vt + "blocks.{}.norm1.bias", VL),
                "wqkv": stack(vt + "blocks.{}.attn.qkv.weight", VL, transpose=True),
                "bqkv": stack(vt + "blocks.{}.attn.qkv.bias", VL),
                "wo": stack(vt + "blocks.{}.attn.proj.weight", VL, transpose=True),
                "bo": stack(vt + "blocks.{}.attn.proj.bias", VL),
                "ln2_scale": stack(vt + "blocks.{}.norm2.weight", VL),
                "ln2_bias": stack(vt + "blocks.{}.norm2.bias", VL),
                "fc1": stack(vt + "blocks.{}.mlp.fc1.weight", VL, transpose=True),
                "b1": stack(vt + "blocks.{}.mlp.fc1.bias", VL),
                "fc2": stack(vt + "blocks.{}.mlp.fc2.weight", VL, transpose=True),
                "b2": stack(vt + "blocks.{}.mlp.fc2.bias", VL),
            },
        }
        ls1 = stack(vt + "blocks.{}.ls1.gamma", VL)
        if ls1 is not None:
            vision["blocks"]["ls1"] = ls1
            vision["blocks"]["ls2"] = stack(vt + "blocks.{}.ls2.gamma", VL)
        cls = take(vt + "cls_token")
        if cls is not None:
            vision["cls_token"] = cls.reshape(1, 1, -1)
        pos = take(vt + "pos_embed")
        if pos is not None:
            vision["pos_embed"] = pos.reshape(pos.shape[-2], pos.shape[-1])
        npre = take(vt + "norm_pre.weight")
        if npre is not None:
            vision["ln_pre"] = {"scale": npre, "bias": take(vt + "norm_pre.bias")}
        npost = take(vt + "norm.weight")
        if npost is not None:
            vision["ln_post"] = {"scale": npost, "bias": take(vt + "norm.bias")}
        rope = take(vt + "rope.freqs")
        if rope is not None:  # timm's mixed rope: (depth, heads, head_dim / 2, 2)
            vision["rope_freqs"] = rope.reshape(VL, cfg.vision.num_heads,
                                                cfg.vision.head_dim // 2, 2)
        params["vision"] = vision

    fc1 = take("multi_modal_projector.linear_1.weight", transpose=True)
    if fc1 is not None:
        params["projector"] = {
            "fc1": fc1,
            "b1": take("multi_modal_projector.linear_1.bias"),
            "fc2": take("multi_modal_projector.linear_2.weight", transpose=True),
            "b2": take("multi_modal_projector.linear_2.bias"),
        }

    llm = convert_hf_llama(cfg.text, t, vocab_rows=cfg.padded_vocab_size, already_stripped=True)
    if llm is not None:
        params["llm"] = llm

    mpe = take("mask_patch_embedding.weight")
    if mpe is None:
        mpe = take("mask_conv.weight")
    if mpe is not None:
        params["mask_embed"] = {"kernel": mpe.reshape(mpe.shape[0], -1).T}

    missing = [k for k in ("vision", "projector", "llm") if k not in params]
    if missing:
        raise ValueError(f"HF checkpoint missing components {missing}; found keys like "
                         f"{list(t)[:8]}")
    if "mask_embed" not in params:
        kh, kw = cfg.mask_patch_kernel
        params["mask_embed"] = {
            "kernel": np.zeros((kh * kw * cfg.mask_in_channels, cfg.vision.width), np.float32)}
    return params
