"""Export: the port's parameters -> an HF-style safetensors checkpoint under
the reference's torch names (`grasp_any_region_tpu/train/export.py`).

The reverse of `core/weights.convert_hf_state_dict`: the same names,
layouts and `config.json` as JAX's export, so a checkpoint trained here
loads in the reference's HF stack and in either package. The file is
written by the port's own safetensors writer, every tensor fp32. The
transposes of a `GARParams` run on its device.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core.config import GARConfig, to_dict
from ..core.weights import flatten_params, unflatten_params, write_safetensors


def _fp32_tree(params) -> dict:
    """The nested tree of fp32 leaves: a `GARParams`' tensors stay on their
    device (the transposes below then run there, not in numpy), the JAX
    tree's arrays become numpy."""
    if isinstance(params, nn.Module):
        return unflatten_params({n.replace(".", "/"): p.detach().float()
                                 for n, p in params.named_parameters()})
    return unflatten_params({k: np.asarray(v, np.float32)
                             for k, v in flatten_params(params).items()})


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().cpu().numpy()
    return np.ascontiguousarray(x)


def export_hf_state_dict(cfg: GARConfig, params) -> Dict[str, np.ndarray]:
    """{HF name: fp32 numpy array} of a `GARParams` (on any device) or of a
    nested dict of arrays (the JAX tree's form)."""
    host = _fp32_tree(params)
    out: Dict[str, np.ndarray] = {}

    # vision
    v = host["vision"]
    vt = "mllm.model.vision_tower.timm_model."
    d = cfg.vision.width
    p = cfg.vision.patch_size
    out[vt + "patch_embed.proj.weight"] = (
        v["patch_embed"]["kernel"].T.reshape(d, 3, p, p)
    )
    out[vt + "patch_embed.proj.bias"] = v["patch_embed"]["bias"]
    if "cls_token" in v:
        out[vt + "cls_token"] = v["cls_token"]
    if "pos_embed" in v:
        out[vt + "pos_embed"] = v["pos_embed"][None]
    if v.get("ln_pre") is not None:
        out[vt + "norm_pre.weight"] = v["ln_pre"]["scale"]
        out[vt + "norm_pre.bias"] = v["ln_pre"]["bias"]
    if v.get("ln_post") is not None:
        out[vt + "norm.weight"] = v["ln_post"]["scale"]
        out[vt + "norm.bias"] = v["ln_post"]["bias"]
    if "rope_freqs" in v:
        out[vt + "rope.freqs"] = v["rope_freqs"]
    blocks = v["blocks"]
    for i in range(cfg.vision.depth):
        b = f"{vt}blocks.{i}."
        out[b + "norm1.weight"] = blocks["ln1_scale"][i]
        out[b + "norm1.bias"] = blocks["ln1_bias"][i]
        out[b + "attn.qkv.weight"] = blocks["wqkv"][i].T
        out[b + "attn.qkv.bias"] = blocks["bqkv"][i]
        out[b + "attn.proj.weight"] = blocks["wo"][i].T
        out[b + "attn.proj.bias"] = blocks["bo"][i]
        out[b + "norm2.weight"] = blocks["ln2_scale"][i]
        out[b + "norm2.bias"] = blocks["ln2_bias"][i]
        out[b + "mlp.fc1.weight"] = blocks["fc1"][i].T
        out[b + "mlp.fc1.bias"] = blocks["b1"][i]
        out[b + "mlp.fc2.weight"] = blocks["fc2"][i].T
        out[b + "mlp.fc2.bias"] = blocks["b2"][i]
        if "ls1" in blocks:
            out[b + "ls1.gamma"] = blocks["ls1"][i]
            out[b + "ls2.gamma"] = blocks["ls2"][i]

    # projector
    pj = host["projector"]
    mm = "mllm.model.multi_modal_projector."
    out[mm + "linear_1.weight"] = pj["fc1"].T
    out[mm + "linear_1.bias"] = pj["b1"]
    out[mm + "linear_2.weight"] = pj["fc2"].T
    out[mm + "linear_2.bias"] = pj["b2"]

    # decoder (unpad vocab rows back to the true extended vocab)
    llm = host["llm"]
    lm = "mllm.model.language_model."
    vocab = cfg.extended_vocab_size
    out[lm + "embed_tokens.weight"] = llm["embed"][:vocab]
    out[lm + "norm.weight"] = llm["final_norm"]
    for i in range(cfg.text.num_layers):
        b = f"{lm}layers.{i}."
        bl = llm["blocks"]
        out[b + "input_layernorm.weight"] = bl["attn_norm"][i]
        out[b + "self_attn.q_proj.weight"] = bl["wq"][i].T
        out[b + "self_attn.k_proj.weight"] = bl["wk"][i].T
        out[b + "self_attn.v_proj.weight"] = bl["wv"][i].T
        out[b + "self_attn.o_proj.weight"] = bl["wo"][i].T
        out[b + "post_attention_layernorm.weight"] = bl["mlp_norm"][i]
        out[b + "mlp.gate_proj.weight"] = bl["w_gate"][i].T
        out[b + "mlp.up_proj.weight"] = bl["w_up"][i].T
        out[b + "mlp.down_proj.weight"] = bl["w_down"][i].T
    if "lm_head" in llm:
        out["mllm.lm_head.weight"] = llm["lm_head"].T[:vocab]

    # mask patch embedding
    kh, kw = cfg.mask_patch_kernel
    out["mask_patch_embedding.weight"] = (
        host["mask_embed"]["kernel"].T.reshape(cfg.vision.width, cfg.mask_in_channels, kh, kw)
    )
    return {name: _numpy(x) for name, x in out.items()}


def export_hf_checkpoint(path: str, cfg: GARConfig, params) -> None:
    """Write `path/model.safetensors` and `path/config.json`."""
    os.makedirs(path, exist_ok=True)
    write_safetensors(export_hf_state_dict(cfg, params), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gar", "gar_tpu_config": to_dict(cfg)}, f, indent=2)
