"""SAM weights (`grasp_any_region_tpu/sam/weights.py`): an HF SamModel
safetensors export -> JAX's SAM tree -> the port's `ParamTree`.

The HF `facebook/sam-vit-*` layout (vision_encoder.*, prompt_encoder.*,
mask_decoder.*): Linear weights transpose (torch (out, in) -> (in, out)),
convs flatten to the matmul layouts of sam/model.py. The files are read by
the port's numpy safetensors reader (`core/weights.read_safetensors`), so
loading needs no package beyond numpy. `sam_params_from_numpy` carries a
numpy tree in JAX's layout (JAX `init_sam_params` or `convert_hf_sam`)
onto the port's parameters, leaf for leaf.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.weights import read_safetensors, require_device
from .model import ParamTree, SAMConfig, sam_vit_b, sam_vit_h, sam_vit_l


def _cfg_from_hf(hf: dict) -> SAMConfig:
    v = hf.get("vision_config", {})
    dim = v.get("hidden_size", 768)
    if dim >= 1280:
        return sam_vit_h()
    if dim >= 1024:
        return sam_vit_l()
    return sam_vit_b()


def sam_params_from_numpy(tree: Mapping, device="cuda", dtype=torch.float32) -> ParamTree:
    """The port's SAM parameters from a numpy tree in JAX's layout, each
    leaf copied as it is (cast to `dtype`) onto `device`: the card unless
    the caller asks for the CPU."""
    return ParamTree(tree, require_device(device), dtype)


def load_sam_checkpoint(path: str, device="cuda",
                        dtype=torch.float32) -> Tuple[SAMConfig, ParamTree]:
    """(config, parameters on `device`) of an HF SAM checkpoint directory
    (config.json and *.safetensors)."""
    device = require_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = _cfg_from_hf(hf)
    tensors: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            tensors.update(read_safetensors(os.path.join(path, fname)))
    return cfg, sam_params_from_numpy(convert_hf_sam(cfg, tensors), device, dtype)


def convert_hf_sam(cfg: SAMConfig, t: Mapping[str, np.ndarray]) -> dict:
    """HF SamModel tensors -> JAX's SAM tree of numpy arrays (JAX's
    `convert_hf_sam` leaf for leaf, but for the Fourier table's layout)."""
    def g(name, transpose=False):
        x = np.asarray(t[name])
        return x.T if transpose else x

    d = cfg.embed_dim
    ve = "vision_encoder."
    enc = {
        "patch_embed": {
            "kernel": g(ve + "patch_embed.projection.weight").reshape(d, -1).T,
            "bias": g(ve + "patch_embed.projection.bias"),
        },
        "pos_embed": g(ve + "pos_embed").reshape(cfg.grid, cfg.grid, d),
        "blocks": [],
        "neck": {
            "conv1": g(ve + "neck.conv1.weight").reshape(cfg.out_chans, d).T,
            "ln1": {"scale": g(ve + "neck.layer_norm1.weight"),
                    "bias": g(ve + "neck.layer_norm1.bias")},
            "conv2": g(ve + "neck.conv2.weight").transpose(2, 3, 1, 0).reshape(
                9 * cfg.out_chans, cfg.out_chans),
            "ln2": {"scale": g(ve + "neck.layer_norm2.weight"),
                    "bias": g(ve + "neck.layer_norm2.bias")},
        },
    }
    for i in range(cfg.depth):
        b = f"{ve}layers.{i}."
        enc["blocks"].append({
            "ln1": {"scale": g(b + "layer_norm1.weight"), "bias": g(b + "layer_norm1.bias")},
            "wqkv": g(b + "attn.qkv.weight", transpose=True),
            "bqkv": g(b + "attn.qkv.bias"),
            "wo": g(b + "attn.proj.weight", transpose=True),
            "bo": g(b + "attn.proj.bias"),
            "rel_h": g(b + "attn.rel_pos_h"),
            "rel_w": g(b + "attn.rel_pos_w"),
            "ln2": {"scale": g(b + "layer_norm2.weight"), "bias": g(b + "layer_norm2.bias")},
            "fc1": g(b + "mlp.lin1.weight", transpose=True),
            "b1": g(b + "mlp.lin1.bias"),
            "fc2": g(b + "mlp.lin2.weight", transpose=True),
            "b2": g(b + "mlp.lin2.bias"),
        })

    pe = "prompt_encoder."
    shared = "shared_image_embedding.positional_embedding"
    table = g(shared) if shared in t else g(pe + "shared_embedding.positional_embedding")
    prompt = {
        # HF keeps the Fourier table as (2, C/2) and multiplies coords @
        # table, as sam/model.py does; JAX transposes it whatever its shape,
        # which only a (C/2, 2) table survives. The port takes a (2, C/2)
        # table as stored and transposes a (C/2, 2) one.
        "pe_gaussian": table if table.shape[0] == 2 else table.T,
        "point_embeds": np.stack([g(pe + f"point_embed.{i}.weight")[0] for i in range(4)]),
        "not_a_point": g(pe + "not_a_point_embed.weight"),
        "no_mask": g(pe + "no_mask_embed.weight"),
    }

    md = "mask_decoder."

    def attn(prefix):
        return {
            "wq": g(prefix + "q_proj.weight", True), "bq": g(prefix + "q_proj.bias"),
            "wk": g(prefix + "k_proj.weight", True), "bk": g(prefix + "k_proj.bias"),
            "wv": g(prefix + "v_proj.weight", True), "bv": g(prefix + "v_proj.bias"),
            "wo": g(prefix + "out_proj.weight", True), "bo": g(prefix + "out_proj.bias"),
        }

    def ln(prefix):
        return {"scale": g(prefix + ".weight"), "bias": g(prefix + ".bias")}

    blocks = []
    for i in range(cfg.decoder_depth):
        b = f"{md}transformer.layers.{i}."
        blocks.append({
            "self_attn": attn(b + "self_attn."),
            "ln1": ln(b + "layer_norm1"),
            "cross_t2i": attn(b + "cross_attn_token_to_image."),
            "ln2": ln(b + "layer_norm2"),
            "mlp_fc1": g(b + "mlp.lin1.weight", True),
            "mlp_b1": g(b + "mlp.lin1.bias"),
            "mlp_fc2": g(b + "mlp.lin2.weight", True),
            "mlp_b2": g(b + "mlp.lin2.bias"),
            "ln3": ln(b + "layer_norm3"),
            "cross_i2t": attn(b + "cross_attn_image_to_token."),
            "ln4": ln(b + "layer_norm4"),
        })
    nm = cfg.num_multimask_outputs + 1
    hyper = f"{md}output_hypernetworks_mlps."
    dec = {
        "iou_token": g(md + "iou_token.weight"),
        "mask_tokens": g(md + "mask_tokens.weight"),
        "blocks": blocks,
        "final_t2i": attn(md + "transformer.final_attn_token_to_image."),
        "ln_final": ln(md + "transformer.layer_norm_final_attn"),
        "upscale1": g(md + "upscale_conv1.weight"),
        "up_ln": ln(md + "upscale_layer_norm"),
        "upscale2": g(md + "upscale_conv2.weight"),
        "hyper_mlps": [
            {
                "fc1": g(f"{hyper}{i}.proj_in.weight", True),
                "b1": g(f"{hyper}{i}.proj_in.bias"),
                "fc2": g(f"{hyper}{i}.layers.0.weight", True),
                "b2": g(f"{hyper}{i}.layers.0.bias"),
                "fc3": g(f"{hyper}{i}.proj_out.weight", True),
                "b3": g(f"{hyper}{i}.proj_out.bias"),
            }
            for i in range(nm)
        ],
        "iou_mlp": {
            "fc1": g(md + "iou_prediction_head.proj_in.weight", True),
            "b1": g(md + "iou_prediction_head.proj_in.bias"),
            "fc2": g(md + "iou_prediction_head.layers.0.weight", True),
            "b2": g(md + "iou_prediction_head.layers.0.bias"),
            "fc3": g(md + "iou_prediction_head.proj_out.weight", True),
            "b3": g(md + "iou_prediction_head.proj_out.bias"),
        },
    }
    return {"encoder": enc, "prompt": prompt, "decoder": dec}
