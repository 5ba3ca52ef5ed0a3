"""Checkpoint and config I/O of the PyTorch port against the JAX package's:
configs round-trip through either side's JSON, checkpoints written by one
side load in the other with equal leaves (bf16 leaves stored as fp32, an
int8 serving tree included), the port's numpy safetensors reader and
writer agree with the `safetensors` package, and the HF-name conversion
gives JAX's tree."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core import weights as jw
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core import weights as tw

HF_PLM = {  # a bare Perception-LM config.json's fields that the mapping reads
    "vision_config": {"num_features": 1024, "model_args": {
        "embed_dim": 1024, "depth": 23, "num_heads": 16, "mlp_ratio": 4.0, "patch_size": 14,
        "img_size": [448, 448], "ref_feat_shape": [32, 32], "use_rot_pos_emb": True,
        "init_values": 0.1}},
    "text_config": {"vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
                    "num_hidden_layers": 16, "num_attention_heads": 32,
                    "num_key_value_heads": 8, "rope_theta": 500000.0,
                    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192}},
    "projector_pooling_ratio": 2,
}
HF_GAR = {"prompt_numbers": 8, "mllm_config": {
    "vision_config": {"model_args": {"embed_dim": 1536, "depth": 47, "mlp_ratio": 5.8}},
    "text_config": {"hidden_size": 4096, "num_attention_heads": 32, "head_dim": 128,
                    "tie_word_embeddings": False, "rope_scaling": None},
    "image_token_id": 128002}}


def _jax_params(cfg):
    """JAX gar_tiny params with a non-zero mask embed."""
    from grasp_any_region_tpu.models import init_gar_params

    params = init_gar_params(jax.random.PRNGKey(3), cfg)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 0.02)
    return params


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("preset", ["gar_1b", "gar_8b", "gar_tiny"])
def test_config_round_trips_between_the_packages(tmp_path, preset):
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    assert tcfg.to_dict(tc) == jcfg.to_dict(jc)
    tcfg.save_config(tc, str(tmp_path / "t.json"))
    jcfg.save_config(jc, str(tmp_path / "j.json"))
    assert tcfg.load_config(str(tmp_path / "j.json")) == tc
    assert jcfg.to_dict(jcfg.load_config(str(tmp_path / "t.json"))) == jcfg.to_dict(jc)
    assert tcfg.gar_config_from_dict(jcfg.to_dict(jc)) == tc
    assert isinstance(tcfg.load_config(str(tmp_path / "j.json")).vision.img_size, tuple)


def test_apply_overrides_equals_jax():
    over = {"text.num_layers": 4, "vision.img_size": [224, 224], "max_num_tiles": 9,
            "text.rope_scaling_factor": None}
    got = tcfg.apply_overrides(tcfg.gar_1b(), over)
    assert tcfg.to_dict(got) == jcfg.to_dict(jcfg.apply_overrides(jcfg.gar_1b(), over))
    assert got.vision.img_size == (224, 224) and got.text.num_layers == 4
    with pytest.raises(KeyError, match="unknown override key"):
        tcfg.apply_overrides(tcfg.gar_1b(), {"text.nope": 1})
    with pytest.raises(KeyError, match="unknown config key"):
        tcfg.gar_config_from_dict({"nope": 1})


@pytest.mark.parametrize("hf", [HF_PLM, HF_GAR], ids=["plm", "gar_export"])
def test_from_hf_config_equals_jax(hf):
    got = tcfg.from_hf_config(hf)
    assert tcfg.to_dict(got) == jcfg.to_dict(jcfg.from_hf_config(hf))
    assert got.vision.img_size == (448, 448)


@pytest.mark.parametrize("kind", ["F32", "BF16", "I8", "I32"])
def test_safetensors_io_agrees_with_the_package(tmp_path, kind):
    """The port's writer is read by safetensors.numpy and the package's
    files by the port's reader, bit for bit; bf16 (written by the torch
    front end: numpy has none) widens to fp32 exactly."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    shapes = [(3, 5), (2, 1, 4), (7,), (0, 3)]
    if kind == "BF16":
        tensors = {f"t/{i}": torch.randn(s, generator=torch.Generator().manual_seed(i))
                   .to(torch.bfloat16) for i, s in enumerate(shapes)}
        save_torch(tensors, str(tmp_path / "p.safetensors"))
        got = tw.read_safetensors(str(tmp_path / "p.safetensors"))
        _assert_flat_equal(got, {k: v.float().numpy() for k, v in tensors.items()})
        return
    dt = {"F32": np.float32, "I8": np.int8, "I32": np.int32}[kind]
    arrays = {f"t/{i}": (rng.standard_normal(s) * 50).astype(dt) for i, s in enumerate(shapes)}
    arrays["scalar"] = np.asarray(7, dt)
    arrays["strided"] = (rng.standard_normal((4, 6)) * 50).astype(dt).T
    tw.write_safetensors(arrays, str(tmp_path / "mine.safetensors"))
    _assert_flat_equal(load_file(str(tmp_path / "mine.safetensors")), arrays)
    save_file({k: np.ascontiguousarray(v) if v.ndim else v for k, v in arrays.items()},
              str(tmp_path / "theirs.safetensors"))
    _assert_flat_equal(tw.read_safetensors(str(tmp_path / "theirs.safetensors")), arrays)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = _jax_params(cfg_j)
    jw.save_checkpoint(str(tmp_path), cfg_j, params)
    cfg, flat = tw.read_checkpoint(str(tmp_path))
    assert cfg == cfg_t
    _assert_flat_equal(flat, jw.flatten_params(params))
    cfg, tparams = tw.load_checkpoint(str(tmp_path), device="cpu")
    assert {p.device.type for p in tparams.parameters()} == {"cpu"}
    _assert_flat_equal(tw.flatten_params(tparams), jw.flatten_params(params))
    _, bf = tw.load_checkpoint(str(tmp_path), device="cpu", dtype=torch.bfloat16)
    assert bf.llm.embed.dtype == torch.bfloat16 and bf.vision.rope_freqs.dtype == torch.float32


@pytest.mark.parametrize("tree", ["bf16", "int8_serving"])
def test_port_checkpoint_loads_in_jax(tmp_path, tree):
    """The port's files: JAX's load_checkpoint and safetensors.numpy read
    them, bf16 leaves stored as fp32 and int8 leaves as int8, equal to the
    port's leaves (widened)."""
    from safetensors.numpy import load_file

    from grasp_any_region_tpu_torch.models.quantize import serving_weights

    cfg_t = tcfg.gar_tiny()
    jparams = _jax_params(jcfg.gar_tiny())
    tparams = tw.load_flat_params(jw.flatten_params(jparams), cfg_t, device="cpu",
                                  dtype=torch.bfloat16)
    if tree == "int8_serving":
        tparams = serving_weights(tparams)
    tw.save_checkpoint(str(tmp_path), cfg_t, tparams)
    stored = load_file(str(tmp_path / "model.safetensors"))
    kinds = {str(v.dtype) for v in stored.values()}
    assert kinds == ({"float32", "int8"} if tree == "int8_serving" else {"float32"})
    want = {name.replace(".", "/"): (p.detach().float() if p.dtype.is_floating_point
                                     else p.detach()).numpy()
            for name, p in tparams.named_parameters()}
    _assert_flat_equal(stored, want)
    cfg, jback = jw.load_checkpoint(str(tmp_path))
    assert jcfg.to_dict(cfg) == tcfg.to_dict(cfg_t)
    _assert_flat_equal(jw.flatten_params(jback), want)
    with open(tmp_path / "config.json") as f:
        assert set(json.load(f)) == {"gar_tpu_config"}
    # and back into the port, the int8 layout read from the names
    _, again = tw.load_checkpoint(str(tmp_path), device="cpu", dtype=torch.bfloat16)
    for (name, p), (_, q) in zip(tparams.named_parameters(), again.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name


def test_convert_hf_state_dict_equals_jax(tmp_path):
    """The HF-named tensors that JAX's export makes from JAX params convert
    to JAX's tree, in memory and through an exported checkpoint directory,
    for the tied and the untied head."""
    from grasp_any_region_tpu.train.export import export_hf_checkpoint, export_hf_state_dict

    for tie in (True, False):
        cfg_j = jcfg.gar_tiny()
        cfg_j = dataclasses.replace(cfg_j, text=dataclasses.replace(cfg_j.text,
                                                                    tie_word_embeddings=tie))
        cfg_t = tcfg.gar_config_from_dict(jcfg.to_dict(cfg_j))
        params = _jax_params(cfg_j)
        if not tie:
            params["llm"]["lm_head"] = params["llm"]["embed"].T * 0.5
        sd = export_hf_state_dict(cfg_j, params)
        got = tw.flatten_params(tw.convert_hf_state_dict(cfg_t, sd))
        _assert_flat_equal(got, jw.flatten_params(jw.convert_hf_state_dict(cfg_j, sd)))
        assert ("llm/lm_head" in got) == (not tie)
    export_hf_checkpoint(str(tmp_path), cfg_j, params)
    cfg, flat = tw.read_checkpoint(str(tmp_path))
    assert cfg == cfg_t
    _, jparams = jw.load_checkpoint(str(tmp_path))
    _assert_flat_equal(flat, jw.flatten_params(jparams))
    with pytest.raises(ValueError, match="missing components"):
        tw.convert_hf_state_dict(cfg_t, {"mllm.lm_head.weight": np.zeros((2, 2), np.float32)})
