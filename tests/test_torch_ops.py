"""The PyTorch port's ops, configs, synthetic batch and weight loader,
each against its JAX counterpart on the same numpy inputs.

Tolerance: 1e-5 in fp32. The two frameworks take the same sums in another
order, which moves fp32 results by a few ulps, far below 1e-5 at these
magnitudes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _rope_cfg(scaling):
    return dataclasses.replace(jcfg.gar_tiny().text, rope_scaling_factor=scaling,
                               head_dim=64)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("name", ["gar_tiny", "gar_1b", "gar_8b"])
def test_presets_equal_field_for_field(name):
    j = jcfg.PRESETS[name]()
    t = tcfg.PRESETS[name]()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("crop_token_ids", "extended_vocab_size", "padded_vocab_size",
                 "mask_patch_kernel", "tokens_per_tile"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for prop in ("grid_size", "num_patches", "seq_len", "head_dim", "mlp_hidden"):
        assert getattr(t.vision, prop) == getattr(j.vision, prop), prop
    assert t.text.q_per_kv == j.text.q_per_kv


def test_token_constants_equal():
    names = ["IMAGE_TOKEN_ID", "VIDEO_TOKEN_ID", "BASE_VOCAB_SIZE", "CROP_TOKEN_IDS_5",
             "BOT_TOKEN_ID", "START_HEADER_ID", "END_HEADER_ID", "EOT_TOKEN_ID",
             "ASSISTANT_ROLE_ID", "NEWLINE2_ID", "REPLAY_TOKENS_PER_REGION",
             "REPLAY_SIDE", "PIXELS_PER_POOLED_TOKEN"]
    for n in names:
        assert getattr(tcfg, n) == getattr(jcfg, n), n
    for k in range(1, 9):
        assert tcfg.crop_token_ids(k) == jcfg.crop_token_ids(k)


# ---------------------------------------------------------------- norms

def test_rms_norm_and_layer_norm(rng):
    from grasp_any_region_tpu.ops import norms as jn
    from grasp_any_region_tpu_torch.ops import norms as tn

    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tn.rms_norm(_t(x), _t(w)), jn.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tn.layer_norm(_t(x), _t(w), _t(bias)),
           jn.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))


# ---------------------------------------------------------------- rope

@pytest.mark.parametrize("scaling", [None, 32.0])
def test_llama_rope(rng, scaling):
    from grasp_any_region_tpu.ops import rope as jr
    from grasp_any_region_tpu_torch.ops import rope as tr

    cfg = _rope_cfg(scaling)
    tcfg_text = tcfg.TextConfig(**dataclasses.asdict(cfg))
    inv_j = jr.llama_inv_freq(cfg)
    inv_t = tr.llama_inv_freq(tcfg_text)
    _close(inv_t, inv_j, rtol=1e-6, atol=0)
    pos = rng.integers(0, 9000, size=(2, 5)).astype(np.int32)
    cos_j, sin_j = jr.rope_cos_sin(jnp.asarray(pos), inv_j)
    cos_t, sin_t = tr.rope_cos_sin(torch.from_numpy(pos), inv_t)
    _close(cos_t, cos_j, rtol=0, atol=2e-5)  # fp32 angles up to ~9e3 rad
    _close(sin_t, sin_j, rtol=0, atol=2e-5)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    _close(tr.apply_rope(_t(x), cos_t, sin_t), jr.apply_rope(jnp.asarray(x), cos_j, sin_j))


@pytest.mark.parametrize("mixed", [True, False])
def test_vision_rope_2d(rng, mixed):
    from grasp_any_region_tpu.ops import rope as jr
    from grasp_any_region_tpu_torch.ops import rope as tr

    vj = jcfg.gar_tiny().vision
    vt = tcfg.gar_tiny().vision
    if mixed:
        freqs = rng.standard_normal((vj.depth, vj.num_heads, vj.head_dim // 2, 2))
        freqs = freqs.astype(np.float32) * 0.3
        ang_j = jr.mixed_rope_angles(jnp.asarray(freqs), vj)[1]
        ang_t = tr.mixed_rope_angles(_t(freqs), vt)[1]
    else:
        ang_j = jr.axial_rope_angles(vj)
        ang_t = tr.axial_rope_angles(vt)
    _close(ang_t, ang_j)
    x = rng.standard_normal((2, vj.seq_len, vj.num_heads, vj.head_dim)).astype(np.float32)
    out_t = tr.apply_rope_2d_tshd(_t(x), ang_t, 1)
    _close(out_t, jr.apply_rope_2d_tshd(jnp.asarray(x), ang_j, 1))
    assert torch.equal(out_t[:, 0], _t(x)[:, 0])  # CLS passes through unroped


# ---------------------------------------------------------------- pooling

def test_pool_tokens_2x(rng):
    from grasp_any_region_tpu.ops.pooling import pool_tokens_2x as jp
    from grasp_any_region_tpu_torch.ops.pooling import pool_tokens_2x as tp

    x = rng.standard_normal((3, 64, 5)).astype(np.float32)
    _close(tp(_t(x)), jp(jnp.asarray(x)))


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,sq,sk,h,kh,segments", [
    (True, 33, 33, 4, 2, False),
    (True, 17, 40, 4, 1, False),   # right-aligned suffix query
    (False, 29, 29, 2, 2, False),
    (True, 31, 31, 4, 2, True),    # packed rows: block-diagonal segments
])
def test_mha_reference_and_dispatch(rng, causal, sq, sk, h, kh, segments):
    from grasp_any_region_tpu.ops import attention as ja
    from grasp_any_region_tpu_torch.ops import attention as ta

    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, kh, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, kh, 16)).astype(np.float32)
    seg = None
    if segments:
        seg = np.sort(rng.integers(0, 3, size=(2, sq)), axis=1).astype(np.int32)
    ref = ja.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           segment_ids=None if seg is None else jnp.asarray(seg))
    tseg = None if seg is None else torch.from_numpy(seg)
    _close(ta.mha_reference(_t(q), _t(k), _t(v), causal=causal, segment_ids=tseg), ref)
    _close(ta.mha(_t(q), _t(k), _t(v), causal=causal, segment_ids=tseg), ref)


def test_decode_attention_reference(rng):
    from grasp_any_region_tpu.ops import attention as ja
    from grasp_any_region_tpu_torch.ops import attention as ta

    b, kh, s, d, h = 2, 2, 64, 16, 8
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    plens = np.array([10, 25], np.int32)
    ref = ja.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), prompt_lens=jnp.asarray(plens),
        write_pos=jnp.asarray(40, jnp.int32), prompt_pad=32)
    out = ta.decode_attention_reference(
        _t(q), _t(kc), _t(vc), prompt_lens=torch.from_numpy(plens),
        write_pos=torch.tensor(40, dtype=torch.int32), prompt_pad=32)
    _close(out, ref)


# ---------------------------------------------------------------- replay

@pytest.mark.parametrize("double_scale_compat", [True, False])
def test_replay_features(rng, double_scale_compat):
    from grasp_any_region_tpu.models import replay as jr
    from grasp_any_region_tpu_torch.models import replay as tr

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    feats = rng.standard_normal((1 + 6, 256, 8)).astype(np.float32)
    ar = np.array([3, 2], np.int32)
    boxes = np.array([[0.1, 0.2, 0.7, 0.9], [0.0, 0.0, 1.0, 1.0],
                      [0.45, 0.3, 0.55, 0.62]], np.float32)
    ref = jr.replay_features(cfg_j, jnp.asarray(feats), jnp.asarray(ar), jnp.asarray(boxes),
                             double_scale_compat=double_scale_compat)
    out = tr.replay_features(cfg_t, _t(feats), torch.from_numpy(ar), _t(boxes),
                             double_scale_compat=double_scale_compat)
    _close(out, ref)
    # boxes in feature coords that cross tile borders and the map's edge
    fb = np.array([[3.3, 14.2, 20.6, 30.9], [-0.7, -0.2, 47.5, 31.6]], np.float32)
    grid = feats[1:].reshape(6, 16, 16, 8)
    ref = jr.roi_align_tiled(jnp.asarray(grid), jnp.asarray(3), jnp.asarray(2), jnp.asarray(fb))
    out = tr.roi_align_tiled(_t(grid), torch.tensor(3), torch.tensor(2), _t(fb))
    _close(out, ref)


def test_scatter_replay(rng):
    from grasp_any_region_tpu.models.replay import scatter_replay as js
    from grasp_any_region_tpu_torch.models.replay import scatter_replay as ts

    emb = rng.standard_normal((2, 600, 4)).astype(np.float32)
    rep = rng.standard_normal((2, 3, 256, 4)).astype(np.float32)
    pos = np.array([[5, 100, 0], [300, 500, 7]], np.int32)  # 500 clamps to 344
    valid = np.array([[True, True, False], [True, True, True]])
    ref = js(jnp.asarray(emb), jnp.asarray(rep), jnp.asarray(pos), jnp.asarray(valid))
    out = ts(_t(emb), _t(rep), torch.from_numpy(pos), torch.from_numpy(valid))
    _close(out, ref, rtol=0, atol=0)


# ---------------------------------------------------------------- data and weights

def test_synthetic_batch_matches_jax():
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    kw = dict(batch=2, grid=(2, 1), regions=2, seed=3)
    jb, jl, jp = jsb(jcfg.gar_tiny(), **kw)
    tb, tl, tp = tsb(tcfg.gar_tiny(), **kw, device="cpu")
    for name in jb._fields:
        if getattr(jb, name) is None:
            continue
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.fixture(scope="module")
def tiny_flat():
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.models import init_gar_params

    return flatten_params(init_gar_params(jax.random.PRNGKey(0), jcfg.gar_tiny()))


def test_load_flat_params_consumes_every_key(tiny_flat):
    from grasp_any_region_tpu_torch.core.weights import load_flat_params

    params = load_flat_params(tiny_flat, tcfg.gar_tiny(), device="cpu")
    loaded = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    assert set(loaded) == set(tiny_flat)
    for key, arr in tiny_flat.items():
        assert tuple(loaded[key].shape) == arr.shape, key
        np.testing.assert_array_equal(loaded[key].numpy(), arr, err_msg=key)


def test_load_flat_params_rejects_bad_trees(tiny_flat):
    from grasp_any_region_tpu_torch.core.weights import load_flat_params

    cfg = tcfg.gar_tiny()
    missing = dict(tiny_flat)
    del missing["llm/blocks/wq"]
    with pytest.raises(KeyError, match="llm/blocks/wq"):
        load_flat_params(missing, cfg, device="cpu")
    extra = dict(tiny_flat, **{"llm/blocks/extra": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_flat_params(extra, cfg, device="cpu")
    bad = dict(tiny_flat, **{"vision/pos_embed": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="vision/pos_embed"):
        load_flat_params(bad, cfg, device="cpu")


def test_init_gar_params_follows_jax_rules(tiny_flat):
    from grasp_any_region_tpu_torch.core.weights import init_gar_params

    params = init_gar_params(tcfg.gar_tiny(), torch.Generator().manual_seed(0), device="cpu")
    got = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    assert set(got) == set(tiny_flat)
    for key, ref in tiny_flat.items():
        p = got[key].numpy()
        assert p.shape == ref.shape and p.dtype == ref.dtype, key
        if np.all(ref == ref.flat[0]):  # constant init: ones, zeros, LayerScale
            np.testing.assert_array_equal(p, ref, err_msg=key)
        elif key != "vision/rope_freqs":  # truncated normal, std 0.02, cut at 2 std
            assert np.abs(p).max() <= 0.04 + 1e-7, key
            assert abs(p.std() - ref.std()) < 0.25 * ref.std(), key


def test_lm_logits_bf16_keeps_fp32_sums(tiny_flat, rng):
    """bf16 hidden and bf16 tied embedding: the logits are fp32 sums of the
    bf16 operands, as JAX contracts them (preferred_element_type=float32),
    not bf16-rounded products widened afterwards (a 2^-9 relative error)."""
    from grasp_any_region_tpu.models.llama import lm_logits as jlogits
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.models.llama import lm_logits as tlogits

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    jparams = {k: jnp.asarray(tiny_flat[f"llm/{k}"], jnp.bfloat16)
               for k in ("embed", "final_norm")}
    tparams = load_flat_params(tiny_flat, cfg_t, device="cpu", dtype=torch.bfloat16).llm
    hidden = rng.standard_normal((3, cfg_t.text.hidden_size)).astype(np.float32) * 4
    vocab = cfg_t.extended_vocab_size
    ref = np.asarray(jlogits(jparams, cfg_j.text, jnp.asarray(hidden, jnp.bfloat16),
                             valid_vocab=vocab))
    out = tlogits(tparams, cfg_t.text, _t(hidden).to(torch.bfloat16), valid_vocab=vocab)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    scale = np.abs(ref[:, :vocab]).max()
    np.testing.assert_allclose(out[:, :vocab].numpy() / scale, ref[:, :vocab] / scale, **TOL)
    np.testing.assert_array_equal(out[:, vocab:].numpy(), ref[:, vocab:])
