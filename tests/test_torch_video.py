"""The PyTorch port's video path against the JAX package's at gar_tiny in
fp32: per-region RoIAlign, the per-frame feature replay, the prefill
embeddings with video_mode, and greedy generation with video_mode, on a
batch that `build_video_batch` makes on both sides from seeded frames.

The decoder's projections are scaled by 10 and mask_embed is random, as
in tests/test_torch_model.py, so greedy decoding does not repeat one token.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg


def port_numpy_resize(img, out_h, out_w, antialias=True, n_threads=0):
    """The port's numpy resize in place of its native one: JAX's numpy form bit for bit."""
    from grasp_any_region_tpu_torch.data.resize import resize_bicubic

    return resize_bicubic(img, out_h, out_w, antialias, use_native=False)


F32 = torch.float32
CLOSE = dict(rtol=1e-4, atol=1e-4)


def _frames(seed=0, n=3):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(n)]
    m0 = np.zeros((120, 160), np.uint8)
    m0[10:60, 20:80] = 1
    m2 = np.zeros((120, 160), np.uint8)
    m2[40:100, 60:140] = 1
    return frames, {0: m0, 2: m2}


@pytest.fixture(scope="module")
def video():
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data import builders as jb
    from grasp_any_region_tpu.data.image_processor import GARImageProcessor as JProc
    from grasp_any_region_tpu.data.tokenizer import GARTokenizer as JTok
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.data import builders as tb
    from grasp_any_region_tpu_torch.data.image_processor import GARImageProcessor as TProc
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer as TTok

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")
    frames, masks = _frames()
    q = "What is the masked object doing?"
    with pytest.MonkeyPatch.context() as mp:  # JAX's numpy resize, as the port's
        mp.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                   lambda *a, **k: None)
        mp.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                   port_numpy_resize)
        jbatch, jlens = jb.build_video_batch(cfg_j, JTok.synthetic(), JProc(),
                                             [jb.VideoRegionSample(frames, masks, q)])
        tbatch, tlens = tb.build_video_batch(cfg_t, TTok.synthetic(), TProc(),
                                             [tb.VideoRegionSample(frames, masks, q)],
                                             device="cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, tparams=tparams, jb=jbatch, tb=tbatch,
                jlens=jlens, tlens=tlens)


def _boxes(rng, r, hi):
    lo = rng.uniform(-1.5, hi * 0.7, (r, 2))
    return np.concatenate([lo, lo + rng.uniform(0.05, hi * 0.6, (r, 2))], axis=1).astype(np.float32)


def test_roi_align_per_region_equals_jax(rng):
    """Boxes inside, across and outside the 16x16 maps, and degenerate."""
    from grasp_any_region_tpu.models.replay import roi_align_per_region as jroi
    from grasp_any_region_tpu_torch.models.replay import roi_align_per_region as troi

    maps = rng.standard_normal((6, 16, 16, 8)).astype(np.float32)
    boxes = _boxes(rng, 6, 16.0)
    boxes[4] = [15.0, 15.0, 18.0, 19.0]
    boxes[5] = [3.0, 3.0, 3.0, 3.0]
    got = troi(torch.from_numpy(maps), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(jroi(jnp.asarray(maps), jnp.asarray(boxes))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("double_scale_compat", [True, False])
def test_replay_features_video_equals_jax(rng, double_scale_compat):
    from grasp_any_region_tpu.models.replay import replay_features_video as jrep
    from grasp_any_region_tpu_torch.models.replay import replay_features_video as trep

    feats = rng.standard_normal((4, 256, 16)).astype(np.float32)
    frame_idx = np.array([0, 3, 2, 5], np.int32)  # 5 is past the frames: clamped
    boxes = np.clip(_boxes(rng, 4, 1.0), 0.0, 1.0)
    got = trep(tcfg.gar_tiny(), torch.from_numpy(feats), torch.from_numpy(frame_idx),
               torch.from_numpy(boxes), double_scale_compat=double_scale_compat)
    want = jrep(jcfg.gar_tiny(), jnp.asarray(feats), jnp.asarray(frame_idx), jnp.asarray(boxes),
                double_scale_compat=double_scale_compat)
    assert got.shape == (4, 256, 16) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_video_prefill_embeds_equal_jax(video):
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.models import gar as tg

    got = tg.build_prefill_embeds(video["tparams"], video["cfg_t"], video["tb"],
                                  compute_dtype=F32, video_mode=True)
    want = jg.build_prefill_embeds(video["params"], video["cfg_j"], video["jb"],
                                   compute_dtype=jnp.float32, video_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    image_mode = tg.build_prefill_embeds(video["tparams"], video["cfg_t"], video["tb"],
                                         compute_dtype=F32)
    assert not torch.allclose(image_mode, got, **CLOSE)  # the mode changes the embeds
    with pytest.raises(ValueError, match="replay_tile"):
        tg.build_prefill_embeds(video["tparams"], video["cfg_t"],
                                video["tb"]._replace(replay_tile=None), video_mode=True)


def test_video_generate_greedy_tokens_equal_jax(video):
    """Greedy tokens equal JAX's token for token at fp32 (JAX's compute
    dtype patched from bf16 as in tests/test_torch_model.py)."""
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.models.generate import generate as tgen

    n_new = 8
    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "gar_prefill", functools.partial(jg.gar_prefill, compute_dtype=jnp.float32))
        mp.setattr(jmod, "gar_decode_step",
                   functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32))
        jgen = jax.jit(jmod.generate.__wrapped__,
                       static_argnames=("cfg", "max_new_tokens", "eot_id", "video_mode"))
        ref = jgen(video["params"], video["cfg_j"], video["jb"], video["jlens"],
                   max_new_tokens=n_new, eot_id=-1, video_mode=True)
    out = tgen(video["tparams"], video["cfg_t"], video["tb"], video["tlens"], max_new_tokens=n_new,
               eot_id=-1, compute_dtype=F32, video_mode=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(out.tokens[0].tolist())) > 1


@pytest.mark.parametrize("total,n", [(0, 4), (3, 8), (8, 8), (100, 7), (31, 32)])
def test_uniform_frame_indices_equal_jax(total, n):
    from grasp_any_region_tpu.data.video import uniform_frame_indices as juni
    from grasp_any_region_tpu_torch.data.video import uniform_frame_indices as tuni

    assert tuni(total, n) == juni(total, n)
