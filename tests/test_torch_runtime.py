"""The PyTorch port's front door: `GARRuntime` (load from random init, from
a checkpoint directory, with int8 serving weights), its captions against
the JAX package's runtime on the same checkpoint at fp32, token for token,
and the three CLIs on PNG files against `caption` on the same inputs.

The checkpoint is JAX gar_tiny params with a random mask_embed and the
decoder's projections scaled by 10 (as tests/test_torch_model.py builds
them, so greedy decoding does not repeat one token), written by JAX's
`save_checkpoint`. JAX's runtime runs its numpy resize (the port has no
native one) and its generate at fp32 (patched from bf16, as
tests/test_torch_model.py does).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.cli import runtime as trt
from grasp_any_region_tpu_torch.data.builders import RegionSample, VideoRegionSample

F32 = torch.float32
NEW = 6


def _mask(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from grasp_any_region_tpu.core.config import gar_tiny
    from grasp_any_region_tpu.core.weights import save_checkpoint
    from grasp_any_region_tpu.models import init_gar_params

    cfg = gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    path = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(path), cfg, params)
    return str(path)


def _samples(kind):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (300, 520, 3), dtype=np.uint8)
    if kind == "one_region":
        return [RegionSample(img, {1: _mask(300, 520, 30, 200, 40, 300)})]
    return [RegionSample(img, {0: _mask(300, 520, 30, 200, 40, 300),
                               1: _mask(300, 520, 120, 290, 250, 500)},
                         question="What is the relation between <Prompt0> and <Prompt1>?")]


def test_load_random_init(capsys):
    rt = trt.GARRuntime.load(None, "gar_tiny", random_init=False, seed=3, device="cpu")
    assert "RANDOM weights" in capsys.readouterr().err
    assert rt.device == torch.device("cpu") and rt.compute_dtype == torch.bfloat16
    assert rt.params.llm.embed.dtype == torch.bfloat16
    assert {p.device.type for p in rt.params.parameters()} == {"cpu"}
    again = trt.GARRuntime.load(None, "gar_tiny", random_init=True, seed=3, device="cpu")
    assert capsys.readouterr().err == ""
    assert torch.equal(rt.params.llm.embed, again.params.llm.embed)
    other = trt.GARRuntime.load(None, "gar_tiny", random_init=True, seed=4, device="cpu")
    assert not torch.equal(rt.params.llm.embed, other.params.llm.embed)
    assert rt.proc.config.max_num_tiles == rt.cfg.max_num_tiles == 4
    # self-speculative decoding runs and gives generate's greedy text
    samples = _samples("one_region")
    assert rt.caption(samples, max_new_tokens=6, speculative=(2, 1)) == \
        rt.caption(samples, max_new_tokens=6)


def _fp32_runtime(path):
    """A GARRuntime on the CPU over the checkpoint's leaves at fp32 (the
    runtime's own `load` keeps bf16), computing at fp32."""
    from grasp_any_region_tpu_torch.core.weights import load_checkpoint
    from grasp_any_region_tpu_torch.data.image_processor import (GARImageProcessor,
                                                                 ImageProcessorConfig)
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer

    cfg, params = load_checkpoint(path, device="cpu", dtype=F32)
    return trt.GARRuntime(
        cfg=cfg, params=params,
        tok=GARTokenizer.synthetic(cfg.prompt_numbers),
        proc=GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles)),
        device=torch.device("cpu"), compute_dtype=F32, generator=torch.Generator().manual_seed(0))


def test_load_checkpoint_directory(ckpt):
    from grasp_any_region_tpu.core.weights import flatten_params, load_checkpoint

    rt = trt.GARRuntime.load(ckpt, device="cpu")
    assert rt.compute_dtype == torch.bfloat16
    _, jparams = load_checkpoint(ckpt)
    want = flatten_params(jparams)
    got = {n.replace(".", "/"): p.detach() for n, p in rt.params.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():  # the checkpoint's leaves, each in the runtime's dtype
        torch.testing.assert_close(got[k], torch.from_numpy(np.asarray(v)).to(got[k].dtype),
                                   rtol=0, atol=0, msg=k)
    assert rt.cfg.text.hidden_size == 64  # the checkpoint's config, not the preset's


def test_load_int8_serving_captions(ckpt, capsys):
    rt = trt.GARRuntime.load(ckpt, int8_serving=True, device="cpu")
    assert "int8 serving-only weights" in capsys.readouterr().err
    names = {n for n, _ in rt.params.named_parameters()}
    assert "llm.blocks.wq_q8" in names and "llm.blocks.wq" not in names
    assert rt.params.llm.blocks.wq_q8.dtype == torch.int8
    texts, out = rt.answer(*rt.batch(_samples("one_region")), max_new_tokens=NEW)
    assert len(texts) == 1 and out.num_generated.tolist() == [NEW] and out.steps == NEW - 1
    assert rt.caption(_samples("one_region"), max_new_tokens=NEW) == texts


@pytest.mark.parametrize("kind", ["one_region", "two_regions"])
def test_caption_tokens_equal_jax_runtime(ckpt, kind, monkeypatch):
    from grasp_any_region_tpu.cli import runtime as jrt
    from grasp_any_region_tpu.models import gar as jg

    monkeypatch.setattr("grasp_any_region_tpu.core.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                        lambda *a, **k: None)
    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    outs = {"jax": [], "torch": []}
    monkeypatch.setattr(jmod, "gar_prefill",
                        functools.partial(jg.gar_prefill, compute_dtype=jnp.float32))
    monkeypatch.setattr(jmod, "gar_decode_step",
                        functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32))
    jgen = jax.jit(jmod.generate.__wrapped__,
                   static_argnames=("cfg", "max_new_tokens", "eot_id", "temperature"))
    monkeypatch.setattr(jmod, "generate",
                        lambda *a, **k: outs["jax"].append(jgen(*a, **k)) or outs["jax"][-1])
    real = trt.generate
    monkeypatch.setattr(trt, "generate",
                        lambda *a, **k: outs["torch"].append(real(*a, **k)) or outs["torch"][-1])

    samples = _samples(kind)
    want = jrt.GARRuntime.load(ckpt).caption(samples, max_new_tokens=NEW)
    rt = _fp32_runtime(ckpt)
    got = rt.caption(samples, max_new_tokens=NEW)
    (j,), (t,) = outs["jax"], outs["torch"]
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.num_generated.numpy(), np.asarray(j.num_generated))
    assert got == want
    assert len(set(t.tokens[0].tolist())) > 1
    assert rt.batch(samples)[1].tolist() == [1633 if kind == "one_region" else 1897]


def _png(path, array):
    from PIL import Image

    Image.fromarray(array).save(path)
    return str(path)


def _cli_inputs(tmp_path):
    rng = np.random.default_rng(7)
    imgs = [_png(tmp_path / f"img{i}.png", rng.integers(0, 256, (200, 300, 3), dtype=np.uint8))
            for i in range(2)]
    masks = [_png(tmp_path / f"m{i}.png", _mask(200, 300, 20 + 50 * i, 120 + 50 * i, 30, 200) * 255)
             for i in range(2)]
    return imgs, masks


BASE = ["--preset", "gar_tiny", "--random-init", "--max-new-tokens", "4", "--device", "cpu"]


@pytest.mark.parametrize("cli", ["gar_with_mask", "gar_relationship", "gar_video"])
def test_cli_output_equals_caption(tmp_path, capsys, cli):
    from grasp_any_region_tpu_torch.cli import gar_relationship, gar_video, gar_with_mask

    imgs, masks = _cli_inputs(tmp_path)
    rt = trt.GARRuntime.load(None, "gar_tiny", True, device="cpu")
    load_i, load_m = trt.load_image, trt.load_mask
    if cli == "gar_with_mask":
        gar_with_mask.main(BASE + sum((["--image", i, "--mask", m] for i, m in zip(imgs, masks)),
                                      []))
        texts = rt.caption([RegionSample(load_i(i), {1: load_m(m)}) for i, m in zip(imgs, masks)],
                           max_new_tokens=4)
        want = "".join(f"=== {i} ===\n{t}\n" for i, t in zip(imgs, texts))
    elif cli == "gar_relationship":
        q = "Is <Prompt0> above <Prompt1>?"
        gar_relationship.main(BASE + ["--image", imgs[0], "--mask", masks[0], "--mask", masks[1],
                                      "--question", q, "--mcq"])
        q += " Answer with the correct option's letter directly."
        want = rt.caption([RegionSample(load_i(imgs[0]), {0: load_m(masks[0]),
                                                          1: load_m(masks[1])}, question=q)],
                          max_new_tokens=4)[0] + "\n"
    else:
        gar_video.main(BASE + ["--frame", imgs[0], "--frame", imgs[1], "--mask", f"1:{masks[0]}",
                               "--question", "What moves?"])
        want = rt.caption_video([VideoRegionSample([load_i(i) for i in imgs], {1: load_m(masks[0])},
                                                   "What moves?")], max_new_tokens=4)[0] + "\n"
    out = capsys.readouterr().out
    assert out == want


@pytest.mark.parametrize("case", ["count", "spec_format", "spec_range", "spec_runs",
                                  "video_sources", "video_mask_spec"])
def test_cli_argument_errors(tmp_path, case, capsys):
    """The CLIs' argument checks; `--speculative 4,1` on one image runs
    and prints `caption(speculative=(4, 1))`'s text."""
    from grasp_any_region_tpu_torch.cli import gar_video, gar_with_mask

    imgs, masks = _cli_inputs(tmp_path)
    one = ["--image", imgs[0], "--mask", masks[0]]
    argv, error = {
        "count": (one + ["--image", imgs[1]], SystemExit),
        "spec_format": (one + ["--speculative", "2"], SystemExit),
        "spec_range": (one + ["--speculative", "0,1"], SystemExit),
        "spec_runs": (one + ["--speculative", "4,1"], None),
        "video_sources": (["--mask", f"0:{masks[0]}"], SystemExit),
        "video_mask_spec": (["--frame", imgs[0], "--mask", masks[0]], SystemExit),
    }[case]
    main = gar_video.main if case.startswith("video") else gar_with_mask.main
    if error is None:
        main(BASE + argv)
        rt = trt.GARRuntime.load(None, "gar_tiny", True, device="cpu")
        sample = RegionSample(trt.load_image(imgs[0]), {1: trt.load_mask(masks[0])})
        text = rt.caption([sample], max_new_tokens=4, speculative=(4, 1))[0]
        assert text == rt.caption([sample], max_new_tokens=4)[0]
        assert capsys.readouterr().out == f"=== {imgs[0]} ===\n{text}\n"
        return
    with pytest.raises(error) as info:
        main(BASE + argv)
    assert info.value.code == 2
    assert {"count": "--image given 2 times but --mask 1",
            "spec_format": "expects GAMMA,K integers",
            "spec_range": "must be >= 1",
            "video_sources": "exactly one of --frame",
            "video_mask_spec": "frame_idx:path"}[case] in capsys.readouterr().err


@pytest.mark.parametrize("eot_step", [None, 1, 33])
def test_generate_reports_the_steps_it_runs(monkeypatch, eot_step):
    """GenerationResult.steps equals the decode steps the loop ran: all of
    them without eot, else up to the first done-flag check after the step
    that ended the last row."""
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.models import generate as tgen

    cfg = gar_tiny()
    params = init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():  # scaled, so that greedy decoding does not repeat one token
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(params.llm.blocks, name).mul_(10.0)
    batch, _, plens = synthetic_batch(cfg, grid=(1, 1), device="cpu")
    n_new = 40
    free = tgen.generate(params, cfg, batch, plens, max_new_tokens=n_new, eot_id=-1).tokens[0]
    free = free.tolist()
    if eot_step is None:
        eot, want = -1, n_new - 1
    else:  # the first token at or after eot_step that the row has not emitted before
        k = next(i for i in range(eot_step, n_new) if free[i] not in free[:i])
        eot = free[k]
        check = max(tgen.EOT_CHECK_EVERY, -(-k // tgen.EOT_CHECK_EVERY) * tgen.EOT_CHECK_EVERY)
        want = min(n_new - 1, check)
    steps = []
    real = tgen.gar_decode_step
    monkeypatch.setattr(tgen, "gar_decode_step", lambda *a, **k: steps.append(1) or real(*a, **k))
    out = tgen.generate(params, cfg, batch, plens, max_new_tokens=n_new, eot_id=eot)
    assert len(steps) == want
    assert out.steps == len(steps)
