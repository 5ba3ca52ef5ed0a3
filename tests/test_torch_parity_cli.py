"""The port's `cli/parity.py` and `cli/warmup.py` at gar_tiny on the CPU:
`activation_checksums` against JAX's on the same checkpoint and demo pair
(both at fp32: JAX's vision_embed, vision_forward and build_prefill_embeds
patched from bf16; the mask goes through the patch embed as bf16 on both
sides, as JAX's does), shapes equal and mean / std / abs_sum within 1e-4
relative; the tap loop against `vision_forward`; the exit codes 2 (no
assets), 1 (the demo caption differs) and 0 (the expected caption patched
to the greedy one), `--dump-checksums`; the helpers against JAX's; and the
warmup on the CPU.

The checkpoint is tests/test_torch_runtime.py's (`ckpt`, `_fp32_runtime`).
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.cli import parity as jparity
from grasp_any_region_tpu_torch.cli import parity as tparity
from grasp_any_region_tpu_torch.data.png import write_png
from tests.test_torch_runtime import _fp32_runtime, ckpt, port_numpy_resize  # noqa: F401

REL = 1e-4


def _demo(rng):
    image = rng.integers(0, 256, (210, 300, 3), dtype=np.uint8)
    mask = np.zeros((210, 300), np.uint8)
    mask[40:150, 60:240] = 1
    return image, mask


@pytest.fixture
def numpy_resizes(monkeypatch):
    monkeypatch.setattr("grasp_any_region_tpu.core.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                        lambda *a, **k: None)
    monkeypatch.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                        port_numpy_resize)


def _close(got: float, want: float, scale: float, name: str):
    assert abs(got - want) <= REL * max(abs(want), scale), (name, got, want)


def test_activation_checksums_equal_jax(ckpt, numpy_resizes, monkeypatch):  # noqa: F811
    from grasp_any_region_tpu.cli.runtime import GARRuntime as JRuntime
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu.models import vision as jv

    f32 = dict(compute_dtype=jnp.float32)
    monkeypatch.setattr(jv, "vision_embed", functools.partial(jv.vision_embed, **f32))
    monkeypatch.setattr(jv, "vision_forward", functools.partial(jv.vision_forward, **f32))
    monkeypatch.setattr(jg, "build_prefill_embeds", functools.partial(jg.build_prefill_embeds,
                                                                      **f32))
    image, mask = _demo(np.random.default_rng(0))
    want = jparity.activation_checksums(JRuntime.load(ckpt), image, mask)
    got = tparity.activation_checksums(_fp32_runtime(ckpt), image, mask)
    assert list(got) == list(want)
    assert {"vision_block0", "vision_block1", "decoder_final"} <= set(got)
    for name, w in want.items():
        g = got[name]
        assert g["shape"] == w["shape"], name
        # the mean of an activation can sit near 0: its error is held to the spread
        _close(g["mean"], w["mean"], w["std"], name)
        _close(g["std"], w["std"], 0.0, name)
        _close(g["abs_sum"], w["abs_sum"], 0.0, name)
        assert np.isfinite([g["mean"], g["std"], g["abs_sum"]]).all()


def test_tap_loop_is_the_forward(ckpt, numpy_resizes):  # noqa: F811
    """Replaying the blocks one by one, as the taps do, then ln_post gives
    `vision_forward`'s output: the bisection path is the production path."""
    from grasp_any_region_tpu_torch.data.builders import RegionSample
    from grasp_any_region_tpu_torch.models.gar import decode_mask_values, mask_patch_embed
    from grasp_any_region_tpu_torch.models.vision import _block, vision_embed, vision_forward
    from grasp_any_region_tpu_torch.ops.norms import layer_norm

    rt = _fp32_runtime(ckpt)
    image, mask = _demo(np.random.default_rng(1))
    batch, _ = rt.batch([RegionSample(image, {1: mask}, instruction="Describe.")])
    pix = batch.pixel_values.flatten(0, 1)
    binary = decode_mask_values(rt.cfg, batch.mask_values.flatten(0, 1))
    vp = rt.params.vision
    with torch.no_grad():
        membeds = mask_patch_embed(rt.params, rt.cfg, binary)
        x, angles = vision_embed(vp, rt.cfg.vision, pix, membeds, compute_dtype=torch.float32)
        for i, bp in enumerate(vp.blocks.layers()):
            x = _block(rt.cfg.vision, x, bp, None if angles is None else angles[i])
        if rt.cfg.vision.use_ln_post:
            x = layer_norm(x, vp.ln_post.scale, vp.ln_post.bias)
        ref = vision_forward(vp, rt.cfg.vision, pix, membeds, compute_dtype=torch.float32)
    torch.testing.assert_close(x, ref, rtol=1e-5, atol=1e-5)


def test_helpers_equal_jax():
    for text in ("A **bold**  frog<|eot_id|>\n", "  x  ", ""):
        assert tparity._norm(text) == jparity._norm(text)
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    assert tparity.checksum(torch.from_numpy(x)) == jparity.checksum(jnp.asarray(x))
    assert tparity.checksum(torch.from_numpy(x).bfloat16()) == \
        jparity.checksum(jnp.asarray(x).astype(jnp.bfloat16))
    got, exp = {"0": "a b", "1": "c", "2": "z"}, {"0": "a  b", "1": "d", "3": "q"}
    assert tparity._exact_match_report("r", got, exp) == jparity._exact_match_report("r", got, exp)
    assert tparity._exact_match_report("r", {}, exp)["ok"] is False
    assert tparity.EXPECTED_DEMO_CAPTION == jparity.EXPECTED_DEMO_CAPTION
    assert tparity.DEMO_INSTRUCTION == jparity.DEMO_INSTRUCTION


def _demo_files(tmp_path):
    image, mask = _demo(np.random.default_rng(3))
    (tmp_path / "demo.png").write_bytes(write_png(image))
    (tmp_path / "mask.png").write_bytes(write_png(mask * 255))
    return ["--demo-image", str(tmp_path / "demo.png"), "--demo-mask", str(tmp_path / "mask.png")]


BASE = ["--device", "cpu", "--max-new-tokens", "6", "--speculative", "2,1"]


def test_parity_exit_2_without_assets(ckpt, tmp_path, capsys):  # noqa: F811
    rc = tparity.main(["--model-path", ckpt, "--reference-root", str(tmp_path)] + BASE)
    assert rc == 2
    assert json.loads(capsys.readouterr().out) == {"results": []}


def test_parity_exit_1_on_a_caption_mismatch(ckpt, tmp_path, capsys):  # noqa: F811
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime, load_image, load_mask

    dump = tmp_path / "taps.json"
    rc = tparity.main(["--model-path", ckpt, "--reference-root", str(tmp_path),
                       "--dump-checksums", str(dump)] + _demo_files(tmp_path) + BASE)
    out = capsys.readouterr()
    assert rc == 1
    results = {r["check"]: r for r in json.loads(out.out)["results"]}
    assert list(results) == ["demo_caption", "demo_caption_int8", "speculative"]
    assert results["demo_caption"]["ok"] is False
    assert results["speculative"]["ok"] is True
    assert results["speculative"]["gamma"] == 2 and results["speculative"]["draft_layers"] == 1
    assert "[parity] tap vision_block0" in out.err
    taps = json.loads(dump.read_text())
    rt = GARRuntime.load(ckpt, device="cpu")
    want = tparity.activation_checksums(rt, load_image(str(tmp_path / "demo.png")),
                                        load_mask(str(tmp_path / "mask.png")))
    assert taps == json.loads(json.dumps(want))


def test_parity_exit_0_when_the_caption_matches(ckpt, tmp_path, capsys, monkeypatch):  # noqa: F811
    """With the expected caption set to the greedy one, every check that
    runs matches (the int8 repeat skipped: int8 weights change the text)."""
    argv = ["--model-path", ckpt, "--reference-root", str(tmp_path),
            "--skip-int8"] + _demo_files(tmp_path) + BASE
    assert tparity.main(argv) == 1
    got = json.loads(capsys.readouterr().out)["results"][0]["got"]
    monkeypatch.setattr(tparity, "EXPECTED_DEMO_CAPTION", got)
    assert tparity.main(argv) == 0
    results = json.loads(capsys.readouterr().out)["results"]
    assert [r["check"] for r in results] == ["demo_caption", "speculative"]
    assert all(r["ok"] for r in results)


def test_warmup_on_the_cpu(capsys):
    """`cli.warmup.main` at gar_tiny on the CPU: no CUDA build, the native
    host library built (or cached), one first caption per grid and length."""
    from grasp_any_region_tpu_torch.cli import warmup

    figures = warmup.main(["--preset", "gar_tiny", "--grids", "1x1,2x1", "--max-new-tokens",
                           "3,5"], device="cpu")
    err = capsys.readouterr().err
    assert figures["kernels_s"] is None and "CUDA kernels: not built" in err
    assert figures["native_s"] >= 0.0 and "native host library: built in" in err
    assert sorted(figures["captions"]) == ["1x1/3", "1x1/5", "2x1/3", "2x1/5"]
    assert err.count("first caption in") == 4
    with pytest.raises(ValueError):
        warmup._grid("4")
