"""The PyTorch port's host data path against the JAX package's, on seeded
numpy images and masks: resizes, tile grids, the image processor, prompt
rasterization and questions, the chat template, the tokenizer and the
builders. Everything before the collate is numpy on both sides, so the
arrays must be equal bit for bit.

Both packages' `resize_bicubic` dispatch to the native C++ resize (JAX's
when its shared library is built, the port's always, built at first use),
which sums in another order than the numpy form. So every comparison runs
both numpy forms (`use_native=False`, or the native call patched to the
numpy body), and the port's native resize is held to JAX's numpy form at
JAX's own bound for native against numpy (1e-9, `tests/test_loader.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.data import builders as jb
from grasp_any_region_tpu.data import chat as jchat
from grasp_any_region_tpu.data import image_processor as jip
from grasp_any_region_tpu.data import prompts as jprompts
from grasp_any_region_tpu.data import resize as jresize
from grasp_any_region_tpu.data import tokenizer as jtok
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.data import builders as tb
from grasp_any_region_tpu_torch.data import chat as tchat
from grasp_any_region_tpu_torch.data import image_processor as tip
from grasp_any_region_tpu_torch.data import prompts as tprompts
from grasp_any_region_tpu_torch.data import resize as tresize
from grasp_any_region_tpu_torch.data import tokenizer as ttok
from grasp_any_region_tpu_torch.data.native import resize_bicubic_native as native_resize

BATCH_FIELDS = ("input_ids", "positions", "segment_ids", "pixel_values", "mask_values",
                "aspect_ratio", "bboxes", "replay_pos", "replay_valid", "num_tiles", "replay_tile")


def numpy_resize(img, out_h, out_w, antialias=True, n_threads=0):
    return tresize.resize_bicubic(img, out_h, out_w, antialias, use_native=False)


@pytest.fixture(autouse=True)
def jax_numpy_resize(monkeypatch):
    monkeypatch.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                        lambda *a, **k: None)
    monkeypatch.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                        numpy_resize)


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _mask(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


@pytest.mark.parametrize("src,dst,kind", [
    ((37, 53, 3), (448, 448), "uint8"),  # upsample
    ((500, 700, 3), (224, 300), "uint8"),  # antialiased downsample
    ((97, 131), (448, 448), "float"),  # 2D
    ((120, 90, 3), (60, 200), "noaa"),  # mixed, antialias off
])
def test_bicubic_and_nearest_equal_jax(rng, src, dst, kind):
    img = (rng.integers(0, 256, src).astype(np.uint8) if kind != "float"
           else (rng.random(src) * 255).astype(np.float32))
    aa = kind != "noaa"
    got = tresize.resize_bicubic(img, *dst, antialias=aa, use_native=False)
    want = jresize.resize_bicubic(img, *dst, antialias=aa, use_native=False)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    native = native_resize(img, *dst, antialias=aa)
    assert native.dtype == np.float64 and native.shape == want.shape
    np.testing.assert_allclose(native, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tresize.resize_nearest(img, *dst),
                                  jresize.resize_nearest(img, *dst))


def test_tile_grid_selection_equals_jax():
    for mnt in (1, 4, 8, 16, 36):
        assert tip.find_supported_aspect_ratios(mnt) == jip.find_supported_aspect_ratios(mnt)
    sizes = [(w, h) for w in (50, 300, 448, 700, 1000, 1792, 2500, 4000)
             for h in (60, 333, 448, 720, 1280, 1792, 3000)]
    for mnt in (1, 4, 8, 16):
        for w, h in sizes:
            assert tip.select_tile_grid(w, h, 448, mnt) == jip.select_tile_grid(w, h, 448, mnt), \
                (w, h, mnt)
    assert tip.select_tile_grid(1792, 1792, 448, 16) == (4, 4)


@pytest.mark.parametrize("case", ["uint8_prompt", "float_image", "gray_uint8"])
def test_preprocess_equals_jax(rng, case):
    h, w = 300, 500
    if case == "float_image":
        img = rng.random((h, w, 3)).astype(np.float32) * 255
    elif case == "gray_uint8":
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    else:
        img = _image(rng, h, w)
    vp = tprompts.rasterize_prompts({0: _mask(h, w, 10, 200, 40, 300)}, h, w, 5) \
        if case != "float_image" else None
    cfg = dict(max_num_tiles=4)
    got = tip.GARImageProcessor(tip.ImageProcessorConfig(**cfg)).preprocess(img, vp)
    want = jip.GARImageProcessor(jip.ImageProcessorConfig(**cfg)).preprocess(img, vp)
    assert set(got) == set(want)
    assert got["aspect_ratio"] == want["aspect_ratio"] and got["num_tiles"] == want["num_tiles"]
    for key in ("pixel_values", "mask_values"):
        if key in want:
            assert got[key].dtype == want[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])


def test_rasterize_bbox_and_questions_equal_jax():
    h, w = 64, 80
    masks = {0: _mask(h, w, 5, 30, 5, 40), 1: _mask(h, w, 20, 60, 30, 79), 7: _mask(h, w, 0, 5, 0, 5)}
    got = tprompts.rasterize_prompts(masks, h, w, 5)
    np.testing.assert_array_equal(got, jprompts.rasterize_prompts(masks, h, w, 5))
    assert got[25, 35] == 0  # first fill wins where masks 0 and 1 overlap
    assert got[2, 2] == 5  # prompt 7 is past the slots: background
    for m in list(masks.values()) + [np.zeros((h, w), np.uint8)]:
        assert tprompts.bbox_from_mask(m) == jprompts.bbox_from_mask(m)
    for pid, ins in ((1, "Describe this masked region in detail."), (3, "What is it?")):
        assert tprompts.single_region_question(pid, ins) == jprompts.single_region_question(pid, ins)
    q = "Is <Prompt2> left of <Prompt0>? And <Prompt2>?"
    assert tprompts.multi_region_question(q) == jprompts.multi_region_question(q)
    assert tprompts.multi_region_question(q)[1] == [2, 0]


def test_chat_template_labels_and_crop_runs_equal_jax():
    tt, jt = ttok.GARTokenizer.synthetic(), jtok.GARTokenizer.synthetic()
    text = "<|image|>" + tprompts.single_region_question(1)
    msgs = [("system", "Be brief."), ("user", text), ("assistant", "A cat.\n\nOn a mat.")]
    got = tchat.apply_chat_template(tt, [tchat.ChatMessage(r, c) for r, c in msgs],
                                    add_generation_prompt=True, num_tiles_per_image=[3])
    want = jchat.apply_chat_template(jt, [jchat.ChatMessage(r, c) for r, c in msgs],
                                     add_generation_prompt=True, num_tiles_per_image=[3])
    assert got == want
    assert got.count(jcfg.IMAGE_TOKEN_ID) == 3 * 256
    ids = np.asarray(got, np.int32)
    np.testing.assert_array_equal(tchat.mask_labels(ids), jchat.mask_labels(ids))
    assert tb.mask_labels is tchat.mask_labels  # still importable from the builders
    crops = tcfg.crop_token_ids(5)
    assert tchat.find_crop_runs(ids, crops) == jchat.find_crop_runs(ids, crops)
    assert tchat.find_crop_runs(ids, crops)[0][::2] == (1, 256)
    assert tchat.expand_image_tokens("a<|image|>b<|image|>", [1, 2], "<|image|>", 2) == \
        jchat.expand_image_tokens("a<|image|>b<|image|>", [1, 2], "<|image|>", 2)


def test_synthetic_tokenizer_round_trip():
    tt, jt = ttok.GARTokenizer.synthetic(), jtok.GARTokenizer.synthetic()
    text = ("<|begin_of_text|>user\n\nWhat is <Prompt1> — ümlaut?<|reserved_special_token_3|>"
            "<NO_Prompt>assistant<|eot_id|>")
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text
    assert tt.decode(ids, skip_special_tokens=True) == jt.decode(ids, skip_special_tokens=True)
    assert tt.convert_tokens_to_ids("<Prompt4>") == jcfg.BASE_VOCAB_SIZE + 4
    assert tt.convert_tokens_to_ids("<NO_Prompt>") == jcfg.BASE_VOCAB_SIZE + 5
    assert tt.vocab_size() == jt.vocab_size() and tt.eot_id == jcfg.EOT_TOKEN_ID
    with pytest.raises(KeyError):
        tt.convert_tokens_to_ids("cat")


def test_tokenizer_from_file(tmp_path):
    """A word-level tokenizer.json built here with the `tokenizers`
    package: the port's from_file encodes and decodes as JAX's does, the GAR
    prompt tokens included."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {w: i for i, w in enumerate(["[UNK]", "a", "cat", "on", "the", "mat", "?"])}
    backend = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    backend.pre_tokenizer = pre_tokenizers.Whitespace()
    backend.save(str(tmp_path / "tokenizer.json"))
    tt = ttok.GARTokenizer.from_file(str(tmp_path), prompt_numbers=3)
    jt = jtok.GARTokenizer.from_file(str(tmp_path / "tokenizer.json"), prompt_numbers=3)
    text = "a cat on the <Prompt1> mat ?"
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.convert_tokens_to_ids("mat") == 5
    assert tt.convert_tokens_to_ids("<Prompt1>") == jcfg.BASE_VOCAB_SIZE + 1


def _equal_batches(got, want):
    batch, plens = got
    jbatch, jplens = want
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jplens))
    for name in BATCH_FIELDS:
        g, w = getattr(batch, name), getattr(jbatch, name)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("case", ["one_region", "two_regions", "bbox_compat"])
def test_region_batch_equals_jax(rng, case):
    """build_region_batch's arrays equal JAX's bit for bit: two rows with
    grids of 1 and 2 tiles (and a thumbnail each; at most 2 tiles, so the
    bucket is 3) and different prompt lengths."""
    jc, tc = (dataclasses.replace(m.gar_tiny(), max_num_tiles=2) for m in (jcfg, tcfg))
    samples = []
    for h, w in ((300, 300), (300, 520)):
        img = _image(rng, h, w)
        if case == "one_region":
            samples.append(dict(image=img, masks={1: _mask(h, w, 20, 120, 30, 200)},
                                instruction="What is this?"))
        else:
            samples.append(dict(image=img, masks={0: _mask(h, w, 20, 120, 30, 200),
                                                  1: _mask(h, w, 150, 290, 100, 280)},
                                question="How does <Prompt1> relate to <Prompt0>?"))
    kw = dict(reference_bbox_compat=True) if case == "bbox_compat" else {}
    tt, jt = ttok.GARTokenizer.synthetic(), jtok.GARTokenizer.synthetic()
    tp, jp = (m.GARImageProcessor(m.ImageProcessorConfig(max_num_tiles=2)) for m in (tip, jip))
    built = [tb.build_sample(tc, tt, tp, tb.RegionSample(**s), **kw) for s in samples]
    jbuilt = [jb.build_sample(jc, jt, jp, jb.RegionSample(**s), **kw) for s in samples]
    got = tb.collate_samples(tc, built, with_labels=True, device="cpu")
    want = jb.collate_samples(jc, jbuilt, with_labels=True)
    _equal_batches(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].replay_tile is None
    assert [int(n) for n in got[0].num_tiles] == [2, 3]
    regions = 1 if case == "one_region" else 2
    assert got[0].replay_valid.sum(dim=1).tolist() == [regions, regions]
    if case == "bbox_compat":  # every box from the last mask
        assert torch.equal(got[0].bboxes[:, 0], got[0].bboxes[:, 1])
    if case == "one_region":
        _equal_batches(tb.build_region_batch(tc, tt, tp, [tb.RegionSample(**samples[0])],
                                             device="cpu"),
                       jb.build_region_batch(jc, jt, jp, [jb.RegionSample(**samples[0])]))


def test_video_batch_equals_jax(rng):
    """build_video_batch's arrays equal JAX's, replay_tile included: 4
    frames of 72 x 128, masks on frames 0 and 2."""
    jc, tc = jcfg.gar_tiny(), tcfg.gar_tiny()
    frames = [_image(rng, 72, 128) for _ in range(4)]
    masks = {0: _mask(72, 128, 10, 40, 20, 90), 2: _mask(72, 128, 30, 70, 5, 60)}
    tp, jp = (m.GARImageProcessor(m.ImageProcessorConfig(max_num_tiles=4)) for m in (tip, jip))
    got = tb.build_video_batch(tc, ttok.GARTokenizer.synthetic(), tp,
                               [tb.VideoRegionSample(frames, masks, "What happens?")],
                               device="cpu")
    want = jb.build_video_batch(jc, jtok.GARTokenizer.synthetic(), jp,
                                [jb.VideoRegionSample(frames, masks, "What happens?")])
    _equal_batches(got, want)
    assert got[0].replay_tile[0, :2].tolist() == [0, 2]
    assert int((got[0].input_ids == tc.video_token_id).sum()) == 4 * 256


def test_gar_1b_sample_shape():
    """The gar_1b sample the card's runtime phase runs: a 1792 x 1792 image
    tiles 4 x 4 plus a thumbnail, 17 tiles, and its prompt is 4705 tokens;
    with two regions and a <Prompt0> / <Prompt1> question, 4969."""
    rng = np.random.default_rng(0)
    cfg = tcfg.gar_1b()
    img = _image(rng, 1792, 1792)
    m0, m1 = _mask(1792, 1792, 200, 900, 300, 1200), _mask(1792, 1792, 1000, 1700, 100, 800)
    tok = ttok.GARTokenizer.synthetic()
    proc = tip.GARImageProcessor(tip.ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles))
    one = tb.build_sample(cfg, tok, proc, tb.RegionSample(img, {1: m0}))
    assert one["num_tiles"] == 17 and one["pixel_values"].shape == (17, 3, 448, 448)
    assert len(one["input_ids"]) == 4705 and tuple(one["aspect_ratio"]) == (4, 4)
    two = tb.build_sample(cfg, tok, proc, tb.RegionSample(
        img, {0: m0, 1: m1}, question="What is the relation between <Prompt0> and <Prompt1>?"))
    assert len(two["input_ids"]) == 4969 and len(two["replay_pos"]) == 2
