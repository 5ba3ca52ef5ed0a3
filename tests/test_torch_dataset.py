"""The port's training data path against the JAX package's, on seeded numpy
inputs: the RLE codec (native and numpy), the native resize, the
instruction augmentation, the PNG codec, the synthetic annotation writer,
the dataset's `build_item`, its refetch and length grouping, and the
prefetch loader.

JAX's dataset decodes masks and resizes through its native library when it
is built (and builds it into `native/` when it is not), so here its loader
is patched to report no library: JAX runs its numpy forms. Where arrays
must be equal bit for bit, the port's native resize is patched to its
numpy body; RLE decode is exact either way. The native forms are held to
the numpy ones on their own: RLE bit for bit, the resize at JAX's bound
for native against numpy (1e-9 on 0-255 images, `tests/test_loader.py`).
"""

import base64
import dataclasses
import io
import json
import os
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.data import dataset as jds
from grasp_any_region_tpu.data import image_processor as jip
from grasp_any_region_tpu.data import prompts as jprompts
from grasp_any_region_tpu.data import resize as jresize
from grasp_any_region_tpu.data import rle as jrle
from grasp_any_region_tpu.data import synthetic as jsyn
from grasp_any_region_tpu.data import tokenizer as jtok
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.data import dataset as tds
from grasp_any_region_tpu_torch.data import image_processor as tip
from grasp_any_region_tpu_torch.data import native
from grasp_any_region_tpu_torch.data import png
from grasp_any_region_tpu_torch.data import prompts as tprompts
from grasp_any_region_tpu_torch.data import resize as tresize
from grasp_any_region_tpu_torch.data import rle as trle
from grasp_any_region_tpu_torch.data import synthetic as tsyn
from grasp_any_region_tpu_torch.data import tokenizer as ttok
from grasp_any_region_tpu_torch.data.loader import PrefetchLoader

ITEM_FIELDS = ("input_ids", "pixel_values", "mask_values", "aspect_ratio", "bboxes",
               "replay_pos", "num_tiles")


def port_numpy_resize(img, out_h, out_w, antialias=True, n_threads=0):
    return tresize.resize_bicubic(img, out_h, out_w, antialias, use_native=False)


@pytest.fixture
def numpy_forms(monkeypatch):
    """JAX without its native library; the port's resize as its numpy body."""
    monkeypatch.setattr("grasp_any_region_tpu.data.rle_native._load", lambda: None)
    monkeypatch.setattr("grasp_any_region_tpu.data.resize_native._load", lambda: None)
    monkeypatch.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                        port_numpy_resize)


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


# ---------------------------------------------------------------------------
# the native library and the RLE codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 47), (97, 211), (256, 199)])
@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "box"])
def test_rle_equals_jax_native_and_numpy(rng, numpy_forms, shape, kind):
    """encode_rle gives JAX's compressed count string byte for byte, native
    and numpy; every decode (native, numpy, JAX) gives the mask back; the
    uncompressed runs, the area and decode_any agree too."""
    h, w = shape
    m = {"random": (rng.random(shape) > 0.35), "zeros": np.zeros(shape),
         "ones": np.ones(shape), "box": _box(h, w, h // 4, h // 2 + 1, w // 3, w)}[kind]
    m = m.astype(np.uint8)
    want = jrle.encode_rle(m)
    for use_native in (True, False):
        got = trle.encode_rle(m, use_native=use_native)
        assert isinstance(got["counts"], bytes) and got == want, use_native
        assert trle.encode_rle(m, compress=False, use_native=use_native) == \
            jrle.encode_rle(m, compress=False)
    np.testing.assert_array_equal(native.encode_runs_native(m), jrle._decode_counts(want["counts"]))
    as_text = {"size": want["size"], "counts": want["counts"].decode()}
    for rle in (want, as_text, jrle.encode_rle(m, compress=False)):
        np.testing.assert_array_equal(trle.decode_rle(rle), m)
        np.testing.assert_array_equal(trle.decode_rle(rle, use_native=False), m)
        np.testing.assert_array_equal(jrle.decode_rle(rle, use_native=False), m)
    assert trle.rle_area(want) == jrle.rle_area(want) == int(m.sum())
    got = trle.decode_any([want, as_text])
    assert len(got) == 2 and all(np.array_equal(g, m) for g in got)


def test_rle_refuses_runs_that_miss_the_mask():
    short = {"size": [3, 2], "counts": [1, 2]}
    with pytest.raises(ValueError, match="covers 3 pixels"):
        trle.decode_rle(short)
    bad = jrle.encode_rle(_box(4, 4, 0, 2, 0, 2))
    bad = {"size": [5, 4], "counts": bad["counts"]}
    with pytest.raises(ValueError, match="do not cover"):
        trle.decode_rle(bad)


def test_polygons_equal_jax():
    polys = [[10, 10, 60, 12, 40, 50], [5, 5, 20, 5, 20, 20, 5, 20], [1, 1, 2, 2]]
    for seg in (polys, polys[:1]):
        np.testing.assert_array_equal(trle.polygon_to_mask(seg, 64, 80),
                                      jrle.polygon_to_mask(seg, 64, 80))
        np.testing.assert_array_equal(trle.segmentation_to_mask(seg, 64, 80),
                                      jrle.segmentation_to_mask(seg, 64, 80))
    rle = jrle.encode_rle(_box(30, 20, 3, 9, 4, 11))
    np.testing.assert_array_equal(trle.segmentation_to_mask(rle, 30, 20), _box(30, 20, 3, 9, 4, 11))


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape,out", [((37, 53, 3), (448, 448)), ((300, 200, 3), (64, 48)),
                                       ((100, 100), (224, 336)), ((500, 700, 3), (224, 300))])
def test_native_resize_within_jax_bound(rng, shape, out, antialias):
    """The port's resize_bicubic (native by default) against JAX's numpy
    form at JAX's bound for native against numpy."""
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    want = jresize.resize_bicubic(img, *out, antialias=antialias, use_native=False)
    got = tresize.resize_bicubic(img, *out, antialias=antialias)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tresize.resize_bicubic(img, *out, antialias=antialias,
                                                         use_native=False), want)


@pytest.mark.parametrize("case", ["uint8_prompt", "float_image", "gray_uint8"])
def test_native_preprocess_within_jax_bound(rng, case):
    """`data/image_processor.py` reaches the native resize through
    resize_bicubic's default: its arrays against JAX's numpy path within
    1e-6 (a few fp32 ulps at the normalized values' size of 1: the native
    sums may round the fp32 cast the other way)."""
    h, w = 300, 500
    if case == "float_image":
        img = rng.random((h, w, 3)).astype(np.float32) * 255
    elif case == "gray_uint8":
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    else:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    vp = tprompts.rasterize_prompts({0: _box(h, w, 10, 200, 40, 300)}, h, w, 5)
    calls = []
    real = native.resize_bicubic_native

    def counted(*a, **k):
        calls.append(a[1:3])
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("grasp_any_region_tpu.data.rle_native._load", lambda: None)
        mp.setattr("grasp_any_region_tpu.data.resize_native._load", lambda: None)
        mp.setattr(native, "resize_bicubic_native", counted)
        got = tip.GARImageProcessor(tip.ImageProcessorConfig(max_num_tiles=4)).preprocess(img, vp)
        want = jip.GARImageProcessor(jip.ImageProcessorConfig(max_num_tiles=4)).preprocess(img, vp)
    assert len(calls) == 2  # the thumbnail and the canvas
    for key in ("pixel_values", "mask_values"):
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)


def test_native_library_lands_in_build_and_never_in_native(tmp_path, monkeypatch):
    """The library builds into build/torch_kernels/native/<hash>/ (here a
    fresh root, so the compiler runs); the JAX package's
    native/libgar_native.so keeps its mtime, or stays absent."""
    jax_lib = native.REPO / "native" / "libgar_native.so"
    before = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    real = native.library_path()
    assert real.parent.parent == native.REPO / "build" / "torch_kernels" / "native"
    assert real.name == "libgar_native.so"
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    built, seconds = native.build()
    assert built.parent.parent == tmp_path / "native" and built.is_file() and seconds > 0
    assert built.parent.name == real.parent.name  # the same sources, flags, compiler
    assert sorted(p.name for p in built.parent.iterdir()) == ["libgar_native.so"]
    assert native.build() == (built, 0.0)  # cached: no second compile
    native.library()  # the library the codecs use
    after = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    assert after == before


def test_native_library_builds_once_when_threads_race(tmp_path, monkeypatch):
    """The loader's worker threads may all ask for the library at once (a
    fresh checkout, the first batch): one build, one library for all."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    builds, real = [], native.build
    monkeypatch.setattr(native, "build", lambda: builds.append(1) or real())
    libs = [None] * 12
    switch = sys.getswitchinterval()
    native._loaded.cache_clear()
    try:
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=lambda k=k: libs.__setitem__(k, native.library()))
                   for k in range(len(libs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        native._loaded.cache_clear()  # the next caller loads the real build again
    assert len(builds) == 1 and all(lib is libs[0] for lib in libs)


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """Where JAX's loader falls back to numpy without a word, the port's
    build raises with the compiler's stderr."""
    broken = tmp_path / "broken.cc"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "out")
    with pytest.raises(RuntimeError, match="building the native host library failed") as err:
        native.build()
    assert "broken.cc" in str(err.value)
    assert not list((tmp_path / "out").rglob("*.so"))


# ---------------------------------------------------------------------------
# prompts and the PNG codec
# ---------------------------------------------------------------------------

def test_augment_instruction_equals_jax():
    """The same strings and the same draws from the generator, over many
    answers and seeds (all three branches and every instruction)."""
    answers = ["a red box.", "Two dogs! One cat? A bird.", "", "no stop at all",
               "a. b. c. d."]
    seen = set()
    for seed in range(60):
        tg, jg = np.random.default_rng(seed), np.random.default_rng(seed)
        for a in answers:
            got = tprompts.augment_instruction(tg, a)
            assert got == jprompts.augment_instruction(jg, a)
            seen.add(got.split(" Answer")[0])
        assert tg.random() == jg.random()  # the generators moved alike
    assert seen == set(jprompts.CAPTION_INSTRUCTIONS)
    assert tprompts.CAPTION_INSTRUCTIONS == jprompts.CAPTION_INSTRUCTIONS
    assert tprompts.negative_prompt_answer(3) == "<Prompt3> is not in the image."


def _filters(data: bytes) -> set:
    """The row filter types a PNG file uses."""
    header = [b for k, b in png._chunks(data) if k == b"IHDR"][0]
    w, h, _, colour, _, _, _ = struct.unpack(">IIBBBBB", header)
    raw = zlib.decompress(b"".join(b for k, b in png._chunks(data) if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    return set(rows[:, 0].tolist())


def _structured(rng, c):
    """An image whose rows suit different filters: noise, a ramp, repeated
    rows, a diagonal and a product pattern."""
    h, w = 40, 64
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, c), np.uint8)
    img[0:8] = rng.integers(0, 256, (8, w, c))
    img[8:16] = (xx[8:16, :, None] * 3) % 256
    img[16:24] = img[15:16]
    img[24:32] = ((xx[24:32, :, None] + yy[24:32, :, None]) * 5) % 256
    img[32:40] = (xx[32:40, :, None] * yy[32:40, :, None]) % 256
    return img[:, :, 0] if c == 1 else img


@pytest.mark.parametrize("mode,c", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_png_reads_pil_written_files(rng, mode, c):
    """PIL's adaptive filtering picks None, Sub, Up and Paeth rows here;
    the reader gives PIL's pixels bit for bit, and to_rgb gives PIL's
    convert("RGB")."""
    img = _structured(rng, c)
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    data = buf.getvalue()
    assert _filters(data) >= {0, 1, 2, 4}
    pil = Image.open(io.BytesIO(data))
    got = png.read_png(data)
    assert got.dtype == np.uint8 and got.shape == np.asarray(pil).shape
    np.testing.assert_array_equal(got, np.asarray(pil))
    np.testing.assert_array_equal(png.to_rgb(got), np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_every_filter_round_trips_and_reads_in_pil(rng, filter_type, c):
    """The writer under each of the five filters: PIL decodes its file to
    the image, and so does the reader (Average rows only come this way:
    PIL's encoder never picks them here)."""
    img = _structured(rng, c)
    data = png.write_png(img, filter_type)
    assert _filters(data) == {filter_type}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(png.read_png(data), img)


def test_png_refuses_what_it_does_not_read():
    img = np.zeros((4, 5, 3), np.uint8)
    data = bytearray(png.write_png(img))
    data[-20] ^= 0xFF  # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(bytes(data))
    header = struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 1)  # Adam7 interlaced RGB
    interlaced = (png.SIGNATURE + png._chunk(b"IHDR", header)
                  + png._chunk(b"IDAT", zlib.compress(b"")) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlace 1"):
        png.read_png(interlaced)
    with pytest.raises(ValueError, match="signature"):
        png.read_png(b"GIF89a....")
    with pytest.raises(TypeError):
        png.write_png(img.astype(np.float32))


# ---------------------------------------------------------------------------
# annotation files and the dataset
# ---------------------------------------------------------------------------

def _pil_b64(img) -> str:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:base64," + base64.b64encode(buf.getvalue()).decode()


def _pil_image(entry):
    raw = base64.b64decode(entry[len("data:base64,"):])
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def test_synthetic_annotation_files_decode_equal(tmp_path):
    """The port's and JAX's writers, from one seed: the same conversations
    and RLE strings, and images that decode to the same pixels (the port's
    PNG through its reader, JAX's through it and through PIL)."""
    kw = dict(n_items=7, image_size=(64, 48), seed=11)
    tpath = tsyn.write_synthetic_annotations(str(tmp_path / "t.json"), **kw)
    jpath = jsyn.write_synthetic_annotations(str(tmp_path / "j.json"), **kw)
    with open(tpath) as f:
        titems = json.load(f)
    with open(jpath) as f:
        jitems = json.load(f)
    assert len(titems) == len(jitems) == 7
    for t, j in zip(titems, jitems):
        assert set(t) == set(j)
        assert t["conversations"] == j["conversations"]
        assert t.get("mask_rle") == j.get("mask_rle")
        for rle in t.get("mask_rle", []):
            np.testing.assert_array_equal(trle.decode_rle(rle),
                                          jrle.decode_rle(rle, use_native=False))
        pixels = tds.load_image(t["image"])
        assert pixels.shape == (48, 64, 3)
        np.testing.assert_array_equal(pixels, tds.load_image(j["image"]))
        np.testing.assert_array_equal(pixels, _pil_image(j["image"]))
        np.testing.assert_array_equal(pixels, _pil_image(t["image"]))


def _three_styles_file(path, rng):
    """Items of the three styles (`tests/test_train_pipeline.py`'s fixture),
    with a PNG path for one image and a JPEG for another."""
    w, h = 200, 150
    m1, m2 = _box(h, w, 10, 60, 20, 100), _box(h, w, 80, 140, 50, 180)
    rles = [{"size": r["size"], "counts": r["counts"].decode()}
            for r in (jrle.encode_rle(m1), jrle.encode_rle(m2))]
    noise = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(4)]
    png_path = str(path.parent / "img.png")
    Image.fromarray(noise[3]).save(png_path)
    jpeg = io.BytesIO()
    Image.fromarray(noise[2]).save(jpeg, format="JPEG")
    items = [
        {"image": _pil_b64(noise[0]), "mask_rle": rles,
         "conversations": [{"from": "human", "value": "placeholder"},
                           {"from": "gpt", "value": "a red box."},
                           {"from": "human", "value": "placeholder"},
                           {"from": "gpt", "value": "a blue box. It is large."}]},
        {"image": _pil_b64(noise[1]), "mask_rle": rles,
         "conversations": [{"from": "human", "value": "Is <Prompt0> above <Prompt1>?"},
                           {"from": "gpt", "value": "Yes."}]},
        {"image": "data:base64," + base64.b64encode(jpeg.getvalue()).decode(),
         "conversations": [{"from": "human", "value": "placeholder"},
                           {"from": "gpt", "value": "an image of noise."}]},
        {"image": png_path, "mask_rle": rles[0],
         "conversations": [{"from": "human", "value": "placeholder"},
                           {"from": "gpt", "value": "a red box!"}]},
    ]
    path.write_text(json.dumps(items))
    return str(path)


def _datasets(path, **ds_kw):
    jc = dataclasses.replace(jcfg.gar_tiny(), max_num_tiles=2)
    tc = dataclasses.replace(tcfg.gar_tiny(), max_num_tiles=2)
    j = jds.GraspAnyRegionDataset(jc, jtok.GARTokenizer.synthetic(jc.prompt_numbers),
                                  jds.DatasetConfig(annotation_paths=[path], **ds_kw))
    t = tds.GraspAnyRegionDataset(tc, ttok.GARTokenizer.synthetic(tc.prompt_numbers),
                                  tds.DatasetConfig(annotation_paths=[path], **ds_kw))
    return j, t


def _equal_items(got, want, where):
    assert set(got) == set(want), where
    for key in ITEM_FIELDS:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, key)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {key}")


@pytest.mark.parametrize("source,ds_kw", [
    ("jax_written", {}),
    ("three_styles", dict(negative_prob=1.0)),  # every spare slot takes a negative turn
    ("three_styles", dict(prompt_augmentation=False, repeat_time=2)),
])
def test_build_item_equals_jax(tmp_path, rng, numpy_forms, source, ds_kw):
    """Every item of a JAX-written synthetic file, and of a file of the
    three styles (base64 PNGs, a PNG path, a JPEG through PIL), field by
    field; `__getitem__` and `modality_lengths` too."""
    if source == "jax_written":
        path = jsyn.write_synthetic_annotations(str(tmp_path / "ann.json"), n_items=6,
                                                image_size=(96, 80), seed=3)
    else:
        path = _three_styles_file(tmp_path / "ann.json", rng)
    jset, tset = _datasets(path, **ds_kw)
    assert len(tset) == len(jset) and tset.modality_lengths() == jset.modality_lengths()
    for i in range(len(tset)):
        _equal_items(tset.build_item(i), jset.build_item(i), f"item {i}")
    for i in (0, len(tset) - 1):
        _equal_items(tset[i], jset[i], f"getitem {i}")


def test_refetch_takes_jax_replacement_and_gives_up_loudly(tmp_path, rng, numpy_forms):
    """An item whose image cannot be read is replaced by the item JAX's
    refetch picks; with every item bad, the bounded refetch raises."""
    path = _three_styles_file(tmp_path / "ann.json", rng)
    items = json.loads(open(path).read())
    items[1]["image"] = "data:base64," + base64.b64encode(b"not an image").decode()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(items))
    jset, tset = _datasets(str(bad))
    with pytest.raises(Exception):
        tset.build_item(1)
    _equal_items(tset[1], jset[1], "refetched")
    for it in items:
        it["image"] = items[1]["image"]
    bad.write_text(json.dumps(items))
    _, tset = _datasets(str(bad), max_refetch=3)
    with pytest.raises(RuntimeError, match="exhausted refetch budget"):
        tset[0]


def test_length_grouped_indices_equal_jax():
    for n, bs, seed in ((7, 1, 0), (130, 2, 1), (401, 4, 2), (1, 3, 3)):
        lengths = np.random.default_rng(seed).integers(10, 5000, n).tolist()
        got = tds.length_grouped_indices(lengths, bs, np.random.default_rng([seed, 5]))
        want = jds.length_grouped_indices(lengths, bs, np.random.default_rng([seed, 5]))
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(n))


def test_pil_formats_need_pil(monkeypatch):
    """A JPEG needs PIL: without it the dataset names what is missing; a
    PNG needs nothing."""
    jpeg = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg, format="JPEG")
    entry = "data:base64," + base64.b64encode(jpeg.getvalue()).decode()
    assert tds.load_image(entry).shape == (8, 8, 3)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        tds.load_image(entry)
    png_entry = "data:base64," + base64.b64encode(png.write_png(np.ones((3, 4), np.uint8))).decode()
    np.testing.assert_array_equal(tds.load_image(png_entry), np.ones((3, 4, 3), np.uint8))


# ---------------------------------------------------------------------------
# the prefetch loader (`tests/test_loader.py`'s cases)
# ---------------------------------------------------------------------------

class _FakeDataset:
    """Records which thread built each item; uneven build cost."""

    def __init__(self):
        self.threads = set()
        self.lock = threading.Lock()

    def __getitem__(self, i):
        if i % 3 == 0:
            time.sleep(0.01)
        with self.lock:
            self.threads.add(threading.get_ident())
        return {"i": i, "v": i * 10}


def test_prefetch_loader_order_and_content():
    ds = _FakeDataset()
    loader = PrefetchLoader(ds, [5, 3, 8, 1, 0, 9, 2], batch_size=3,
                            collate_fn=lambda xs: [x["i"] for x in xs], num_workers=3,
                            prefetch_batches=2)
    assert len(loader) == 3
    assert list(loader) == [[5, 3, 8], [1, 0, 9], [2]]
    assert len(ds.threads) >= 2  # the workers ran in parallel


def test_prefetch_loader_drop_last():
    loader = PrefetchLoader(_FakeDataset(), range(7), batch_size=3, collate_fn=list,
                            num_workers=2, drop_last=True)
    assert len(loader) == 2
    assert sum(1 for _ in loader) == 2
    with pytest.raises(ValueError):
        PrefetchLoader(_FakeDataset(), range(7), batch_size=0, collate_fn=list)


def test_prefetch_loader_propagates_errors():
    class Boom:
        def __getitem__(self, i):
            if i == 4:
                raise ValueError("bad sample")
            return i

    it = iter(PrefetchLoader(Boom(), range(6), batch_size=2, collate_fn=list, num_workers=2))
    assert next(it) == [0, 1]
    assert next(it) == [2, 3]
    with pytest.raises(ValueError, match="bad sample"):
        next(it)


def test_native_calls_run_in_parallel_threads(rng):
    """ctypes releases the interpreter lock: four threads resizing at once
    give the same arrays as one thread does."""
    imgs = [rng.integers(0, 256, (300, 400, 3)).astype(np.uint8) for _ in range(4)]
    want = [native.resize_bicubic_native(im, 448, 448, n_threads=1) for im in imgs]
    out = [None] * 4

    def work(k):
        out[k] = native.resize_bicubic_native(imgs[k], 448, 448, n_threads=1)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got, w)
    assert os.path.isfile(native.library_path())
