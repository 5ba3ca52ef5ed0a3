"""The port's image-file loaders without PIL: `cli/runtime.load_image` /
`load_mask`, `serve/server.decode_image` / `decode_mask` / `png_b64` read
and write PNGs through `data/png.py`, bit-equal to PIL's convert("RGB") and
convert("L") for RGB, RGBA, gray (1, 2, 4, 8 and 16 bits), gray + alpha,
16-bit RGB / RGBA / gray + alpha and palette files (with and without a
tRNS chunk, 4 and 8 bits). With PIL hidden, `gar_with_mask` captions PNG
files at gar_tiny on the CPU as `caption` does the same arrays.
"""

import base64
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from grasp_any_region_tpu_torch.cli import runtime as trt
from grasp_any_region_tpu_torch.data import png
from grasp_any_region_tpu_torch.serve import server


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _raw_png(width, height, depth, colour, rows, extra=b"") -> bytes:
    """A PNG of the given rows' bytes, every row under filter None."""
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    raw = b"".join(b"\x00" + r for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pack(samples: np.ndarray, depth: int) -> list:
    """(H, W) samples of 1, 2 or 4 bits -> packed row bytes, first sample
    in the high bits."""
    per = 8 // depth
    h, w = samples.shape
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = samples
    rows = []
    for r in padded:
        b = np.zeros(len(r) // per, np.uint8)
        for k in range(per):
            b |= r[k::per] << (8 - depth * (k + 1))
        rows.append(b.tobytes())
    return rows


def _pil_png(array, mode=None) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array, mode).save(buf, format="PNG")
    return buf.getvalue()


def _file(kind: str, rng) -> bytes:
    """A PNG of `kind`, 13 x 7 (odd, so packed rows end mid-byte)."""
    h, w = 7, 13
    if kind in ("rgb", "rgba", "l", "la"):
        c = {"rgb": 3, "rgba": 4, "l": 1, "la": 2}[kind]
        a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        return _pil_png(a[:, :, 0] if c == 1 else a, {"la": "LA"}.get(kind))
    if kind == "p_pil":  # PIL's own palette file
        return _pil_p(rng, h, w)
    if kind == "i16_pil":  # PIL's own 16-bit gray file, values on both sides of 255
        return _pil_png(rng.integers(0, 700, (h, w)).astype(np.uint16))
    if kind.startswith("gray"):
        depth = int(kind[4:])
        if depth == 16:
            a = rng.integers(0, 600, (h, w)).astype(">u2")
            return _raw_png(w, h, 16, 0, [r.tobytes() for r in a])
        s = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
        return _raw_png(w, h, depth, 0, _pack(s, depth) if depth < 8 else [r.tobytes() for r in s])
    if kind in ("rgb16", "rgba16", "la16"):
        c = {"rgb16": 3, "rgba16": 4, "la16": 2}[kind]
        colour = {3: 2, 4: 6, 2: 4}[c]
        a = rng.integers(0, 65536, (h, w, c)).astype(">u2")
        return _raw_png(w, h, 16, colour, [r.tobytes() for r in a])
    if kind.startswith("palette"):  # palette8, palette4, palette8_trns
        depth = 4 if kind == "palette4" else 8
        n = 16 if depth == 4 else 200
        pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        idx = rng.integers(0, n, (h, w)).astype(np.uint8)
        extra = _chunk(b"PLTE", pal.tobytes())
        if kind.endswith("trns"):
            extra += _chunk(b"tRNS", rng.integers(0, 256, 50).astype(np.uint8).tobytes())
        rows = _pack(idx, depth) if depth < 8 else [r.tobytes() for r in idx]
        return _raw_png(w, h, depth, 3, rows, extra)
    raise ValueError(kind)


def _pil_p(rng, h, w) -> bytes:
    im = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(37)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


KINDS = ["rgb", "rgba", "l", "la", "p_pil", "i16_pil", "gray1", "gray2", "gray4", "gray8",
         "gray16", "rgb16", "rgba16", "la16", "palette8", "palette4", "palette8_trns"]


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("kind", KINDS)
def test_loaders_equal_pil(tmp_path, kind):
    """load_image / load_mask and the server's decoders give PIL's
    convert("RGB") and convert("L") (> 127) bit for bit."""
    data = _file(kind, np.random.default_rng(KINDS.index(kind)))
    assert png.is_png(data)
    pil = Image.open(io.BytesIO(data))
    want_rgb = np.asarray(pil.convert("RGB"))
    want_l = np.asarray(pil.convert("L"))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(trt.load_image(str(path)), want_rgb)
    np.testing.assert_array_equal(trt.load_mask(str(path)), (want_l > 127).astype(np.uint8))
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(server.decode_image(b64), want_rgb)
    np.testing.assert_array_equal(server.decode_image(b64, "L"), want_l)
    np.testing.assert_array_equal(server.decode_mask(b64), (want_l > 127).astype(np.uint8))
    assert trt.load_image(str(path)).dtype == np.uint8


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_b64_decodes_in_pil_to_the_array(mode):
    rng = np.random.default_rng(3)
    shape = {"L": (9, 11), "RGB": (9, 11, 3), "RGBA": (9, 11, 4)}[mode]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    out = Image.open(io.BytesIO(base64.b64decode(server.png_b64(arr, mode))))
    assert out.mode == mode
    np.testing.assert_array_equal(np.asarray(out), arr)
    with pytest.raises(ValueError, match="PNG of an array"):
        server.png_b64(arr, "RGBA" if mode != "RGBA" else "L")


def test_to_gray_is_pils_rgb_to_l_on_every_colour_bucket():
    """The RGB -> L rounding on 4096 colours spread over the cube."""
    v = np.arange(0, 256, 17, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 16, 3)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(png.to_gray(rgb), want)
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 7, np.uint8)], axis=2)
    np.testing.assert_array_equal(png.to_gray(rgba), np.asarray(Image.fromarray(rgba).convert("L")))


def test_other_formats_need_pil(tmp_path, monkeypatch):
    """A JPEG loads through PIL; without PIL the loader names what is
    missing, and a PNG still loads."""
    jpeg = tmp_path / "x.jpg"
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(jpeg)
    assert trt.load_image(str(jpeg)).shape == (8, 8, 3)
    assert trt.load_mask(str(jpeg)).shape == (8, 8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        trt.load_image(str(jpeg))
    with pytest.raises(ImportError, match="needs PIL"):
        server.decode_mask(base64.b64encode(jpeg.read_bytes()).decode())
    p = tmp_path / "x.png"
    p.write_bytes(png.write_png(np.full((4, 6, 3), 200, np.uint8)))
    np.testing.assert_array_equal(trt.load_mask(str(p)), np.ones((4, 6), np.uint8))


def test_gar_with_mask_reads_png_files_without_pil(tmp_path, capsys, monkeypatch):
    """`gar_with_mask.main` at gar_tiny on the CPU with PIL hidden: the
    printed caption equals `caption` on the arrays the files hold."""
    from grasp_any_region_tpu_torch.cli import gar_with_mask
    from grasp_any_region_tpu_torch.data.builders import RegionSample

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (120, 180, 3), dtype=np.uint8)
    mask = np.zeros((120, 180), np.uint8)
    mask[20:90, 30:140] = 1
    (tmp_path / "img.png").write_bytes(png.write_png(img, filter_type=4))
    (tmp_path / "m.png").write_bytes(png.write_png(mask * 255))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    gar_with_mask.main(["--preset", "gar_tiny", "--random-init", "--max-new-tokens", "4",
                        "--device", "cpu", "--image", str(tmp_path / "img.png"),
                        "--mask", str(tmp_path / "m.png")])
    rt = trt.GARRuntime.load(None, "gar_tiny", True, device="cpu")
    text = rt.caption([RegionSample(img, {1: mask})], max_new_tokens=4)[0]
    assert capsys.readouterr().out == f"=== {tmp_path / 'img.png'} ===\n{text}\n"
