"""A PNG reader and writer on the standard library's zlib and numpy, so the
port reads and writes PNG files with no image package (the JAX package
reads and writes them through PIL; the CUDA machine has no PIL).

Reads non-interlaced gray (bit depth 1, 2, 4, 8 or 16), gray + alpha, RGB
and RGBA (8 or 16), and palette images (1, 2, 4 or 8) with any of the five
row filters (None, Sub, Up, Average, Paeth), checking every chunk's CRC;
anything else raises ValueError. What `read_png` hands over is what PIL
opens: gray of 8 bits or fewer scaled to 0-255, 16-bit gray as uint16 (PIL's
"I;16"), the other 16-bit images by their high bytes, palette images
through the palette (RGBA when a tRNS chunk gives alpha). `to_rgb` and
`to_gray` then convert as PIL's convert("RGB") and convert("L") do, and
`decode_image` reads any file's bytes so (other formats through PIL, which
is imported only for them). Writes gray, RGB and RGBA with one filter for
every row. None, Sub and Up rows unfilter in numpy a row at a time; Average
and Paeth rows, whose bytes depend on the bytes just reconstructed to their
left, in a Python loop over the row.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type written


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _paeth_row(f: List[int], prior: List[int], bpp: int) -> List[int]:
    out = f[:]
    for x in range(len(f)):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (f[x] + pred) & 0xFF
    return out


def _average_row(f: List[int], prior: List[int], bpp: int) -> List[int]:
    out = f[:]
    for x in range(len(f)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (f[x] + ((a + prior[x]) >> 1)) & 0xFF
    return out


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, f = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            row = f
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            row = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = f + prior
        elif kind == 3:
            row = np.array(_average_row(f.tolist(), prior.tolist(), bpp), np.uint8)
        elif kind == 4:
            row = np.array(_paeth_row(f.tolist(), prior.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(H, stride) bytes of 1, 2 or 4-bit samples, most significant first
    -> (H, width) uint8 sample values."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # per byte, left to right
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the pixels PIL opens: uint8 (H, W) for gray (uint16 at
    16 bits), (H, W, C) otherwise (C = 2, 3 or 4; palette images as RGB or,
    with a tRNS chunk, RGBA)."""
    if not is_png(data):
        raise ValueError("not a PNG file (bad signature)")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _DEPTHS or depth not in _DEPTHS[colour] or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: only non-interlaced gray (1-16 bits), gray + alpha, "
                         "RGB, RGBA (8 or 16) and palette (1-8) images are read here")
    if colour == 3 and palette is None:
        raise ValueError("palette PNG has no PLTE chunk")
    channels = _CHANNELS[colour]
    bpp = max(1, channels * depth // 8)  # the filters' byte distance
    stride = (width * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {height * (stride + 1)}")
    rows = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        wide = rows.view(">u2").reshape(height, width, channels)
        if channels == 1:
            return wide[:, :, 0].astype(np.uint16)
        return (wide >> 8).astype(np.uint8)
    if depth < 8:
        samples = _unpack_bits(rows, depth, width)
        if colour == 0:  # PIL's "1", "L;2", "L;4": scaled to 0-255
            return samples * np.uint8(255 // ((1 << depth) - 1))
        pixels = samples[:, :, None]
    else:
        pixels = rows.reshape(height, width, channels)
    if colour == 3:
        idx = pixels[:, :, 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"PNG palette index {int(idx.max())} past its {len(palette)} "
                             "entries")
        if trns is None:
            return palette[idx]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(palette)]
        return np.concatenate([palette[idx], alpha[idx][:, :, None]], axis=2)
    return pixels[:, :, 0] if channels == 1 else pixels


def _eight_bit(pixels: np.ndarray) -> np.ndarray:
    """16-bit gray as PIL converts "I;16" to 8 bits: values past 255 clip."""
    return np.minimum(pixels, 255).astype(np.uint8) if pixels.dtype == np.uint16 else pixels


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """A read image as (H, W, 3) uint8, as PIL's convert("RGB") gives it:
    gray replicates, alpha is dropped."""
    pixels = _eight_bit(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    c = pixels.shape[2]
    if c in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def to_gray(pixels: np.ndarray) -> np.ndarray:
    """A read image as (H, W) uint8, as PIL's convert("L") gives it: gray as
    it is, alpha dropped, RGB as (R 19595 + G 38470 + B 7471 + 0x8000) >> 16."""
    pixels = _eight_bit(pixels)
    if pixels.ndim == 2:
        return pixels
    if pixels.shape[2] in (1, 2):
        return np.ascontiguousarray(pixels[:, :, 0])
    rgb = pixels[:, :, :3].astype(np.uint32)
    return ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470 + rgb[:, :, 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _pil_decode(raw: bytes, mode: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this image is not a PNG: reading other formats needs PIL (the "
                          "pillow package), which is not installed") from e
    return np.asarray(Image.open(io.BytesIO(raw)).convert(mode))


def decode_image(raw: bytes, mode: str = "RGB") -> np.ndarray:
    """An image file's bytes as PIL's convert(mode) gives them: "RGB" (H, W,
    3) or "L" (H, W) uint8. PNGs decode here; other formats need PIL."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode is RGB or L, got {mode!r}")
    if is_png(raw):
        pixels = read_png(raw)
        return to_rgb(pixels) if mode == "RGB" else to_gray(pixels)
    return _pil_decode(raw, mode)


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file as `decode_image` gives it."""
    with open(path, "rb") as f:
        return decode_image(f.read(), mode)


def _filter(x: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """The filtered bytes of every row of x (H, stride) as int16 (mod 256
    on the way out)."""
    x = x.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        return x
    if kind == 1:
        return x - left
    if kind == 2:
        return x - up
    if kind == 3:
        return x - (left + up) // 2
    if kind == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        return x - pred
    raise ValueError(f"PNG filter type {kind}: 0-4")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(image: np.ndarray, filter_type: int = 1) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes, every
    row under `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG pixels are uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"an image is (H, W), (H, W, 3) or (H, W, 4), got {image.shape}")
    height, width, bpp = img.shape
    rows = (_filter(img.reshape(height, width * bpp), filter_type, bpp) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((height, 1), filter_type, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[bpp], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
