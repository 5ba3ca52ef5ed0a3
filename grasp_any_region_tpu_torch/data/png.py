"""A PNG reader and writer on the standard library's zlib and numpy, so the
training data path needs no image package for PNG files (the JAX package
reads and writes them through PIL).

Reads 8-bit, non-interlaced gray, gray + alpha, RGB and RGBA images with
any of the five row filters (None, Sub, Up, Average, Paeth), checking every
chunk's CRC; anything else raises ValueError. Writes gray, RGB and RGBA
with one filter for every row. None, Sub and Up rows unfilter in numpy a
row at a time; Average and Paeth rows, whose bytes depend on the bytes
just reconstructed to their left, in a Python loop over the row.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
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


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) for gray, (H, W, C) otherwise (C = 2, 3 or 4)."""
    if not is_png(data):
        raise ValueError("not a PNG file (bad signature)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: only 8-bit non-interlaced gray, gray + alpha, RGB "
                         "and RGBA are read here")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {height * (stride + 1)}")
    pixels = _unfilter(raw, height, stride, bpp).reshape(height, width, bpp)
    return pixels[:, :, 0] if bpp == 1 else pixels


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """A read image as (H, W, 3) uint8, as PIL's convert("RGB") gives it:
    gray replicates, alpha is dropped."""
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    c = pixels.shape[2]
    if c in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


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
