"""ctypes binding of the native host library: the COCO RLE codec
(`native/rle.cc`) and the bicubic resampler (`native/resize.cc`), the one
loader behind JAX's `data/rle_native.py` and `data/resize_native.py`, under
their function names.

The library is built from the repository's own sources at first use, with
`g++ -O3 -shared -fPIC -std=c++17 -pthread` (as `native/build.sh` builds
it), into `build/torch_kernels/native/<hash>/libgar_native.so` at the
repository root (git ignores it). The hash covers the sources, the flags
and the compiler's path, so an edited source is rebuilt. The JAX package's
`native/libgar_native.so` is never written or read here.

Where JAX's loader falls back to numpy without a word when the build fails,
this one raises with the compiler's output: a caller that asked for the
native path gets it or an error.

ctypes releases the interpreter lock for the length of each call, so the
prefetch loader's worker threads (`data/loader.py`) decode and resize in
parallel with each other and with the device step.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCES = (REPO / "native" / "rle.cc", REPO / "native" / "resize.cc")
BUILD_ROOT = REPO / "build" / "torch_kernels" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LL = ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_DP = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rle_decode_counts": (_LL, [ctypes.c_char_p, _LL, _LLP, _LL]),
    "rle_runs_to_mask": (ctypes.c_int, [_LLP, _LL, _LL, _LL, _U8P]),
    "rle_mask_to_runs": (_LL, [_U8P, _LL, _LL, _LLP, _LL]),
    "gar_resize_bicubic": (None, [_DP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _DP,
                                  ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]),
}


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native host library needs a C++ compiler: no g++ on PATH "
                           "(or set CXX)")
    return cxx


def library_path() -> Path:
    """Where the library for the current sources, flags and compiler lands."""
    cxx = _compiler()
    h = hashlib.sha256(cxx.encode() + " ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libgar_native.so"


def build() -> tuple[Path, float]:
    """Compile the library unless an up-to-date one exists; raise with the
    compiler's output when the build fails. Returns (library path, seconds
    spent compiling: 0.0 when cached), as `ops/_build.build()` does."""
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libgar_native.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    res = subprocess.run([_compiler(), *FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native host library failed ({res.returncode}):\n"
                           f"{res.stderr[-8000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0


_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded library, built on first call: once, though the loader's
    worker threads may all ask for it at the same moment."""
    with _LOCK:
        return _loaded()


@functools.lru_cache(maxsize=None)
def _loaded() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def decode_rle_native(rle: Dict) -> Optional[np.ndarray]:
    """COCO RLE dict with compressed counts -> (H, W) uint8 mask; None when
    the counts are already a list of runs (nothing to accelerate)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    if not isinstance(counts, (bytes, bytearray)):
        return None
    lib = library()
    buf = bytes(counts)
    runs = np.zeros(len(buf) + 2, np.int64)
    m = lib.rle_decode_counts(buf, len(buf), runs.ctypes.data_as(_LLP), len(runs))
    if m < 0:
        raise ValueError(f"native counts decode failed ({m})")
    mask = np.zeros((h, w), np.uint8)
    if lib.rle_runs_to_mask(runs.ctypes.data_as(_LLP), m, h, w, mask.ctypes.data_as(_U8P)):
        raise ValueError("native RLE expansion failed: runs do not cover h*w")
    return mask


def encode_runs_native(mask: np.ndarray) -> np.ndarray:
    """(H, W) binary mask -> int64 runs in COCO's column-major order,
    starting with the 0-run."""
    m8 = np.ascontiguousarray(mask, np.uint8)
    if m8.ndim != 2:
        raise ValueError(f"a mask is 2-D, got shape {m8.shape}")
    h, w = m8.shape
    out = np.zeros(h * w + 2, np.int64)
    m = library().rle_mask_to_runs(m8.ctypes.data_as(_U8P), h, w, out.ctypes.data_as(_LLP),
                                   len(out))
    if m < 0:
        raise ValueError("native RLE encode overflow")
    return out[:m]


def resize_bicubic_native(img: np.ndarray, out_h: int, out_w: int, antialias: bool = True,
                          n_threads: int = 0) -> np.ndarray:
    """(H, W[, C]) any dtype -> (out_h, out_w[, C]) float64: the arithmetic
    of `data/resize.resize_bicubic`'s numpy body, summed in another order
    (within 1e-9 of it on 0-255 images). n_threads 0: one a core, at most 8."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    src = np.ascontiguousarray(img, np.float64)
    out = np.empty((out_h, out_w, c), np.float64)
    library().gar_resize_bicubic(src.ctypes.data_as(_DP), h, w, c, out.ctypes.data_as(_DP),
                                 out_h, out_w, 1 if antialias else 0, n_threads)
    return out[:, :, 0] if squeeze else out
