"""Build the CUDA kernels in ../csrc at first use and bind them with ctypes.

Each `.cu` file is compiled by its own nvcc, for sm_90a, all of them at
once, and the objects are linked into one shared library with a plain C
interface: no PyTorch headers, so the build takes seconds.
The library lands in `build/torch_kernels/<hash>/` at the repository root
(git ignores it). The hash covers the sources, the flags and the nvcc path,
so an edited source is rebuilt and a stale library is never loaded.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "gar_vit_attention": [_P] * 5 + [_I] * 4 + [_L] * 12 + [_F, _P],
    "gar_flash_attention": [_P] * 7 + [_I] * 7 + [_L] * 12 + [_F, _P],
    "gar_flash_bwd_prep": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_P],
    "gar_flash_bwd_dq_cast": [_P] * 2 + [_L, _F, _P],
    "gar_flash_bwd_dkv": [_P] * 12 + [_I] * 7 + [_LP, _F, _P],
    "gar_decode_attention_fused": [_P] * 8 + [_I] * 8 + [_F, _P],
    "gar_decode_attention_fused_q8": [_P] * 10 + [_I] * 8 + [_F, _P],
    "gar_decode_attention": [_P] * 7 + [_I] * 9 + [_F, _P],
    "gar_layer_norm": [_P] * 4 + [_I] * 5 + [_F, _P],
    "gar_vit_attention_fused_qkv": [_P] * 4 + [_I] * 4 + [_F, _P],
    "gar_vit_ln_qkv": [_P] * 7 + [_I] * 3 + [_F, _P],
    "gar_vit_wo_residual": [_P] * 6 + [_I] * 2 + [_P],
    "gar_vit_mlp_residual": [_P] * 11 + [_I] * 3 + [_F, _I, _P],
    "gar_vit_gemm": [_I] + [_P] * 6 + [_I] * 3 + [_P],
    "gar_layer_matmul": [_P] * 3 + [_I] * 6 + [_P],
    "gar_layer_swiglu": [_P] * 4 + [_I] * 6 + [_P],
    "gar_layer_qkv": [_P] * 7 + [_I] * 7 + [_P],
    "gar_layer_matmul_q8": [_P] * 4 + [_I] * 6 + [_P],
    "gar_layer_swiglu_q8": [_P] * 6 + [_I] * 6 + [_P],
    "gar_layer_qkv_q8": [_P] * 10 + [_I] * 7 + [_P],
    "gar_qkv_norm_rope": [_P] * 12 + [_I] * 9 + [_F, _P],
    "gar_qkv_norm_rope_q8": [_P] * 15 + [_I] * 9 + [_F, _P],
    "gar_mlp_residual": [_P] * 8 + [_I] * 6 + [_F, _P],
    "gar_mlp_residual_q8": [_P] * 11 + [_I] * 6 + [_F, _P],
    "gar_mlp_max_clusters": [_I] * 4,
    "gar_decode_attention_wo": [_P] * 13 + [_I] * 11 + [_F, _P],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (library path, seconds spent compiling: 0.0 when cached). The
    compiler's output (registers, shared memory, spills per kernel) is kept
    beside the library in build.log."""
    nvcc = nvcc_path()
    out_dir = BUILD_ROOT / _build_key(nvcc)
    lib = out_dir / "libgar_kernels.so"
    if lib.is_file():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
    tmp = out_dir / f"libgar_kernels.{tag}.so"
    if all(rc == 0 for _, _, rc in logs):
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(("link", res.stdout + res.stderr, res.returncode))
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("".join(f"== {name}\n{out}" for name, out, _ in logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(name, out, rc) for name, out, rc in logs if rc != 0]
    if failed:
        name, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{out[-8000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def check_operand(x: torch.Tensor, name: str) -> None:
    """Raise unless x is a bfloat16 tensor the attention kernels can read
    through strides: contiguous head dim, 16-byte aligned rows."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"{name}: head dim must be contiguous and other strides "
                         f"multiples of 8 elements, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def strides_arg(*tensors: torch.Tensor):
    """The (batch, sequence, head) element strides of each tensor, as one
    C array of long long for the entry points that take a stride table."""
    vals = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def stream_handle(device: torch.device) -> int:
    """The current stream of a CUDA device, as the raw handle. Read the way
    torch's compiled kernels read it: `torch.cuda.current_stream` builds a
    Stream object per call, which the decode step would pay 80 times."""
    return torch._C._cuda_getCurrentRawStream(device.index)
