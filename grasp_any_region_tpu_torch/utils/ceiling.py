"""The card's reachable rates, the denominators of a roofline
(`tools/mxu_ceiling.py`'s counterpart): the bf16 matrix product and the
device-to-device copy.

  * matmul: `steps` dependent products y <- y @ w of (dim, dim) bf16
    matrices (each consumes the one before, so none can be skipped)
    between two CUDA events, the best of `iters` runs; 2 dim^3 operations
    a product. It times cuBLAS on purpose: it measures the card, not a
    port of a kernel.
  * copy: `steps` copies of a buffer of `copy_mib` MiB into another, the
    best of `iters` runs; each copy reads the buffer once and writes it
    once.

  python -m grasp_any_region_tpu_torch.utils.ceiling [--dim 4096] [--steps 64] \\
      [--iters 5] [--copy-mib 1024] [--device cuda]

It runs on the card unless asked for the CPU (`--device cpu`), where the
host clock times the same work: a figure of the CPU, not of the card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

from ..core.weights import require_device


def _elapsed_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Milliseconds of fn(): CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def matmul_rate(dim: int = 4096, steps: int = 64, iters: int = 5, device="cuda") -> dict:
    """{"tflops", "ms" (the best run of `steps` products), ...} of the bf16
    product chain."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(dim, dim, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(dim, dim, generator=gen, device=device) / dim ** 0.5).to(torch.bfloat16)

    def chain():
        y = x
        for _ in range(steps):
            y = y @ w
        return y

    chain()  # warm-up: the library's first call picks its kernel
    ms = min(_elapsed_ms(chain, device) for _ in range(iters))
    return dict(dim=dim, steps=steps, ms=ms, tflops=2 * dim ** 3 * steps / (ms * 1e-3) / 1e12,
                device=_device_name(device))


def copy_rate(copy_mib: int = 1024, steps: int = 20, iters: int = 5, device="cuda") -> dict:
    """{"gbps", "ms" (the best run of `steps` copies), ...}: bytes read
    plus bytes written over the time."""
    device = require_device(device)
    n = copy_mib * 2 ** 20
    src = torch.ones(n, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)

    def copies():
        for _ in range(steps):
            dst.copy_(src)

    copies()
    ms = min(_elapsed_ms(copies, device) for _ in range(iters))
    return dict(mib=copy_mib, steps=steps, ms=ms, gbps=2 * n * steps / (ms * 1e-3) / 1e9,
                device=_device_name(device))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--copy-mib", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu times "
                                                    "the CPU)")
    args = p.parse_args(argv)
    mm = matmul_rate(args.dim, args.steps, args.iters, args.device)
    cp = copy_rate(args.copy_mib, iters=args.iters, device=args.device)
    print(f"[ceiling] {mm['device']}: {mm['steps']} x ({mm['dim']}^2 @ {mm['dim']}^2) bf16 in "
          f"{mm['ms']:.3f} ms -> {mm['tflops']:.1f} TFLOP/s; {cp['steps']} copies of "
          f"{cp['mib']} MiB in {cp['ms']:.3f} ms -> {cp['gbps']:.1f} GB/s (read + write)")
    out = dict(matmul=mm, copy=cp)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
