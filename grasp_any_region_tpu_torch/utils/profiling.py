"""Tracing and profiling on torch (`grasp_any_region_tpu/utils/profiling.py`'s
four names):

  * `trace(logdir)`: a context manager around `torch.profiler.profile`
    (CPU and, where the card is, CUDA activities) that writes a Chrome
    trace (Perfetto, chrome://tracing) into `logdir` on exit and hands the
    profile to the body, whose `key_averages()` ranks the kernels
  * `annotate(name)`: `torch.profiler.record_function`, a named region
    inside a trace
  * `PhaseTimer`: host-side named-phase wall timing with p50 / p95
    summaries (JAX's, copied)
  * `device_memory_stats()`: allocated bytes now and at peak, and the
    device's limit, per visible CUDA device

`trace_kernels(path)` reads a written trace back: each device kernel with
its duration and the `annotate` ranges its launch fell in.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the body; its Chrome trace lands in
    `logdir/trace_<pid>_<ns>.json` on exit, named by the profile's
    `trace_file`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_file = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_file)


def annotate(name: str):
    return torch.profiler.record_function(name)


class PhaseTimer:
    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for name, xs in self._samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1000),
                "p50_ms": float(np.percentile(arr, 50) * 1000),
                "p95_ms": float(np.percentile(arr, 95) * 1000),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<20} {'count':>6} {'mean':>9} {'p50':>9} {'p95':>9}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:<20} {s['count']:>6} {s['mean_ms']:>8.1f}ms "
                f"{s['p50_ms']:>8.1f}ms {s['p95_ms']:>8.1f}ms"
            )
        return "\n".join(lines)


def device_memory_stats() -> List[dict]:
    """One dict a visible CUDA device: its name, the bytes the caching
    allocator holds in tensors now and at peak, and the device's total
    memory; [] on a machine without CUDA."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        })
    return out


def trace_kernels(path: str) -> List[dict]:
    """The device kernels of a Chrome trace that `trace` wrote, in the order
    they ran: {"name", "us" (the kernel's duration), "ranges" (the names of
    the `annotate` ranges that hold its launch call on the host, outermost
    first)}. A kernel is tied to its launch by the trace's correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = []
    for e in sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        t = launches.get(e.get("args", {}).get("correlation"))
        out.append({"name": e["name"], "us": float(e.get("dur", 0.0)),
                    "ranges": [] if t is None else
                    [r["name"] for r in ranges if r["ts"] <= t <= r["ts"] + r.get("dur", 0.0)]})
    return out
