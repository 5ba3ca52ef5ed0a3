"""The port's `utils/profiling.py`: `PhaseTimer` gives JAX's summary and
report on the same records; `trace` on the CPU writes a Chrome trace file
holding the `annotate` regions and hands the profile to its body;
`device_memory_stats()` is [] on a machine without CUDA, as JAX's is
without devices."""

import json
import time

import numpy as np
import pytest
import torch

from grasp_any_region_tpu.utils import profiling as jprof
from grasp_any_region_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("records", [
    {"prefill": [0.031, 0.029, 0.5], "decode": [0.0125] * 7},
    {"one": [1.0]},
    {"host": list(np.random.default_rng(0).random(101) * 0.4), "x": [0.0, 2.5e-4]},
])
def test_phase_timer_summary_and_report_equal_jax(records):
    t, j = tprof.PhaseTimer(), jprof.PhaseTimer()
    for name, xs in records.items():
        for x in xs:
            t.record(name, x)
            j.record(name, x)
    assert t.summary() == j.summary()
    assert t.report() == j.report()
    assert list(t.summary()) == list(records)
    assert t.summary()[next(iter(records))]["count"] == len(next(iter(records.values())))


def test_phase_timer_phase_times_the_body():
    t = tprof.PhaseTimer()
    with t.phase("sleep"):
        time.sleep(0.01)
    with pytest.raises(ZeroDivisionError):
        with t.phase("sleep"):
            1 / 0  # noqa: B018 - the phase still records
    s = t.summary()["sleep"]
    assert s["count"] == 2 and s["total_s"] >= 0.01


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "logs")) as prof:
        with tprof.annotate("vision"):
            y = x @ x
        with tprof.annotate("decode"):
            y = torch.relu(y) + 1
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"vision", "decode"} <= names
    assert any("mm" in str(n) for n in names)
    keys = {k.key for k in prof.key_averages()}
    assert {"vision", "decode"} <= keys
    assert float(y.sum()) > 0
    assert prof.trace_file == str(files[0])
    assert tprof.trace_kernels(prof.trace_file) == []  # no device here


def test_trace_kernels_ties_kernels_to_their_ranges(tmp_path):
    """A hand-written trace in the profiler's layout: each kernel takes the
    ranges that hold its launch (by correlation id), not its own time."""
    events = [
        {"cat": "user_annotation", "name": "prefill", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "vision", "ts": 10, "dur": 40},
        {"cat": "user_annotation", "name": "decode", "ts": 200, "dur": 100},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 60,
         "args": {"correlation": 2}},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 250, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "k_vision", "ts": 150, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k_prefill", "ts": 190, "dur": 5, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k_decode", "ts": 260, "dur": 2.5, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "k_lost", "ts": 400, "dur": 1, "args": {"correlation": 9}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tprof.trace_kernels(str(path)) == [
        {"name": "k_vision", "us": 30.0, "ranges": ["prefill", "vision"]},
        {"name": "k_prefill", "us": 5.0, "ranges": ["prefill"]},
        {"name": "k_decode", "us": 2.5, "ranges": ["decode"]},
        {"name": "k_lost", "us": 1.0, "ranges": []},
    ]


def test_device_memory_stats_without_cuda():
    """[] here (no CUDA); one dict a device where there is one."""
    stats = tprof.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == []
    else:
        assert len(stats) == torch.cuda.device_count()
        assert {"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(stats[0])
