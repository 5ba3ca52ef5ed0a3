"""Guards of the PyTorch port: it never imports jax (the CUDA machine has
none), chip_smoke.py fails, printing no result, where it cannot run, and
the serving engine refuses, before anything runs, what it cannot serve."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import grasp_any_region_tpu_torch

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        grasp_any_region_tpu_torch.__path__, "grasp_any_region_tpu_torch."))
    assert "grasp_any_region_tpu_torch.models.generate" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'grasp_any_region_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (here), and in a directory that holds chip_smoke.py and
    nothing else of the repo, the script exits non-zero and prints no
    result line."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_port_module_list_covers_serving():
    names = {m.name for m in pkgutil.walk_packages(grasp_any_region_tpu_torch.__path__,
                                                  "grasp_any_region_tpu_torch.")}
    assert {"grasp_any_region_tpu_torch.serve.engine", "grasp_any_region_tpu_torch.serve.paged_cache",
            "grasp_any_region_tpu_torch.ops.paged_attention"} <= names


def _tiny_engine_parts():
    import torch

    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.serve import EngineConfig

    cfg = gar_tiny()
    params = init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch, _, plens = synthetic_batch(cfg, grid=(1, 1), device="cpu")
    ecfg = EngineConfig(slots=3, page_size=16, num_pages=64, max_pages_per_slot=64,
                        max_new_tokens=8, eot_id=-1)
    return cfg, params, batch, int(plens[0]), ecfg


def test_engine_refuses_tensors_of_another_device():
    """Params or a request on another device than the engine's raise before
    anything runs (the meta device stands in for the card here); an engine
    for the card raises where there is none."""
    import dataclasses

    import torch

    from grasp_any_region_tpu_torch.models.gar import GARParams
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, batch, plen, ecfg = _tiny_engine_parts()
    with pytest.raises(ValueError, match=r"runs on cpu, but params are on \['meta'\]"):
        ContinuousBatchingEngine(GARParams(cfg, device="meta"), cfg, ecfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ContinuousBatchingEngine(params, cfg, ecfg)
    eng = ContinuousBatchingEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    elsewhere = type(batch)(*(x.to("meta") for x in batch))
    with pytest.raises(ValueError, match=r"runs on cpu, but the request is on \['meta'\]"):
        eng.submit(elsewhere, plen)
    assert not eng.queue and not eng.req_stats
    two = type(batch)(*(torch.cat([x, x]) for x in batch))
    with pytest.raises(ValueError, match="one request at a time"):
        eng.submit(two, plen)


def test_engine_refuses_a_request_past_the_block_table():
    """A prompt and budget that need more pages than max_pages_per_slot
    raise at submit, naming the limit, and queue nothing."""
    import dataclasses

    import torch

    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, batch, plen, ecfg = _tiny_engine_parts()
    narrow = dataclasses.replace(ecfg, max_pages_per_slot=plen // 16)
    eng = ContinuousBatchingEngine(params, cfg, narrow, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=f"more than max_pages_per_slot = {plen // 16}"):
        eng.submit(batch, plen)
    assert not eng.queue


def test_engine_refuses_a_request_past_the_pool():
    """A request that needs more pages than the pool holds beside its trash
    page raises at submit, naming num_pages, and queues nothing: queued, it
    would wait for pages no retirement can free."""
    import dataclasses

    import torch

    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, batch, plen, ecfg = _tiny_engine_parts()
    need = -(-(plen + ecfg.max_new_tokens + 1) // ecfg.page_size)
    small = dataclasses.replace(ecfg, num_pages=need)  # need - 1 allocatable pages
    for decode_chunk in (1, 4):
        eng = ContinuousBatchingEngine(
            params, cfg, dataclasses.replace(small, decode_chunk=decode_chunk),
            dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match=rf"more than num_pages - 1 .* = {need - 1}"):
            eng.submit(batch, plen)
        assert not eng.queue and not eng.req_stats and not eng.has_work()
    fits = ContinuousBatchingEngine(params, cfg, dataclasses.replace(small, num_pages=need + 1),
                                    dtype=torch.float32, device="cpu")
    fits.submit(batch, plen)
    assert len(fits.queue) == 1


def test_engine_refuses_quantize_kv_at_an_odd_kv_head_count():
    import dataclasses

    import torch

    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, batch, plen, ecfg = _tiny_engine_parts()
    odd = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_kv_heads=1))
    with pytest.raises(ValueError, match="1 kv heads is odd"):
        ContinuousBatchingEngine(params, odd, dataclasses.replace(ecfg, quantize_kv=True),
                                 dtype=torch.float32, device="cpu")
