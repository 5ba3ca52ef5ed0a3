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


def test_serve_factories_default_to_the_card():
    """Every factory that `serve/` exports with a `device` argument builds
    on the card unless asked for the CPU, and raises where there is none
    (the rule the model and data factories keep)."""
    import inspect

    import torch

    from grasp_any_region_tpu_torch import serve

    defaults = {}
    for name in dir(serve):
        obj = getattr(serve, name)
        if name.startswith("_") or not callable(obj):
            continue
        params = inspect.signature(obj).parameters
        if "device" in params:
            defaults[name] = params["device"].default
    assert defaults == {"ContinuousBatchingEngine": "cuda", "init_paged_kv": "cuda"}
    args = (2, 4, 16, 2, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            serve.init_paged_kv(*args, slots=2, max_pages_per_slot=3)
    paged = serve.init_paged_kv(*args, slots=2, max_pages_per_slot=3, device="cpu")
    assert {t.device.type for t in paged} == {"cpu"}
    assert paged.k.shape == (2, 2, 4, 16, 8) and paged.block_table.shape == (2, 3)


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

    from grasp_any_region_tpu_torch.models.gar import GARParams, map_batch
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, batch, plen, ecfg = _tiny_engine_parts()
    with pytest.raises(ValueError, match=r"runs on cpu, but params are on \['meta'\]"):
        ContinuousBatchingEngine(GARParams(cfg, device="meta"), cfg, ecfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ContinuousBatchingEngine(params, cfg, ecfg)
    eng = ContinuousBatchingEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    elsewhere = map_batch(lambda x: x.to("meta"), batch)
    with pytest.raises(ValueError, match=r"runs on cpu, but the request is on \['meta'\]"):
        eng.submit(elsewhere, plen)
    assert not eng.queue and not eng.req_stats
    two = map_batch(lambda x: torch.cat([x, x]), batch)
    with pytest.raises(ValueError, match="one request at a time"):
        eng.submit(two, plen)


def test_engine_refuses_a_video_request():
    """A video batch (replay_tile set) raises at submit, naming video
    serving, and queues nothing: the engine prefills in image mode, which
    would neither scatter the frame features nor replay each region's own
    frame."""
    import numpy as np
    import torch

    from grasp_any_region_tpu_torch.data.builders import VideoRegionSample, build_video_batch
    from grasp_any_region_tpu_torch.data.image_processor import GARImageProcessor
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, _, _, ecfg = _tiny_engine_parts()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)]
    mask = np.zeros((60, 80), np.uint8)
    mask[10:40, 20:60] = 1
    batch, plens = build_video_batch(cfg, GARTokenizer.synthetic(), GARImageProcessor(),
                                     [VideoRegionSample(frames, {1: mask}, "What moves?")],
                                     device="cpu")
    assert batch.replay_tile is not None
    eng = ContinuousBatchingEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="video requests .* are not served"):
        eng.submit(batch, int(plens[0]))
    assert not eng.queue and not eng.req_stats


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


def test_port_module_list_covers_the_front_door():
    """The no-jax walk above imports the CLIs and the host data path too."""
    names = {m.name for m in pkgutil.walk_packages(grasp_any_region_tpu_torch.__path__,
                                                  "grasp_any_region_tpu_torch.")}
    prefix = "grasp_any_region_tpu_torch."
    assert {prefix + n for n in (
        "cli.runtime", "cli.gar_with_mask", "cli.gar_relationship", "cli.gar_video",
        "data.builders", "data.chat", "data.image_processor", "data.prompts", "data.resize",
        "data.tokenizer", "data.video")} <= names


def test_port_module_list_covers_training_from_a_file():
    """The no-jax walk above imports the trainer's modules too."""
    names = {m.name for m in pkgutil.walk_packages(grasp_any_region_tpu_torch.__path__,
                                                  "grasp_any_region_tpu_torch.")}
    prefix = "grasp_any_region_tpu_torch."
    assert {prefix + n for n in (
        "cli.train", "data.dataset", "data.loader", "data.native", "data.png", "data.rle",
        "train.checkpoints", "train.export", "train.trainer")} <= names


def test_training_entry_points_default_to_the_card(tmp_path):
    """The Trainer and `cli.train` run on the card unless asked for the CPU
    and raise where there is none, before they build or read anything;
    data, fsdp, tensor, seq and pipe above 1 pass both, which then want as
    many ranks as the mesh (one process here: the ranks' runs are
    `test_trainer_takes_a_mesh_on_gloo_ranks` and
    tests/test_torch_pipeline.py); pipe with tensor or seq above 1 is
    refused, as JAX's CLI refuses it."""
    import torch

    from grasp_any_region_tpu_torch.cli.train import main
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.train import OptimizerConfig
    from grasp_any_region_tpu_torch.train.trainer import MeshSpec, Trainer, TrainerConfig

    assert TrainerConfig().device == "cuda"
    missing = str(tmp_path / "nowhere.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Trainer(None, None, None, OptimizerConfig(), TrainerConfig())
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(["--preset", "gar_tiny", "--data", missing])
    with pytest.raises(SystemExit):
        main(["--preset", "gar_tiny", "--data", missing, "--device", "cpu", "--pipe", "2",
              "--tensor", "2"])
    with pytest.raises(ValueError, match="pipeline composes with data/fsdp only"):
        Trainer(gar_tiny(), None, None, OptimizerConfig(),
                TrainerConfig(device="cpu", mesh=MeshSpec(pipe=2, seq=2)))
    flag = {"data": "--data-axis"}
    for axis in ("data", "fsdp", "tensor", "seq", "pipe"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            Trainer(gar_tiny(), None, None, OptimizerConfig(),
                    TrainerConfig(device="cpu", mesh=MeshSpec(**{axis: 2})))
        with pytest.raises(ValueError, match="needs 2 processes"):
            main(["--preset", "gar_tiny", "--data", missing, "--device", "cpu",
                  flag.get(axis, f"--{axis}"), "2"])


def test_trainer_takes_a_mesh_on_gloo_ranks(tmp_path):
    """On two gloo ranks a Trainer is made for data, fsdp, tensor and seq at
    2: the data and fsdp ranks load one row each of a batch of two (the
    other rank's row), the tensor and seq ranks both rows, and the seq
    axis pads the sequence to a multiple of 2."""
    import dataclasses

    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.data.synthetic import write_synthetic_annotations
    from torch_ranks import run_ranks, trainer_job

    ann = write_synthetic_annotations(str(tmp_path / "ann.json"), n_items=4,
                                      image_size=(96, 80), seed=3)
    cfg = dataclasses.replace(gar_tiny(), max_num_tiles=1)
    r0, r1 = run_ranks(2, trainer_job, cfg, ann, str(tmp_path / "work"))
    for axis in ("data", "fsdp"):
        assert r0[axis][:3] == (2, 0, 1) and r1[axis][:3] == (2, 1, 1)
        assert len(r0[axis][3]) == 1 and r0[axis][3] != r1[axis][3]
    for axis, multiple in (("tensor", 1), ("seq", 2)):
        assert r0[axis][:3] == r1[axis][:3] == (1, 0, multiple)
        assert len(r0[axis][3]) == 2 and r0[axis][3] == r1[axis][3]
    assert sorted(r0["data"][3] + r1["data"][3]) == sorted(r0["tensor"][3])


def test_port_module_list_covers_parallelism():
    """The no-jax walk above imports the mesh and the parallel modules too."""
    names = {m.name for m in pkgutil.walk_packages(grasp_any_region_tpu_torch.__path__,
                                                  "grasp_any_region_tpu_torch.")}
    prefix = "grasp_any_region_tpu_torch."
    assert {prefix + n for n in (
        "core.mesh", "parallel", "parallel.collectives", "parallel.sharding",
        "parallel.ulysses", "parallel.ring", "parallel.pipeline")} <= names


def test_front_door_factories_default_to_the_card(tmp_path):
    """GARRuntime.load, collate_samples (and the batch builders through it)
    and load_checkpoint build on the card unless asked for the CPU, and
    raise where there is none, before reading anything."""
    import inspect

    import numpy as np
    import torch

    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import load_checkpoint
    from grasp_any_region_tpu_torch.data.builders import (RegionSample, build_region_batch,
                                                          build_sample, collate_samples)
    from grasp_any_region_tpu_torch.data.image_processor import GARImageProcessor
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer

    for fn in (GARRuntime.load, collate_samples, load_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg, tok, proc = gar_tiny(), GARTokenizer.synthetic(), GARImageProcessor()
    mask = np.zeros((40, 60), np.uint8)
    mask[5:20, 10:30] = 1
    sample = RegionSample(np.zeros((40, 60, 3), np.uint8), {1: mask})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            GARRuntime.load(None, "gar_tiny", random_init=True)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            build_region_batch(cfg, tok, proc, [sample])
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            collate_samples(cfg, [build_sample(cfg, tok, proc, sample)])
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            load_checkpoint(str(tmp_path / "nowhere"))
    batch, plens = build_region_batch(cfg, tok, proc, [sample], device="cpu")
    assert {x.device.type for x in batch if x is not None} == {"cpu"}
    assert batch.replay_tile is None and plens.device.type == "cpu"


def test_engine_admits_builder_batches_without_replay_tile():
    """Two requests from build_region_batch (replay_tile None) share one
    admission group, concatenated field by field with None passed through,
    and the engine's tokens equal generate's for each request alone."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from grasp_any_region_tpu_torch.data.builders import RegionSample, build_region_batch
    from grasp_any_region_tpu_torch.data.image_processor import GARImageProcessor
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.models import generate as gen_mod
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine

    cfg, params, _, _, ecfg = _tiny_engine_parts()
    rng = np.random.default_rng(0)
    tok, proc = GARTokenizer.synthetic(), GARImageProcessor()
    reqs = []
    for i in range(2):
        mask = np.zeros((100, 150), np.uint8)
        mask[10 + 20 * i:60 + 20 * i, 20:100] = 1
        sample = RegionSample(rng.integers(0, 256, (100, 150, 3), dtype=np.uint8), {1: mask})
        batch, plens = build_region_batch(cfg, tok, proc, [sample], device="cpu")
        assert batch.replay_tile is None
        reqs.append((batch, int(plens[0])))
    ecfg = dataclasses.replace(ecfg, num_pages=256, max_pages_per_slot=128)
    eng = ContinuousBatchingEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    ids = [eng.submit(b, n) for b, n in reqs]
    out = eng.run()
    assert eng.counts["prefill_groups"] == 1 and eng.counts["prefill_rows"] == 2
    with pytest.MonkeyPatch.context() as mp:  # the engine's fp32 pools: an fp32 cache here too
        mp.setattr(gen_mod, "seed_cache_from_prefill",
                   functools.partial(gen_mod.seed_cache_from_prefill, dtype=torch.float32))
        for rid, (batch, n) in zip(ids, reqs):
            want = gen_mod.generate(params, cfg, batch, torch.tensor([n]), eot_id=-1,
                                    max_new_tokens=ecfg.max_new_tokens,
                                    compute_dtype=torch.float32)
            assert out[rid] == want.tokens[0].tolist()


def test_port_module_list_covers_evaluation():
    """The no-jax walk above imports the evaluation package, its judges, the
    eval, parity and warmup CLIs, the profiler and the leftover ops too."""
    names = {m.name for m in pkgutil.walk_packages(grasp_any_region_tpu_torch.__path__,
                                                  "grasp_any_region_tpu_torch.")}
    prefix = "grasp_any_region_tpu_torch."
    assert {prefix + n for n in (
        "evaluation.engine", "evaluation.coco", "evaluation.dlc", "evaluation.ferret",
        "evaluation.garbench", "evaluation.mdvp", "evaluation.synthetic",
        "evaluation.judges.client", "evaluation.judges.dlc_judge",
        "evaluation.judges.garbench_judge", "evaluation.judges.pairwise_judge",
        "evaluation.judges.paint", "cli.eval", "cli.parity", "cli.warmup", "utils.profiling",
        "ops.roi_align", "ops.tiles")} <= names


@pytest.mark.parametrize("cli", ["eval", "parity", "warmup"])
def test_eval_parity_warmup_default_to_the_card(tmp_path, cli):
    """The inference entry points of the eval, parity and warmup CLIs run
    on the card unless asked for the CPU, and raise where there is none
    before they read anything."""
    import inspect

    import torch

    from grasp_any_region_tpu_torch.cli import eval as ev
    from grasp_any_region_tpu_torch.cli import parity, warmup

    missing = str(tmp_path / "nowhere")
    argv = {"eval": ["dlc", "--anno", missing, "--preset", "gar_tiny", "--random-init"],
            "parity": ["--model-path", missing, "--preset", "gar_tiny"],
            "warmup": ["--preset", "gar_tiny"]}[cli]
    main = {"eval": ev.main, "parity": parity.main, "warmup": warmup.main}[cli]
    if cli == "warmup":
        assert inspect.signature(warmup.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(argv)
