"""`cli/train.py` under two launched processes: `python -m
torch.distributed.run --nproc-per-node 2 -m grasp_any_region_tpu_torch.cli.train
--fsdp 2 --device cpu` on a synthetic annotation file (gar_tiny with one
tile a row, from a config file), gloo ranks: both ranks train, each keeps
its checkpoints under work_dir/rank<r>, rank 0 alone prints and writes
the HF export, which reads back as the whole tree."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from grasp_any_region_tpu_torch.core.config import gar_tiny, save_config
    from grasp_any_region_tpu_torch.data.synthetic import write_synthetic_annotations

    root = tmp_path_factory.mktemp("cli")
    ann = write_synthetic_annotations(str(root / "ann.json"), n_items=4, image_size=(96, 80),
                                      seed=3)
    cfg_path = str(root / "cfg.json")
    save_config(dataclasses.replace(gar_tiny(), max_num_tiles=1), cfg_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "grasp_any_region_tpu_torch.cli.train", "--config", cfg_path, "--device",
           "cpu", "--fsdp", "2", "--data", ann, "--work-dir", str(root / "work"),
           "--max-steps", "2", "--batch-size", "2", "--log-interval", "1",
           "--export-hf", str(root / "hf")]
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    return root, res


def test_two_launched_ranks_train_and_export(run):
    root, res = run
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    steps = [line for line in res.stdout.splitlines() if line.startswith("[trainer] step")]
    assert [s.split()[2] for s in steps] == ["1/2", "2/2"]  # rank 0 prints, once a step
    for rank in (0, 1):
        assert os.path.isdir(root / "work" / f"rank{rank}" / "2")


def test_the_export_holds_the_whole_tree(run, tmp_path):
    """The sharded run's export has the keys and shapes of a one-process
    export of the same config."""
    import torch

    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params, read_safetensors
    from grasp_any_region_tpu_torch.train.export import export_hf_checkpoint

    root, res = run
    assert res.returncode == 0
    cfg = dataclasses.replace(gar_tiny(), max_num_tiles=1)
    export_hf_checkpoint(str(tmp_path), cfg,
                         init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu"))

    def shapes(d):
        out = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".safetensors"):
                out.update({k: v.shape for k, v in read_safetensors(os.path.join(d, f)).items()})
        return out

    want = shapes(tmp_path)
    assert want and shapes(root / "hf") == want
    with open(root / "hf" / "config.json") as f:
        assert json.load(f)
