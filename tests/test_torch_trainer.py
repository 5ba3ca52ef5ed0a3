"""The port's trainer, checkpoints, HF export and train CLI against the JAX
package's, at gar_tiny (one tile a grid, so a sample is about a thousand
tokens) on synthetic annotation files.

JAX's trainer runs once for the module (a fixture): its jitted step takes
most of this file's time. Both sides read the same file; JAX's dataset
runs its numpy forms (its native loader patched to report no library) and
the port's resize is patched to its numpy body, so the host batches are
equal bit for bit. Weights go across through `flatten_params`.

Both trainers hold fp32 parameters and moments (the CLI's default dtype)
and compute the loss in bf16 (JAX fixes it there). Tolerances: the
per-step losses of the two trainers within 5e-3 (`tests/test_torch_loss_
curve.py`'s bound at bf16); the port's trainer against `make_train_step`
on the same batches at rtol 1e-6; a resumed run against an uninterrupted
one bit for bit (the CPU step is reproducible: `models/llama.take_rows`).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params as jflatten
from grasp_any_region_tpu.data import dataset as jds
from grasp_any_region_tpu.data import tokenizer as jtok
from grasp_any_region_tpu.train import checkpoints as jckpt
from grasp_any_region_tpu.train import export as jexport
from grasp_any_region_tpu.train import optimizer as jopt
from grasp_any_region_tpu.train import trainer as jtrainer
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import (ParamGroup, convert_hf_state_dict,
                                                     flatten_params, load_flat_params,
                                                     read_safetensors)
from grasp_any_region_tpu_torch.data import dataset as tds
from grasp_any_region_tpu_torch.data import tokenizer as ttok
from grasp_any_region_tpu_torch.data.resize import resize_bicubic
from grasp_any_region_tpu_torch.data.synthetic import write_synthetic_annotations
from grasp_any_region_tpu_torch.train import OptimizerConfig, TrainState, init_state
from grasp_any_region_tpu_torch.train import make_train_step
from grasp_any_region_tpu_torch.train.checkpoints import CheckpointManager
from grasp_any_region_tpu_torch.train.export import export_hf_checkpoint, export_hf_state_dict
from grasp_any_region_tpu_torch.train.optimizer import make_optimizer
from grasp_any_region_tpu_torch.train.trainer import Trainer, TrainerConfig

STEPS = 3
OPT = dict(lr=1e-3, total_steps=STEPS, accumulation=2)
BATCH_FIELDS = ("input_ids", "positions", "segment_ids", "pixel_values", "mask_values",
                "aspect_ratio", "bboxes", "replay_pos", "replay_valid", "num_tiles")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's CPU steps: the suite runs six
    workers on the machine's cores, and a step with a thread a core each
    slowed about tenfold when the cores were oversubscribed."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_numpy_resize(img, out_h, out_w, antialias=True, n_threads=0):
    return resize_bicubic(img, out_h, out_w, antialias, use_native=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The configs, JAX-initialised weights, and two annotation files: six
    items of the three styles, and three whole-image items (one length
    bucket, so JAX's step compiles once)."""
    root = tmp_path_factory.mktemp("trainer")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("grasp_any_region_tpu.data.rle_native._load", lambda: None)
        mp.setattr("grasp_any_region_tpu.data.resize_native._load", lambda: None)
        mp.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                   _port_numpy_resize)
        six = write_synthetic_annotations(str(root / "six.json"), n_items=6, image_size=(96, 80),
                                          seed=3)
        items = json.loads(open(write_synthetic_annotations(
            str(root / "nine.json"), n_items=9, image_size=(96, 80), seed=5)).read())
        three = root / "three.json"
        three.write_text(json.dumps(items[2::3]))
        from grasp_any_region_tpu.models import init_gar_params

        jc = dataclasses.replace(jcfg.gar_tiny(), max_num_tiles=1)
        tc = dataclasses.replace(tcfg.gar_tiny(), max_num_tiles=1)
        params = init_gar_params(jax.random.PRNGKey(0), jc)
        yield dict(root=root, six=six, three=str(three), jc=jc, tc=tc, params=params,
                   flat=jflatten(params))


def _datasets(w, path):
    j = jds.GraspAnyRegionDataset(w["jc"], jtok.GARTokenizer.synthetic(),
                                  jds.DatasetConfig(annotation_paths=[path]))
    t = tds.GraspAnyRegionDataset(w["tc"], ttok.GARTokenizer.synthetic(),
                                  tds.DatasetConfig(annotation_paths=[path]))
    return j, t


def _port_trainer(w, path, work, max_steps=STEPS, batch_size=1):
    _, tset = _datasets(w, path)
    params = load_flat_params(w["flat"], w["tc"], device="cpu")
    tcfg_ = TrainerConfig(work_dir=str(work), max_steps=max_steps, batch_size=batch_size,
                          log_interval=1, num_workers=2, device="cpu")
    return Trainer(w["tc"], params, tset, OptimizerConfig(**OPT), tcfg_)


@pytest.fixture(scope="module")
def jax_losses(world):
    """JAX's trainer, 3 steps with accumulation 2 on the three-item file:
    its per-step losses."""
    jset, _ = _datasets(world, world["three"])
    jt = jtrainer.Trainer(world["jc"], world["params"], jset, jopt.OptimizerConfig(**OPT),
                          jtrainer.TrainerConfig(work_dir=str(world["root"] / "jax"),
                                                 max_steps=STEPS, log_interval=1,
                                                 num_workers=2))
    losses, step = [], jt.step_fn

    def recorded(state, batch, labels):
        state, metrics = step(state, batch, labels)
        losses.append(float(metrics["loss"]))
        return state, metrics

    jt.step_fn = recorded
    jt.train()
    return losses


@pytest.fixture(scope="module")
def port_run(world):
    """The port's trainer, 3 uninterrupted steps on the three-item file."""
    tr = _port_trainer(world, world["three"], world["root"] / "port")
    state = tr.train()
    return tr, state, [h["loss"].item() for h in tr.history]


@pytest.mark.parametrize("batch_size,max_steps", [(1, 8), (2, 5), (8, 2)])
def test_step_indices_and_batches_equal_jax(world, monkeypatch, batch_size, max_steps):
    """The same per-step dataset indices as JAX's trainer, across an epoch
    boundary (and with n_items < batch_size), and its loader's collate
    gives the port's host batch bit for bit."""
    recorded = {}

    class Recorder:
        def __init__(self, dataset, indices, *, batch_size, collate_fn, **kw):
            recorded.update(indices=list(indices), collate=collate_fn, batch_size=batch_size)

        def __iter__(self):
            return iter(())

    monkeypatch.setattr(jtrainer, "PrefetchLoader", Recorder)
    jset, tset = _datasets(world, world["six"])
    jt = jtrainer.Trainer(world["jc"], world["params"], jset, jopt.OptimizerConfig(**OPT),
                          jtrainer.TrainerConfig(work_dir=str(world["root"] / f"idx{batch_size}"),
                                                 max_steps=max_steps, batch_size=batch_size))
    jt.train()
    tr = _port_trainer(world, world["six"], world["root"] / f"tidx{batch_size}",
                       max_steps=max_steps, batch_size=batch_size)
    got = tr.step_indices(0, tr.max_steps())
    assert got == recorded["indices"] and len(got) == max_steps * batch_size
    assert recorded["batch_size"] == batch_size
    assert tr.step_indices(3, max_steps) == got[3 * batch_size:]  # a resume's tail
    for first in (0, len(got) - batch_size):
        idx = got[first:first + batch_size]
        tbatch, tplens, tlabels = tr.collate([tset[i] for i in idx])
        jbatch, jplens, jlabels = recorded["collate"]([jset[i] for i in idx])
        for name in BATCH_FIELDS:
            g, want = getattr(tbatch, name), np.asarray(getattr(jbatch, name))
            assert g.device.type == "cpu" and g.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(tlabels.numpy(), np.asarray(jlabels))
        np.testing.assert_array_equal(tplens.numpy(), np.asarray(jplens))


def test_bf16_losses_track_jax(port_run, jax_losses):
    """Three steps with accumulation 2 (the update lands after step 2):
    each step's loss within 5e-3 of JAX's trainer."""
    tr, _, losses = port_run
    print("jax", jax_losses, "port", losses)
    assert len(losses) == len(jax_losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=5e-3, rtol=0)
    assert tr.state.opt_state.count == 1 and tr.state.opt_state.mini_step == 1


def test_fp32_trainer_equals_make_train_step(world, port_run):
    """The trainer is make_train_step over the loader's batches: the same
    losses and parameters when the steps are taken by hand."""
    tr, state, losses = port_run
    _, tset = _datasets(world, world["three"])
    hand, tx = init_state(load_flat_params(world["flat"], world["tc"], device="cpu"),
                          OptimizerConfig(**OPT), device="cpu")
    step = make_train_step(world["tc"], tx, device="cpu")
    hand_losses = []
    for i in tr.step_indices(0, STEPS):
        batch, _, labels = tr.collate([tset[i]])
        hand, metrics = step(hand, batch, labels)
        hand_losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, hand_losses, rtol=1e-6)
    assert state.step == hand.step == STEPS
    for (name, p), q in zip(state.params.named_parameters(), hand.params.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=0, msg=name)


def _equal_to_export(back: dict, params: dict, cfg):
    """An export read back equals the parameters it came from; the export
    holds the vocabulary's rows only, so the padding rows read back as 0."""
    assert sorted(back) == sorted(params)
    vocab = cfg.extended_vocab_size
    for name, want in params.items():
        got = back[name]
        if name == "llm/embed":
            assert not got[vocab:].any(), name
            want, got = want[:vocab], got[:vocab]
        elif name == "llm/lm_head":
            assert not got[:, vocab:].any(), name
            want, got = want[:, :vocab], got[:, :vocab]
        np.testing.assert_array_equal(got, want, err_msg=name)


def _equal_states(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (name, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), name
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.mini_step) == (ob.count, ob.mini_step)
    for kind in ("mu", "nu", "acc"):
        for i, (x, y) in enumerate(zip(getattr(oa, kind), getattr(ob, kind))):
            assert torch.equal(x, y), (kind, i)


def test_resume_is_bit_equal(world, port_run):
    """One step, then a new trainer in the same work dir resumes at step 1
    (mid accumulation window: the saved gradient mean comes back) and takes
    steps 2 and 3: the restored state equals the saved one, and every
    parameter and optimizer tensor at the end equals the uninterrupted
    run's, bit for bit."""
    _, whole, losses = port_run
    work = world["root"] / "resume"
    first = _port_trainer(world, world["three"], work, max_steps=1)
    saved = first.train()
    assert first.ckpt.all_steps() == [1] and saved.opt_state.mini_step == 1
    second = _port_trainer(world, world["three"], work)
    assert second.state.step == 1
    _equal_states(second.state, saved)
    resumed = second.train()
    assert [h["step"] for h in second.history] == [2, 3]
    assert [h["loss"].item() for h in second.history] == losses[1:]
    _equal_states(resumed, whole)
    assert second.ckpt.all_steps() == [1, 3]


@pytest.mark.parametrize("save_optimizer", [True, False])
def test_checkpoint_cadence_matches_orbax(world, save_optimizer):
    """The same maybe_save calls keep the same steps as JAX's orbax manager
    (save_interval 2, keep 2: the first step, the cadence, the forced final
    save and its dedupe, and a manager reopened on the directory); restore
    gives the newest step, its optimizer state only when it was saved."""
    calls = [[0, 1, 2, 3, 4, 5, ("f", 5)], [1, 2, 3, ("f", 3), ("f", 3), 4, ("f", 7)],
             [2, ("f", 2), 4, 6, 8, ("f", 9)]]
    root = world["root"] / f"cadence{int(save_optimizer)}"

    def port_state(i):
        params = ParamGroup({"w": (3,), "b": (2,)}, dtype=torch.bfloat16)
        with torch.no_grad():
            for k, p in enumerate(params.parameters()):
                p.fill_(i + k / 4)
        tx = make_optimizer(params, OptimizerConfig(accumulation=2))
        opt = tx.init(params)
        for t in opt.mu + opt.nu + opt.acc:
            t.fill_(-i)
        opt.count, opt.mini_step = i, i % 2
        return TrainState(params=params, opt_state=opt, step=i)

    def jax_state(i):
        return jtrainer.init_sharded_state.__globals__["TrainState"](
            params={"w": np.full(3, float(i))}, opt_state={"m": np.full(2, -float(i))},
            step=np.asarray(i))

    for n, seq in enumerate(calls + [[4, 3, 2, 6, 7, 8]]):
        reopen = n == len(calls)
        jdir, tdir = root / f"j{n - reopen}", root / f"t{n - reopen}"
        jm = jckpt.CheckpointManager(str(jdir), save_interval=2, max_to_keep=2,
                                     save_optimizer=save_optimizer)
        tm = CheckpointManager(str(tdir), save_interval=2, max_to_keep=2,
                               save_optimizer=save_optimizer)
        got, want = [], []
        for call in seq:
            step, force = (call[1], True) if isinstance(call, tuple) else (call, False)
            want.append(bool(jm.maybe_save(step, jax_state(step), force=force)))
            got.append(tm.maybe_save(step, port_state(step), force=force))
        jm.wait()
        tm.wait()
        assert got == want, seq
        assert tm.all_steps() == sorted(jm.mgr.all_steps()), seq
        last = tm.latest_step()
        restored = tm.restore(port_state(100))
        assert restored.step == last
        ref = port_state(last)
        for p, q in zip(restored.params.parameters(), ref.params.parameters()):
            assert torch.equal(p, q)
        keep = ref.opt_state if save_optimizer else port_state(100).opt_state
        o = restored.opt_state
        assert (o.count, o.mini_step) == (keep.count, keep.mini_step)
        for kind in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(getattr(o, kind), getattr(keep, kind)))
        if save_optimizer:  # acc is saved mid-window and zero at a window's end
            assert all(torch.equal(x, y if last % 2 else torch.zeros_like(y))
                       for x, y in zip(o.acc, keep.acc))


def test_export_equals_jax(world, tmp_path):
    """export_hf_state_dict equals JAX's name by name and value by value
    (from fp32 and from bf16 parameters), and the written checkpoint reads
    back through convert_hf_state_dict to the parameters."""
    tparams = load_flat_params(world["flat"], world["tc"], device="cpu")
    got = export_hf_state_dict(world["tc"], tparams)
    want = jexport.export_hf_state_dict(world["jc"], world["params"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    bf16 = load_flat_params(world["flat"], world["tc"], device="cpu", dtype=torch.bfloat16)
    export_hf_checkpoint(str(tmp_path / "hf"), world["tc"], bf16)
    cfg_json = json.loads((tmp_path / "hf" / "config.json").read_text())
    assert cfg_json["model_type"] == "gar" and "gar_tpu_config" in cfg_json
    back = flatten_params(convert_hf_state_dict(
        world["tc"], read_safetensors(str(tmp_path / "hf" / "model.safetensors"))))
    _equal_to_export(back, flatten_params(bf16), world["tc"])


def test_cli_train_end_to_end_and_refuses_a_mesh(world, tmp_path):
    """`cli.train.main` on a six-item synthetic file at gar_tiny on the
    CPU, two steps: its checkpoint restores to the trained state, its HF
    export reads back to the trained parameters; in one process a mesh is
    refused before anything is built: --fsdp 2 and --pipe 2 want two
    launched processes."""
    from grasp_any_region_tpu_torch.cli.train import main

    work, export = tmp_path / "run", tmp_path / "hf"
    args = ["--preset", "gar_tiny", "--data", world["six"], "--work-dir", str(work),
            "--max-steps", "2", "--export-hf", str(export), "--device", "cpu"]
    tr = main(args)
    state = tr.state
    assert state.step == 2 and sorted(tr.ckpt.all_steps()) == [1, 2]
    assert all(np.isfinite(h["loss"].item()) for h in tr.history)
    template, _ = init_state(load_flat_params(flatten_params(state.params), tcfg.gar_tiny(),
                                              device="cpu"),
                             OptimizerConfig(total_steps=2, accumulation=2), device="cpu")
    with torch.no_grad():
        for p in template.params.parameters():
            p.zero_()
    _equal_states(CheckpointManager(str(work)).restore(template), state)
    cfg_json = json.loads((export / "config.json").read_text())
    cfg = tcfg.gar_config_from_dict(cfg_json["gar_tpu_config"])
    assert cfg == tcfg.gar_tiny()
    back = flatten_params(convert_hf_state_dict(cfg, read_safetensors(
        str(export / "model.safetensors"))))
    _equal_to_export(back, flatten_params(state.params), cfg)
    with pytest.raises(ValueError, match="needs 2 processes"):
        main(args[:-2] + ["--fsdp", "2"])
    with pytest.raises(ValueError, match="needs 2 processes"):
        main(args[:-2] + ["--pipe", "2"])
