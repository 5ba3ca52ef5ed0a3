"""The port's sharded train step on two gloo ranks at gar_tiny in fp32,
against the port's one-process step and JAX's single-device
`make_train_step` on the same JAX-initialised parameters and synthetic
batch (2 rows; one thumbnail and one tile a row, `max_num_tiles=1`, to keep
the CPU tower small): data = 2, fsdp = 2, tensor = 2, seq = 2 (Ulysses: 4
q / 2 kv heads divide it) and seq = 2 with one kv head (ring attention).

JAX's `loss_fn` fixes its compute dtype at bf16; its step is traced here
with `build_prefill_embeds` patched to fp32 (as tests/test_torch_train.py
composes its pieces at fp32). One job of two spawned ranks
(tests/torch_ranks.py) runs every mesh; the cases read its results.

Bounds: the loss within rtol 1e-5 of the port's one process and 1e-4 of
JAX's; every whole gradient leaf within 1e-4 of its largest element; the
parameters after the AdamW step within 1e-5; each rank's parameter and
moment bytes at most 1/2 of one process's plus its leaves not sharded over
the axis (fsdp, tensor), or all of them (data, seq)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.mesh import MeshSpec
from torch_ranks import RankJob, numpy_fields, replace_text, train_job, train_step

LR = 1e-4
CASES = {"data": (MeshSpec(data=2), 2), "fsdp": (MeshSpec(fsdp=2), 2),
         "tensor": (MeshSpec(tensor=2), 2), "seq": (MeshSpec(seq=2), 2),
         "ring": (MeshSpec(seq=2), 1)}  # (mesh, kv heads)


def _cfg(mod, kv_heads):
    cfg = dataclasses.replace(mod.gar_tiny(), max_num_tiles=1)
    return replace_text(cfg, num_kv_heads=kv_heads)


@pytest.fixture(scope="module")
def setup():
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch
    from grasp_any_region_tpu.models import init_gar_params

    out = {}
    for kv in (2, 1):
        cfg_j = _cfg(jcfg, kv)
        params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
        shape = params["mask_embed"]["kernel"].shape
        params["mask_embed"]["kernel"] = jnp.asarray(
            np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
        batch, labels, _ = synthetic_batch(cfg_j, batch=2, grid=(1, 1), seed=0)
        assert batch.input_ids.shape[1] % 2 == 0  # divides seq = 2
        out[kv] = dict(cfg_j=cfg_j, cfg_t=_cfg(tcfg, kv), params=params,
                       flat=flatten_params(params), jb=batch, jlabels=labels,
                       fields=numpy_fields(batch), labels=np.asarray(labels))
    return out


@pytest.fixture(scope="module")
def job(setup):
    """The two ranks, started before the references so that they overlap."""
    cases = [(name, spec, setup[kv]["cfg_t"], setup[kv]["flat"], setup[kv]["fields"],
              setup[kv]["labels"]) for name, (spec, kv) in CASES.items()]
    return RankJob(2, train_job, cases, LR)


@pytest.fixture(scope="module")
def ranks(job, one_process, jax_losses):
    return job.results()


@pytest.fixture(scope="module")
def one_process(setup):
    from grasp_any_region_tpu_torch.core.weights import load_flat_params

    return {kv: train_step(load_flat_params(s["flat"], s["cfg_t"], device="cpu"), s["cfg_t"],
                           s["fields"], s["labels"], LR) for kv, s in setup.items()}


@pytest.fixture(scope="module")
def jax_losses(setup):
    import grasp_any_region_tpu.train.step as jstep
    from grasp_any_region_tpu.models.gar import build_prefill_embeds
    from grasp_any_region_tpu.train import OptimizerConfig, init_sharded_state, make_train_step

    def fp32(*a, **kw):
        return build_prefill_embeds(*a, **{**kw, "compute_dtype": jnp.float32})

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_prefill_embeds", fp32)
        for kv, s in setup.items():
            state, tx = init_sharded_state(s["params"], OptimizerConfig(
                lr=LR, total_steps=10, warmup_ratio=0.0), mesh=None)
            step = make_train_step(s["cfg_j"], tx, mask_compat=False, use_flash=False,
                                   donate=False)
            out[kv] = float(step(state, s["jb"], s["jlabels"])[1]["loss"])
    return out


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_one_process_and_jax(ranks, one_process, jax_losses, case):
    kv = CASES[case][1]
    for r in ranks:
        np.testing.assert_allclose(r[case]["loss"], one_process[kv]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r[case]["loss"], jax_losses[kv], rtol=1e-4)
        np.testing.assert_allclose(r[case]["grad_norm"], one_process[kv]["grad_norm"],
                                   rtol=1e-5)
    assert ranks[0][case]["loss"] == ranks[1][case]["loss"]


@pytest.mark.parametrize("case", CASES)
def test_gathered_gradients_match_one_process(ranks, one_process, case):
    want = one_process[CASES[case][1]]["grads"]
    for r in ranks:
        got = r[case]["grads"]
        assert set(got) == set(want)
        for name, g in want.items():
            scale = float(np.abs(g).max())
            assert np.abs(got[name] - g).max() <= 1e-4 * scale + 1e-12, name


@pytest.mark.parametrize("case", CASES)
def test_parameters_after_the_step_match_one_process(ranks, one_process, case):
    want = one_process[CASES[case][1]]["params"]
    for r in ranks:
        for name, p in want.items():
            np.testing.assert_allclose(r[case]["params"][name], p, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_rank_holds_its_shards_of_parameters_and_moments(ranks, one_process, case):
    from grasp_any_region_tpu_torch.parallel.sharding import spec_axes

    whole = one_process[CASES[case][1]]["bytes"]
    for r in ranks:
        got = r[case]
        if case in ("data", "seq", "ring"):  # nothing is sharded over these axes
            assert got["bytes"] == whole
            continue
        replicated = sum(b for n, b in got["leaf_bytes"].items()
                         if case not in spec_axes(got["specs"][n]))
        assert got["bytes"] <= whole / 2 + replicated, (got["bytes"], whole, replicated)
        assert got["bytes"] < 0.55 * whole
