"""The port's `generate(mesh=)` on four gloo ranks against JAX's
single-device `generate` at gar_tiny in fp32, token for token, as
tests/test_tp_inference.py asserts for JAX's own mesh: data = 2 x tensor =
2 over a ragged batch of two rows (each data rank its row, q / kv heads and
MLP columns over tensor, the vocab-sharded embedding and head), fsdp = 2 x
tensor = 2 over the same rows (each layer's weights gathered from their
fsdp shards at every prefill layer and decode step), and tensor = 2 x seq
= 2 over one row (Ulysses prefill on the TP heads, gathered for
the decode). The decoder projections are scaled by 10 so that greedy
decoding does not repeat one token (tests/test_torch_model.py); one
thumbnail and one tile a row (`max_num_tiles=1`) keep the CPU tower small.

JAX's `generate` fixes its compute dtype at bf16; it is re-jitted here at
fp32 by patching `gar_prefill` and `gar_decode_step` (as
tests/test_torch_model.py does). One job of four spawned ranks
(tests/torch_ranks.py) runs both meshes."""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.mesh import MeshSpec
from torch_ranks import RankJob, generate_job, numpy_fields

N_NEW = 6
CASES = {"data_tensor": (MeshSpec(data=2, tensor=2), 2),
         "fsdp_tensor": (MeshSpec(fsdp=2, tensor=2), 2),
         "tensor_seq": (MeshSpec(tensor=2, seq=2), 1)}  # (mesh, rows)


def _cfg(mod):
    return dataclasses.replace(mod.gar_tiny(), max_num_tiles=1)


@pytest.fixture(scope="module")
def setup():
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch
    from grasp_any_region_tpu.models import init_gar_params

    params = init_gar_params(jax.random.PRNGKey(0), _cfg(jcfg))
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    batches = {}
    for name, (_, rows) in CASES.items():
        batch, _, lens = synthetic_batch(_cfg(jcfg), batch=rows, grid=(1, 1), seed=3)
        if rows == 2:  # ragged: row 1 shorter by 12 tokens, right-padded
            fields = numpy_fields(batch)
            lens = np.array(lens)
            n = lens[1] - 12
            for key, fill in (("input_ids", 0), ("segment_ids", 0), ("positions", n - 1)):
                fields[key] = fields[key].copy()
                fields[key][1, n:] = fill
            lens[1] = n
            batch = batch._replace(**{k: jnp.asarray(fields[k])
                                      for k in ("input_ids", "segment_ids", "positions")})
        assert batch.input_ids.shape[1] % 2 == 0  # divides seq = 2
        batches[name] = (batch, np.asarray(lens, np.int32))
    return dict(params=params, flat=flatten_params(params), batches=batches)


@pytest.fixture(scope="module")
def job(setup):
    """The four ranks, started before JAX's reference so that they overlap."""
    cases = [(name, spec, _cfg(tcfg), setup["flat"], numpy_fields(setup["batches"][name][0]),
              setup["batches"][name][1], dict(max_new_tokens=N_NEW, eot_id=-1,
                                              mask_compat=False))
             for name, (spec, _) in CASES.items()]
    return RankJob(4, generate_job, cases)


@pytest.fixture(scope="module")
def ranks(job, jax_tokens):
    return job.results()


@pytest.fixture(scope="module")
def jax_tokens(setup):
    from grasp_any_region_tpu.models import gar as jg

    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    patched = {"gar_prefill": functools.partial(jg.gar_prefill, compute_dtype=jnp.float32),
               "gar_decode_step": functools.partial(jg.gar_decode_step,
                                                    compute_dtype=jnp.float32)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in patched.items():
            mp.setattr(jmod, name, fn)
        gen = jax.jit(jmod.generate.__wrapped__,
                      static_argnames=("cfg", "max_new_tokens", "eot_id", "mask_compat"))
        for name, (batch, lens) in setup["batches"].items():
            res = gen(setup["params"], _cfg(jcfg), batch, jnp.asarray(lens),
                      max_new_tokens=N_NEW, eot_id=-1, mask_compat=False)
            out[name] = (np.asarray(res.tokens), np.asarray(res.num_generated))
    return out


@pytest.mark.parametrize("case", CASES)
def test_generate_over_a_mesh_gives_jax_tokens(ranks, jax_tokens, case):
    tokens, num = jax_tokens[case]
    assert len(set(tokens.ravel().tolist())) > 1  # not one repeated token
    for r in ranks:
        np.testing.assert_array_equal(r[case]["tokens"], tokens)
        np.testing.assert_array_equal(r[case]["num_generated"], num)
