"""ROADMAP.md section 3, watch 1, held to JAX: the first-token logits of a
batch of 8 ragged rows in bf16 against each row prefilled alone, in the
port and in JAX, on the same parameters and inputs (gar_tiny with GAR-1B's
numerics, tanh GELU and llama3 rope scaling, the decoder projections
scaled by 10 as in tests/test_torch_model.py; one tile a row).

gap = max |logits(batch) - logits(alone)| / max |logits(alone)| over the
valid vocab; the port's gap is held within BF16_GAP_RATIO times JAX's, as
`test_bf16_prefill_gap_tracks_jax` holds the prefill's bf16 gap. Not a
token-for-token claim at bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from torch_ranks import numpy_fields

BF16_GAP_RATIO = 1.25
B = 8


def _variant(mod):
    cfg = dataclasses.replace(mod.gar_tiny(), max_num_tiles=1)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, fast_gelu=True),
        text=dataclasses.replace(cfg.text, rope_scaling_factor=32.0))


@pytest.fixture(scope="module")
def logits():
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu.models.llama import lm_logits as jax_logits
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.models import gar as tg
    from grasp_any_region_tpu_torch.models.llama import lm_logits

    cfg_j, cfg_t = _variant(jcfg), _variant(tcfg)
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")

    batch, _, lens = synthetic_batch(cfg_j, batch=B, grid=(1, 1), seed=5)
    fields, lens = numpy_fields(batch), np.array(lens)
    for b in range(B):  # row b right-padded by 3 b tokens
        n = lens[b] - 3 * b
        for key, fill in (("input_ids", 0), ("segment_ids", 0), ("positions", n - 1)):
            fields[key] = fields[key].copy()
            fields[key][b, n:] = fill
        lens[b] = n

    @jax.jit
    def jax_first(batch, lens):
        h, _ = jg.gar_prefill(params, cfg_j, batch, compute_dtype=jnp.bfloat16)
        last = h[jnp.arange(h.shape[0]), lens - 1]
        return jax_logits(params["llm"], cfg_j.text, last, valid_vocab=cfg_j.extended_vocab_size)

    @torch.inference_mode()
    def port_first(fields, lens):
        from torch_ranks import _batch

        h, _ = tg.gar_prefill(tparams, cfg_t, _batch(fields), compute_dtype=torch.bfloat16)
        last = h[torch.arange(h.shape[0]), torch.from_numpy(lens).long() - 1]
        return lm_logits(tparams.llm, cfg_t.text, last,
                         valid_vocab=cfg_t.extended_vocab_size).float().numpy()

    def rows(i):
        return {k: None if v is None else v[i:i + 1] for k, v in fields.items()}

    def jax_run(f, lens):
        jb = type(batch)(**{k: None if v is None else jnp.asarray(v) for k, v in f.items()})
        return np.asarray(jax_first(jb, jnp.asarray(lens)), np.float32)

    v = cfg_t.extended_vocab_size
    return dict(
        port=(port_first(fields, lens)[:, :v],
              np.concatenate([port_first(rows(i), lens[i:i + 1]) for i in range(B)])[:, :v]),
        jax=(jax_run(fields, lens)[:, :v],
             np.concatenate([jax_run(rows(i), lens[i:i + 1]) for i in range(B)])[:, :v]))


def _gap(batched, alone) -> float:
    return float(np.abs(batched - alone).max() / np.abs(alone).max())


def test_bf16_batch_against_alone_gap_tracks_jax(logits):
    gap_t, gap_j = _gap(*logits["port"]), _gap(*logits["jax"])
    print(f"bf16 batch-of-8 against alone: port {gap_t:.3e}, JAX {gap_j:.3e}")
    assert 0 < gap_j < 0.1
    assert gap_t <= BF16_GAP_RATIO * gap_j, (gap_t, gap_j)


def test_bf16_batch_rows_keep_their_alone_greedy_token(logits):
    """Each row's first greedy token is its token alone, in the port (as in
    JAX here)."""
    batched, alone = logits["port"]
    np.testing.assert_array_equal(batched.argmax(-1), alone.argmax(-1))
