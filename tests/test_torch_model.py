"""The PyTorch port's GAR model against the JAX package at gar_tiny in fp32:
same JAX-initialised parameters (flattened to numpy and loaded into the
port), same synthetic batch.

`mask_embed` is zero at init, which would leave the mask path untested, so
both trees get the same seeded random values. The decoder's projections are
scaled by 10: at the init std of 0.02 the tied embedding's self-logit
dominates and greedy decoding repeats one token, which would make the
token-for-token check say little.

Tolerance about 1e-4 for whole towers in fp32: the frameworks take the same
sums in another order, and a few layers compound the fp32 rounding.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg

TOWER = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


def _variant(mod, name):
    cfg = mod.gar_tiny()
    if name == "tiny":  # erf GELU, no rope scaling
        return cfg
    # gar_1b's numerics at tiny widths: tanh GELU, llama3 rope scaling 32
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, fast_gelu=True),
        text=dataclasses.replace(cfg.text, rope_scaling_factor=32.0))


def _ragged(batch, prompt_lens, short):
    """Shorten row 1 of a synthetic batch by `short` tokens (right padding)."""
    ids, seg, pos = (np.array(x) for x in (batch.input_ids, batch.segment_ids,
                                            batch.positions))
    lens = np.array(prompt_lens)
    n = lens[1] - short
    ids[1, n:], seg[1, n:], pos[1, n:] = 0, 0, n - 1
    lens[1] = n
    return dict(input_ids=ids, segment_ids=seg, positions=pos), lens


@pytest.fixture(scope="module", params=["tiny", "tiny_1b_numerics"])
def pair(request):
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    cfg_j, cfg_t = _variant(jcfg, request.param), _variant(tcfg, request.param)
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")

    jb, _, jlens = jsb(cfg_j, batch=2, grid=(2, 1), seed=0)
    tb, _, _ = tsb(cfg_t, batch=2, grid=(2, 1), seed=0, device="cpu")
    fields, lens = _ragged(jb, jlens, 12)
    jb = jb._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tb._replace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params,
                tparams=tparams, jb=jb, tb=tb, jlens=jnp.asarray(lens),
                tlens=torch.from_numpy(lens))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOWER))


def test_vision_tower_and_block_taps(pair):
    from grasp_any_region_tpu.models import gar as jg, vision as jv
    from grasp_any_region_tpu_torch.models import gar as tg, vision as tv

    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    jb, tb = pair["jb"], pair["tb"]
    pix_j = jb.pixel_values[0]  # the 5 tiles of sample 0
    msk_j = jb.mask_values[0]
    pix_t, msk_t = tb.pixel_values[0], tb.mask_values[0]
    me_j = jg.mask_patch_embed(pair["params"], cfg_j,
                               jg.decode_mask_values(cfg_j, msk_j, compat=True))
    me_t = tg.mask_patch_embed(pair["tparams"], cfg_t,
                               tg.decode_mask_values(cfg_t, msk_t, compat=True))
    _close(me_t, me_j, rtol=1e-5, atol=1e-5)

    vp_j, vp_t = pair["params"]["vision"], pair["tparams"].vision
    x_j, ang_j = jv.vision_embed(vp_j, cfg_j.vision, pix_j, me_j, compute_dtype=jnp.float32)
    x_t, ang_t = tv.vision_embed(vp_t, cfg_t.vision, pix_t, me_t, compute_dtype=F32)
    _close(x_t, x_j)
    depth = cfg_j.vision.depth
    for i in range(depth):
        bp_j = jax.tree_util.tree_map(lambda a: a[i], vp_j["blocks"])
        x_j = jv._block(cfg_j.vision, x_j, bp_j, ang_j[i], use_flash=False)
        x_t = tv._block(cfg_t.vision, x_t, vp_t.blocks.layer(i), ang_t[i])
        if i in {0, depth // 2, depth - 1}:
            _close(x_t, x_j, err_msg=f"vision block {i}", **TOWER)

    ref = jv.vision_forward(vp_j, cfg_j.vision, pix_j, me_j, compute_dtype=jnp.float32)
    out = tv.vision_forward(vp_t, cfg_t.vision, pix_t, me_t, compute_dtype=F32)
    _close(out, ref)


def test_build_prefill_embeds(pair):
    from grasp_any_region_tpu.models.gar import build_prefill_embeds as jbuild
    from grasp_any_region_tpu_torch.models.gar import build_prefill_embeds as tbuild

    ref = jbuild(pair["params"], pair["cfg_j"], pair["jb"], compute_dtype=jnp.float32)
    out = tbuild(pair["tparams"], pair["cfg_t"], pair["tb"], compute_dtype=F32)
    _close(out, ref)


def test_llama_prefill_and_decode_step(pair):
    from grasp_any_region_tpu.models import gar as jg, llama as jl
    from grasp_any_region_tpu_torch.models import gar as tg, llama as tl

    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    embeds = jg.build_prefill_embeds(pair["params"], cfg_j, pair["jb"],
                                     compute_dtype=jnp.float32)
    h_j, kv_j = jl.llama_prefill(pair["params"]["llm"], cfg_j.text, embeds,
                                 pair["jb"].positions, segment_ids=pair["jb"].segment_ids)
    h_t, kv_t = tl.llama_prefill(pair["tparams"].llm, cfg_t.text,
                                 torch.from_numpy(np.array(embeds)), pair["tb"].positions,
                                 segment_ids=pair["tb"].segment_ids)
    _close(h_t, h_j)
    _close(kv_t[0], kv_j[0])
    _close(kv_t[1], kv_j[1])

    s = embeds.shape[1]
    max_len = (s // 512 + 1) * 512
    cache_j = jg.seed_cache_from_prefill(cfg_j, kv_j, pair["jlens"], max_len,
                                         dtype=jnp.float32)
    cache_t = tg.seed_cache_from_prefill(cfg_t, kv_t, pair["tlens"], max_len, dtype=F32)
    tok = np.array([42, 1234], np.int32)
    logits_j, cache_j = jg.gar_decode_step(pair["params"], cfg_j, jnp.asarray(tok), cache_j,
                                           s, compute_dtype=jnp.float32, use_kernel=False)
    logits_t, cache_t = tg.gar_decode_step(pair["tparams"], cfg_t, torch.from_numpy(tok),
                                           cache_t, s, compute_dtype=F32)
    _close(logits_t, logits_j)
    _close(cache_t.k, cache_j.k)
    _close(cache_t.v, cache_j.v)
    assert int(cache_t.write_pos) == int(cache_j.write_pos) == s + 1


@pytest.mark.parametrize("pair", ["tiny"], indirect=True)
def test_generate_greedy_tokens_match_jax(pair):
    """Greedy tokens equal token for token, and num_generated equal, on a
    batch of 2 with different prompt lengths and a forced eot in one row.

    JAX `generate` fixes the compute dtype of its prefill and decode step at
    bf16; the test runs it at fp32 by patching that argument (a fresh jit,
    so no trace cached at bf16 is reused), the port at fp32 by its argument.
    """
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.models.generate import generate as tgen

    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    n_new = 12
    free = tgen(pair["tparams"], cfg_t, pair["tb"], pair["tlens"], max_new_tokens=n_new,
                eot_id=-1, compute_dtype=F32).tokens.numpy()
    # force an eot in row 1 only: a token it emits at step >= 2 that row 0 never does
    eot = next(int(t) for t in free[1, 2:] if t not in free[0])

    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    orig = jmod.generate.__wrapped__
    patched = {
        "gar_prefill": functools.partial(jg.gar_prefill, compute_dtype=jnp.float32),
        "gar_decode_step": functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32),
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in patched.items():
            mp.setattr(jmod, name, fn)
        jgen = jax.jit(orig, static_argnames=("cfg", "max_new_tokens", "eot_id"))
        ref = jgen(pair["params"], cfg_j, pair["jb"], pair["jlens"],
                   max_new_tokens=n_new, eot_id=eot)
    out = tgen(pair["tparams"], cfg_t, pair["tb"], pair["tlens"], max_new_tokens=n_new,
               eot_id=eot, compute_dtype=F32)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.num_generated.numpy(), np.asarray(ref.num_generated))
    assert out.num_generated[0] == n_new and out.num_generated[1] < n_new


@pytest.mark.parametrize("pair", ["tiny"], indirect=True)
def test_generate_sampling_and_early_exit(pair, monkeypatch):
    """Temperature sampling is reproducible from a seeded generator and
    near-greedy at a tiny temperature; once every row is done the loop stops
    at the next eot check, and the output is what the full loop would give."""
    from grasp_any_region_tpu_torch.models import generate as tgen_mod

    cfg, params, batch, lens = pair["cfg_t"], pair["tparams"], pair["tb"], pair["tlens"]
    kw = dict(max_new_tokens=8, eot_id=-1, compute_dtype=F32)
    runs = [tgen_mod.generate(params, cfg, batch, lens, temperature=0.8,
                              generator=torch.Generator().manual_seed(7), **kw)
            for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert ((runs[0].tokens >= 0) & (runs[0].tokens < cfg.extended_vocab_size)).all()
    greedy = tgen_mod.generate(params, cfg, batch, lens, **kw).tokens
    cold = tgen_mod.generate(params, cfg, batch, lens, temperature=1e-6,
                             generator=torch.Generator().manual_seed(7), **kw).tokens
    assert torch.equal(cold, greedy)

    # two copies of row 0, so one eot (its token at step 1) ends both rows
    n_new = tgen_mod.EOT_CHECK_EVERY + 8
    eot = int(greedy[0, 1])
    batch = type(batch)(*(x[[0, 0]] for x in batch))
    lens = lens[[0, 0]]
    steps = []
    real_step = tgen_mod.gar_decode_step
    monkeypatch.setattr(tgen_mod, "gar_decode_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    out = tgen_mod.generate(params, cfg, batch, lens, max_new_tokens=n_new, eot_id=eot,
                            compute_dtype=F32)
    if not bool((out.num_generated < n_new).all()):
        pytest.fail(f"eot {eot} did not end every row: {out.tokens}")
    assert len(steps) == tgen_mod.EOT_CHECK_EVERY  # stopped at the first check
    for row, n in enumerate(out.num_generated.tolist()):
        assert int(out.tokens[row, n - 1]) == eot
        assert (out.tokens[row, n:] == 0).all()


# The port's bf16 gap is held to a small multiple of JAX's: the two frameworks
# round to bf16 at other points (PERF.md, ROADMAP section 3), so neither gap
# is zero, and a port that rounded more often, or in a worse place, than JAX
# would widen its gap past this multiple.
BF16_GAP_RATIO = 1.25


@pytest.mark.parametrize("pair", ["tiny_1b_numerics"], indirect=True)
def test_bf16_prefill_gap_tracks_jax(pair):
    """The default-bf16 prefill's hidden state against the same model's
    fp32 state, in each framework, at gar_tiny with GAR-1B's numerics and B
    = 2: max |h_bf16 - h_fp32| / max |h_fp32| of the port is at most
    BF16_GAP_RATIO times JAX's. Not a token-for-token claim at bf16."""
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.models import gar as tg

    def gap(lo, hi):
        lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        return float(np.abs(lo - hi).max() / np.abs(hi).max())

    h_j = {dt: jg.gar_prefill(pair["params"], pair["cfg_j"], pair["jb"], compute_dtype=dt)[0]
           for dt in (jnp.bfloat16, jnp.float32)}
    h_t = {dt: tg.gar_prefill(pair["tparams"], pair["cfg_t"], pair["tb"],
                              compute_dtype=dt)[0].float().numpy()
           for dt in (torch.bfloat16, F32)}
    gap_j = gap(h_j[jnp.bfloat16], h_j[jnp.float32])
    gap_t = gap(h_t[torch.bfloat16], h_t[F32])
    print(f"bf16 gap to fp32: port {gap_t:.4f}, JAX {gap_j:.4f}")
    assert 0 < gap_j < 0.1
    assert gap_t <= BF16_GAP_RATIO * gap_j, (gap_t, gap_j)
