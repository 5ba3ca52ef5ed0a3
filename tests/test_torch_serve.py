"""The PyTorch port's continuous-batching engine (serve/engine.py) on the
CPU at gar_tiny in fp32, with slots != kv heads (2): token for token
against the port's `generate` (itself held against JAX's by
tests/test_torch_model.py; `test_engine_matches_jax_generate` also checks
JAX `generate` directly) in every scheduling mode: per-token steps (plain
and weight-stream paged steps), windows through the pages and the burst
path, chunked prefill, staggered admission and an early eot.

Greedy tokens must be equal. The int8 window cache is held to half a
quantization step of its input on every column it keeps.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import load_flat_params
from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
from grasp_any_region_tpu_torch.models.gar import GARBatch
from grasp_any_region_tpu_torch.models import generate as tgen
from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig
from grasp_any_region_tpu_torch.serve import paged_cache as tpc

F32 = torch.float32
MAX_NEW = 7
BASE = dict(page_size=16, num_pages=128, max_pages_per_slot=64, max_new_tokens=MAX_NEW,
            eot_id=-1, mask_compat=False)


def _shorten(batch, plen, short):
    """The request with its last `short` prompt tokens turned into right
    padding (prompt_len < S)."""
    n = plen - short
    ids, seg, pos = (x.clone() for x in (batch.input_ids, batch.segment_ids, batch.positions))
    ids[0, n:], seg[0, n:], pos[0, n:] = 0, 0, n - 1
    return batch._replace(input_ids=ids, segment_ids=seg, positions=pos), n


@pytest.fixture(scope="module")
def tiny():
    """JAX gar_tiny params (random mask_embed, decoder projections scaled
    by 10 so greedy decoding does not repeat one token, as
    tests/test_torch_model.py builds them), the same tree in the port, three
    same-shape requests (the second one's prompt 12 tokens short of S), and
    each request's tokens from the port's generate."""
    from grasp_any_region_tpu.models import init_gar_params

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")
    reqs = []
    for seed in range(3):
        batch, _, plens = synthetic_batch(cfg_t, batch=1, grid=(1, 1), seed=seed, device="cpu")
        reqs.append((batch, int(plens[0])))
    reqs[1] = _shorten(*reqs[1], 12)
    expected = [_generate(tparams, cfg_t, b, n) for b, n in reqs]
    return dict(cfg_j=cfg_j, cfg=cfg_t, jparams=params, params=tparams, reqs=reqs,
                expected=expected)


def _generate(params, cfg, batch, plen, eot_id=-1):
    """The port's generate at fp32, its KV cache too: generate seeds a bf16
    cache whatever the compute dtype (as JAX's does), while the engine's
    pools take the engine's dtype, and at fp32 compute the bf16 cache moves
    the logits by about 2e-3 of their range, enough to flip a near tie."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "seed_cache_from_prefill",
                   functools.partial(tgen.seed_cache_from_prefill, dtype=F32))
        res = tgen.generate(params, cfg, batch, torch.tensor([plen]), max_new_tokens=MAX_NEW,
                            eot_id=eot_id, mask_compat=False, compute_dtype=F32)
    return res.tokens[0, : int(res.num_generated[0])].tolist()


def _engine(tiny, **kw):
    return ContinuousBatchingEngine(tiny["params"], tiny["cfg"], EngineConfig(**{**BASE, **kw}),
                                    dtype=F32, device="cpu")


def _run(eng, reqs, on_event=None):
    ids = [eng.submit(b, n) for b, n in reqs]
    out = eng.run(on_event)
    return [out[i] for i in ids]


@pytest.mark.parametrize("mode", ["per_token", "per_token_fused", "windowed", "burst"])
def test_engine_matches_generate(tiny, mode):
    """3 requests over 3 slots (the page budget admits two in the first
    group): per-token steps through the plain paged step or the
    weight-stream one, windows of 3 (a burst window, then windows through
    the pages), and one window of the whole budget (burst only, no pool
    traffic). Every page returns to the free list."""
    kw = dict(per_token={}, per_token_fused=dict(use_fused=True), windowed=dict(decode_chunk=3),
              burst=dict(decode_chunk=MAX_NEW))[mode]
    eng = _engine(tiny, slots=3, **kw)
    assert _run(eng, tiny["reqs"]) == tiny["expected"]
    assert eng.allocator.free_pages == BASE["num_pages"] - 1
    assert eng.counts["prefill_groups"] == 2 and eng.counts["prefill_rows"] == 3
    steps = eng.counts.get("window_steps", 0)
    if mode.startswith("per_token"):
        assert eng.counts["token_steps"] == 12 and steps == 0  # (6 + 6) cycles of all slots
    elif mode == "windowed":
        assert eng.counts["gathers"] >= 1 and eng.counts["fresh_windows"] == 2
    else:  # every window a burst of slots that all finish in it
        assert eng.counts["windows"] == eng.counts["fresh_windows"] == 2
        assert "gathers" not in eng.counts and "flushes" not in eng.counts


def test_engine_matches_jax_generate(tiny):
    """The windowed engine's tokens equal JAX generate's at fp32 (its
    compute dtype patched from bf16, as tests/test_torch_model.py does, and
    its cache's dtype as `_generate` patches the port's)."""
    from grasp_any_region_tpu.models import gar as jg

    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    batch = GARBatch(*(jnp.asarray(torch.cat(xs).numpy()) for xs in zip(*(b for b, _ in tiny["reqs"]))))
    plens = jnp.asarray([n for _, n in tiny["reqs"]], jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "gar_prefill", functools.partial(jg.gar_prefill, compute_dtype=jnp.float32))
        mp.setattr(jmod, "gar_decode_step",
                   functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32))
        mp.setattr(jmod, "seed_cache_from_prefill",
                   functools.partial(jg.seed_cache_from_prefill, dtype=jnp.float32))
        jgen = jax.jit(jmod.generate.__wrapped__,
                       static_argnames=("cfg", "max_new_tokens", "eot_id", "mask_compat"))
        ref = jgen(tiny["jparams"], tiny["cfg_j"], batch, plens, max_new_tokens=MAX_NEW,
                   eot_id=-1, mask_compat=False)
    got = _run(_engine(tiny, slots=3, decode_chunk=4), tiny["reqs"])
    assert got == np.asarray(ref.tokens).tolist()


def test_burst_path_matches_gather_path(tiny):
    """The burst path (prefill K/V straight into the window cache) and the
    gather path (pages seeded, then gathered) give the same tokens bit for
    bit, and after the first window the survivors' pages hold the same
    values: the prompt seeded, then the window's K/V flushed on top (seeded
    after the flush, the window's columns would read back as zeros)."""
    pools, tokens = [], []
    for burst in (True, False):
        eng = _engine(tiny, slots=3, decode_chunk=3)
        if not burst:
            eng._burst = lambda live: False
        ids = [eng.submit(b, n) for b, n in tiny["reqs"][:2]]
        cycles = iter([True, False])
        real_has_work = eng.has_work
        eng.has_work = lambda: next(cycles)  # one engine cycle: one window
        eng.run()
        assert eng.counts.get("fresh_windows", 0) == int(burst)
        pages = [eng.slots[s].pages for s in range(2)]
        pools.append([p[:, :, sum(pages, [])].clone() for p in (eng.k_pool, eng.v_pool)])
        last = eng.seq_lens[0] - 1  # the window's last token of slot 0
        assert eng.k_pool[:, :, eng.block_table[0, last // 16], last % 16].abs().sum() > 0
        eng.has_work = real_has_work
        out = eng.run()
        tokens.append([out[i] for i in ids])
    assert tokens[0] == tokens[1] == tiny["expected"][:2]
    for a, b in zip(*pools):
        assert torch.equal(a, b)


def test_chunked_prefill_equals_whole(tiny):
    """A request queued while a slot decodes advances its decoder sweep
    100 prompt tokens a cycle (9 chunks over its 822): the same tokens as
    whole-prompt admission."""
    eng = _engine(tiny, slots=2, decode_chunk=3, prefill_chunk=100)
    b0, n0 = tiny["reqs"][0]
    b1, n1 = tiny["reqs"][2]
    r0 = eng.submit(b0, n0)
    eng._admit(defer_tok0=True)
    assert eng.active.any()
    r1 = eng.submit(b1, n1)
    out = eng.run()
    assert eng.counts["prefill_chunks"] == -(-n1 // 100) and eng.counts["prefill_groups"] == 1
    assert eng.counts["tower_passes"] == 2
    assert [out[r0], out[r1]] == [tiny["expected"][0], tiny["expected"][2]]


@pytest.mark.parametrize("decode_chunk", [1, 3])
def test_staggered_admission(tiny, decode_chunk):
    """Two requests fill two slots; the third is submitted after two steps
    (or in the first window's events) and is admitted when a slot frees:
    every request gets the tokens it gets alone."""
    eng = _engine(tiny, slots=2, decode_chunk=decode_chunk)
    ids = [eng.submit(*req) for req in tiny["reqs"][:2]]
    if decode_chunk == 1:
        eng.step()
        eng.step()
        ids.append(eng.submit(*tiny["reqs"][2]))
        out = eng.run()
    else:
        def on_event(ev):
            if len(ids) == 2:
                ids.append(eng.submit(*tiny["reqs"][2]))

        out = eng.run(on_event)
        assert eng.counts["windows"] > eng.counts["fresh_windows"] >= 2
    assert [out[i] for i in ids] == tiny["expected"]
    assert eng.allocator.free_pages == BASE["num_pages"] - 1


def test_eot_early_exit(tiny):
    """An eot that request 0 emits at its third token: it stops there, mid
    window, its slot goes to the third request, and every request's tokens
    equal generate's with that eot."""
    eot = tiny["expected"][0][2]
    expected = [_generate(tiny["params"], tiny["cfg"], b, n, eot_id=eot) for b, n in tiny["reqs"]]
    assert len(expected[0]) == 3
    eng = _engine(tiny, slots=2, eot_id=eot, decode_chunk=MAX_NEW)
    assert _run(eng, tiny["reqs"]) == expected


@pytest.mark.parametrize("chunk", [1, 4])
def test_events_stream_full_sequence(tiny, chunk):
    """The StepEvents rebuild every request's whole token list (tok0 too,
    and requests that finish at admission: max_new_tokens 1), and the last
    event of each is done."""
    for max_new in (1, 5):
        eng = _engine(tiny, slots=2, decode_chunk=chunk, max_new_tokens=max_new)
        streamed, dones = {}, {}

        def on_event(ev):
            streamed.setdefault(ev.request_id, []).append(ev.token)
            dones[ev.request_id] = ev.done

        for b, n in tiny["reqs"]:
            eng.submit(b, n)
        out = eng.run(on_event)
        assert streamed == out and len(out) == 3, (max_new, streamed, out)
        assert all(len(t) == max_new for t in out.values()) and all(dones.values())


def test_int8_window(tiny):
    """quantize_kv: the window cache is int8 with one scale per (layer,
    slot, kv-head pair) and decodes through C8's plain version; its
    dequantized values are within half a scale of the gathered cache on
    the kept columns, the masked ones are 0; the engine runs every request
    to its budget and returns every page."""
    eng = _engine(tiny, slots=3, decode_chunk=3, quantize_kv=True)
    out = _run(eng, tiny["reqs"])
    vocab = tiny["cfg"].extended_vocab_size
    assert all(len(t) == MAX_NEW and all(0 <= x < vocab for x in t) for t in out)
    assert eng.allocator.free_pages == BASE["num_pages"] - 1

    gen = torch.Generator().manual_seed(0)
    kd = torch.randn((2, 3, 2, 512, 16), generator=gen)
    seq_lens, s_base = torch.tensor([100, 37, 0], dtype=torch.int32), 112
    kq, vq, ksc, vsc = eng._quantize_dense(kd.clone(), kd.clone(), seq_lens, s_base)
    assert kq.dtype == torch.int8 and ksc.shape == (2, 3, 1, 1, 1)
    deq = kq.float() * ksc.repeat_interleave(2, dim=2)
    cols = torch.arange(512)
    kept = ((cols[None, :] < seq_lens[:, None]) | (cols[None, :] >= s_base))[None, :, None, :, None]
    err = torch.where(kept, (deq - kd).abs(), 0.0)
    assert (err <= 0.5 * ksc.repeat_interleave(2, dim=2) + 1e-7).all()
    assert (torch.where(kept, 0.0, deq) == 0).all()


def test_int8_window_zeroes_masked_columns(tiny):
    """The one departure of the int8 window from JAX: its amax skips the
    masked columns [seq_len, s_base) (they hold stale or trash-page values
    on the gather path). With a large value there, JAX's scale would be
    1.5 * 50 / 127; the port's is 1.5 * the kept columns' amax / 127."""
    eng = _engine(tiny, slots=3, decode_chunk=3, quantize_kv=True)
    kd = torch.full((1, 1, 2, 512, 16), 0.25)
    kd[0, 0, 1, 200, 3] = -2.0  # a kept window column
    kd[0, 0, 0, 120, 0] = 50.0  # a masked column: seq_len 100, s_base 128
    _, _, ksc, _ = eng._quantize_dense(kd.clone(), kd.clone(), torch.tensor([100], dtype=torch.int32), 128)
    jax_style = kd.abs().amax() * 1.5 / 127
    assert torch.allclose(ksc.flatten(), torch.tensor([2.0 * 1.5 / 127]))
    assert ksc.flatten()[0] < jax_style / 20


def test_latency_stats_with_no_finished_request(tiny):
    eng = _engine(tiny, slots=2)
    eng.submit(*tiny["reqs"][0])
    stats = eng.latency_stats()
    assert stats == dict(n=0, ttft_p50_s=None, ttft_p95_s=None, latency_p50_s=None,
                         latency_p95_s=None, tok_per_s=None)
    assert len(eng.req_stats) == 1  # the queued request's stats stay


def test_latency_stats_prunes_finished_requests(tiny):
    """Each call reports the requests finished since the last one and drops
    them from req_stats, so a long-running engine keeps no record of them."""
    eng = _engine(tiny, slots=3, decode_chunk=4)
    _run(eng, tiny["reqs"])
    stats = eng.latency_stats()
    assert stats["n"] == 3 and not eng.req_stats
    assert 0 < stats["ttft_p50_s"] <= stats["ttft_p95_s"] <= stats["latency_p95_s"]
    assert stats["latency_p50_s"] <= stats["latency_p95_s"] and stats["tok_per_s"] > 0
    _run(eng, tiny["reqs"][:1])
    assert eng.latency_stats()["n"] == 1 and not eng.req_stats
    assert eng.latency_stats()["n"] == 0


def test_pages_needed_matches_budget(tiny):
    """A request's pages cover its prompt, its budget and one more token,
    and the block-table row lists them in allocation order."""
    eng = _engine(tiny, slots=3)
    b, n = tiny["reqs"][0]
    eng.submit(b, n)
    eng._admit()
    pages = eng.slots[0].pages
    assert len(pages) == tpc.pages_needed(n + MAX_NEW + 1, 16)
    assert eng.block_table[0, : len(pages)].tolist() == pages
    assert not eng.block_table[0, len(pages):].any()
