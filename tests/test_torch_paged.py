"""The PyTorch port's paged KV cache, paged attention, paged decode steps
and chunked prefill against the JAX package's, at gar_tiny in fp32 on the
CPU (slots 3 != kv heads 2, so a (B, K, D) / (K, B, D) transpose in a
scatter cannot pass unseen).

Tolerances: scatters and gathers move values and must be bit-equal; page 0
(the trash page) is left out of pool comparisons, since a scatter may write
it more than once and which write wins is not fixed. Attention and decode
steps in fp32 are held to 1e-5 and 1e-4 (sums in another order, compounded
over layers), as tests/test_torch_model.py holds the towers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params
from grasp_any_region_tpu.models import llama as jl
from grasp_any_region_tpu.ops.paged_attention import paged_attention_reference as j_paged
from grasp_any_region_tpu.serve import paged_cache as jpc
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import load_flat_params
from grasp_any_region_tpu_torch.models import llama as tl
from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm
from grasp_any_region_tpu_torch.ops.paged_attention import paged_attention_reference as t_paged
from grasp_any_region_tpu_torch.serve import paged_cache as tpc

STEP = dict(rtol=1e-4, atol=1e-4)
ATTN = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: the port's scatters write in place


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or STEP))


def _pools_equal(port, ref):
    """Pools (L, K, N, PS, D) bit-equal outside the trash page 0."""
    np.testing.assert_array_equal(port.numpy()[:, :, 1:], np.asarray(ref)[:, :, 1:])


@pytest.fixture(scope="module")
def tiny():
    """JAX gar_tiny params (decoder projections scaled by 10, as
    tests/test_torch_model.py does) and the same tree in the port."""
    from grasp_any_region_tpu.models import init_gar_params

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    return cfg_j, cfg_t, params, load_flat_params(flatten_params(params), cfg_t, device="cpu")


def _paged_state(rng, cfg, slots=3, ps=16, n=32, mp=4):
    """Random pools, a block table of distinct random pages a slot (the
    last entry of slot 2 the trash page), lengths and an inactive slot."""
    tc = cfg.text
    shape = (tc.num_layers, tc.num_kv_heads, n, ps, tc.head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, n))[: slots * mp].reshape(slots, mp).astype(np.int32)
    bt[2, -1] = 0
    seq_lens = np.array([30, 17, 5], np.int32)
    active = np.array([True, True, False])
    return k_pool, v_pool, bt, seq_lens, active


@pytest.mark.parametrize("b,s,h,kh,ps", [(3, 100, 4, 2, 32), (2, 64, 8, 8, 16), (5, 33, 4, 1, 8)])
def test_paged_attention_matches_jax(rng, b, s, h, kh, ps):
    """Over random pools and block tables (some entries the trash page),
    rows of lengths 1..S."""
    d, n = 16, 40
    mp = -(-s // ps)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k_pages = rng.standard_normal((kh, n, ps, d)).astype(np.float32)
    v_pages = rng.standard_normal((kh, n, ps, d)).astype(np.float32)
    bt = rng.integers(0, n, (b, mp)).astype(np.int32)
    seq_lens = rng.integers(1, s + 1, b).astype(np.int32)
    seq_lens[0] = s
    ref = j_paged(*map(jnp.asarray, (q, k_pages, v_pages, bt, seq_lens)))
    out = t_paged(*map(_t, (q, k_pages, v_pages, bt, seq_lens)))
    _close(out, ref, **ATTN)


def test_page_allocator_matches_jax():
    """The same page ids for the same alloc / release sequence; page 0 is
    never handed out; an allocation past the free pages returns None."""
    pj, pt = jpc.PageAllocator(9), tpc.PageAllocator(9)
    for op, arg in (("alloc", 3), ("alloc", 2), ("release", [2, 5]), ("alloc", 4),
                    ("release", [1]), ("alloc", 1), ("alloc", 5), ("alloc", 1)):
        got_j, got_t = getattr(pj, op)(arg), getattr(pt, op)(arg)
        assert got_t == got_j and pt.free_pages == pj.free_pages, (op, arg)
        assert got_t is None or 0 not in got_t
    for tokens, ps in ((1, 16), (16, 16), (17, 16), (0, 16), (4919, 64)):
        assert tpc.pages_needed(tokens, ps) == jpc.pages_needed(tokens, ps)
    with pytest.raises(ValueError, match="not an allocatable page"):
        pt.release([0])


def test_prompt_and_token_pages_match_jax(rng):
    """write_prompt_pages (a trash-page tail) then append_token_pages (one
    slot inactive) give JAX's pools; read back through the block table, the
    prompt and the appended tokens are where they belong."""
    l, s, kh, d, ps, n, b = 2, 37, 2, 8, 16, 12, 3
    k_pool = rng.standard_normal((l, kh, n, ps, d)).astype(np.float32)
    v_pool = rng.standard_normal((l, kh, n, ps, d)).astype(np.float32)
    k_new = rng.standard_normal((l, s, kh, d)).astype(np.float32)
    v_new = rng.standard_normal((l, s, kh, d)).astype(np.float32)
    bt = np.array([[5, 2, 7, 0], [3, 9, 0, 0], [4, 1, 6, 8]], np.int32)
    jk, jv = jpc.write_prompt_pages(jnp.asarray(k_pool), jnp.asarray(v_pool),
                                    jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(bt[0]), s)
    tk, tv = tpc.write_prompt_pages(_t(k_pool), _t(v_pool), _t(k_new), _t(v_new), _t(bt[0]), s)
    _pools_equal(tk, jk)
    _pools_equal(tv, jv)
    got = tk.numpy()[:, :, bt[0, :3]].reshape(l, kh, 3 * ps, d)[:, :, :s].transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got, k_new)
    wpos = np.array([s, 20, 47], np.int32)
    active = np.array([True, False, True])
    for t in range(2):
        kt = rng.standard_normal((l, b, kh, d)).astype(np.float32)
        vt = rng.standard_normal((l, b, kh, d)).astype(np.float32)
        jk, jv = jpc.append_token_pages(jk, jv, jnp.asarray(kt), jnp.asarray(vt),
                                        jnp.asarray(bt), jnp.asarray(wpos + t),
                                        jnp.asarray(active))
        tpc.append_token_pages(tk, tv, _t(kt), _t(vt), _t(bt), _t(wpos + t), _t(active))
        _pools_equal(tk, jk)
        _pools_equal(tv, jv)
        p = wpos[2] + t  # slot 2's token
        np.testing.assert_array_equal(tk.numpy()[:, :, bt[2, p // ps], p % ps], kt[:, 2])


def test_append_inactive_writes_trash_page():
    l, kh, d, ps, n = 1, 2, 8, 4, 4
    k_pool, v_pool = torch.zeros((l, kh, n, ps, d)), torch.zeros((l, kh, n, ps, d))
    kt = torch.ones((l, 1, kh, d))
    tpc.append_token_pages(k_pool, v_pool, kt, kt, torch.tensor([[2, 3]], dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32), torch.tensor([False]))
    assert k_pool[:, :, 1:].abs().sum() == 0 and v_pool[:, :, 1:].abs().sum() == 0
    assert k_pool[:, :, 0].abs().sum() > 0


@pytest.mark.parametrize("window", [4, 500])
def test_gather_and_flush_match_jax(rng, window):
    """gather_pages_dense (the unpaired layout, total rounded up to 512)
    and flush_window_pages (counts 0..window, one slot at 0) give JAX's
    dense caches and pools."""
    l, kh, d, ps, n, b, mp = 2, 2, 8, 16, 120, 3, 36
    s_base = 64
    k_pool = rng.standard_normal((l, kh, n, ps, d)).astype(np.float32)
    v_pool = rng.standard_normal((l, kh, n, ps, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n))[: b * mp].reshape(b, mp).astype(np.int32)
    bt[1, 20:] = 0
    jkd, jvd = jpc.gather_pages_dense(jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(bt),
                                      s_base, window, paired=False)
    tkd, tvd = tpc.gather_pages_dense(_t(k_pool), _t(v_pool), _t(bt), s_base, window)
    assert tuple(tkd.shape) == jkd.shape == (l, b, kh, ((s_base + window + 511) // 512) * 512, d)
    np.testing.assert_array_equal(tkd.numpy(), np.asarray(jkd))
    np.testing.assert_array_equal(tvd.numpy(), np.asarray(jvd))

    k_dense = rng.standard_normal(tkd.shape).astype(np.float32)
    v_dense = rng.standard_normal(tkd.shape).astype(np.float32)
    start = np.array([37, 64, 5], np.int32)
    counts = np.array([min(window, 4), 0, window], np.int32)
    jk, jv = jpc.flush_window_pages(jnp.asarray(k_pool), jnp.asarray(v_pool),
                                    jnp.asarray(k_dense), jnp.asarray(v_dense), jnp.asarray(bt),
                                    jnp.asarray(start), jnp.asarray(counts), s_base, window)
    tk, tv = tpc.flush_window_pages(_t(k_pool), _t(v_pool), _t(k_dense), _t(v_dense), _t(bt),
                                    _t(start), _t(counts), s_base, window)
    _pools_equal(tk, jk)
    _pools_equal(tv, jv)
    p = start[2] + window - 1  # slot 2's last window token
    np.testing.assert_array_equal(tk.numpy()[:, :, bt[2, p // ps], p % ps],
                                  k_dense[:, 2, :, s_base + window - 1])


@pytest.mark.parametrize("form", ["xla", "fused", "fused_int8"])
def test_decode_step_paged_matches_jax(rng, tiny, form):
    """llama_decode_step_paged (the XLA form) and llama_decode_step_paged_fused
    (on the CPU its kernels' plain versions; JAX's Pallas kernels in
    interpret mode), in fp32 and with int8 decode weights: hidden and the
    written pools; the fused form launches no kernel here."""
    cfg_j, cfg_t, params_j, params_t = tiny
    tc = cfg_t.text
    if form == "fused_int8":
        from grasp_any_region_tpu.models.quantize import quantize_decode_weights as jq

        params_j = jq(params_j)
        params_t = quantize_decode_weights(params_t)
    k_pool, v_pool, bt, seq_lens, active = _paged_state(rng, cfg_t)
    embeds = rng.standard_normal((3, 1, tc.hidden_size)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (embeds, k_pool, v_pool, bt, seq_lens, active)]
    targs = [_t(x) for x in (embeds, k_pool, v_pool, bt, seq_lens, active)]
    if form == "xla":
        ref = jl.llama_decode_step_paged(params_j["llm"], cfg_j.text, *jargs)
        out = tl.llama_decode_step_paged(params_t.llm, tc, *targs)
    else:
        ref = jl.llama_decode_step_paged_fused(params_j["llm"], cfg_j.text, *jargs,
                                               interpret=True)
        before = dict(tlm.launches)
        out = tl.llama_decode_step_paged_fused(params_t.llm, tc, *targs)
        assert tlm.launches == before
    _close(out[0], ref[0])
    assert out[1] is targs[1] and out[2] is targs[2]  # in place
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[:, :, 1:], np.asarray(want)[:, :, 1:], **STEP)
    # only the active slots' new positions changed, outside page 0
    changed = np.argwhere(np.abs(out[1].numpy() - k_pool)[:, :, 1:].max(axis=(0, 1, 4)) > 0)
    want = {(bt[b, seq_lens[b] // 16] - 1, seq_lens[b] % 16) for b in range(3) if active[b]}
    assert {tuple(x) for x in changed} == want


def test_paged_fused_matches_paged_xla(rng, tiny):
    """The two paged forms of the port against each other on the same
    pools (the fused form's rounding points differ only at fp32 noise)."""
    _, cfg_t, _, params_t = tiny
    k_pool, v_pool, bt, seq_lens, active = _paged_state(rng, cfg_t)
    embeds = _t(rng.standard_normal((3, 1, cfg_t.text.hidden_size)).astype(np.float32))
    a = tl.llama_decode_step_paged(params_t.llm, cfg_t.text, embeds, _t(k_pool), _t(v_pool),
                                   _t(bt), _t(seq_lens), _t(active))
    b = tl.llama_decode_step_paged_fused(params_t.llm, cfg_t.text, embeds, _t(k_pool),
                                         _t(v_pool), _t(bt), _t(seq_lens), _t(active))
    for x, y in zip(a, b):
        _close(x, y.numpy())


def test_prefill_chunk_matches_jax_and_whole(rng, tiny):
    """llama_prefill_chunk chunk by chunk (a ragged last chunk) equals JAX's
    chunk by chunk, and its last hidden rows and K/V equal one whole
    llama_prefill over the same embeds."""
    cfg_j, cfg_t, params_j, params_t = tiny
    b, s, chunk = 2, 45, 16
    embeds = rng.standard_normal((b, s, cfg_t.text.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kv_j = kv_t = None
    hiddens = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        h_j, kv_j = jl.llama_prefill_chunk(params_j["llm"], cfg_j.text,
                                           jnp.asarray(embeds[:, c0:c1]),
                                           jnp.asarray(pos[:, c0:c1]), kv_j, use_flash=False)
        h_t, kv_t = tl.llama_prefill_chunk(params_t.llm, cfg_t.text, _t(embeds[:, c0:c1]),
                                           _t(pos[:, c0:c1]), kv_t)
        _close(h_t, h_j)
        _close(kv_t[0], kv_j[0])
        _close(kv_t[1], kv_j[1])
        hiddens.append(h_t)
    whole, kv_whole = tl.llama_prefill(params_t.llm, cfg_t.text, _t(embeds), _t(pos))
    assert kv_t[0].shape == kv_whole[0].shape == (cfg_t.text.num_layers, b, s, 2, 16)
    _close(torch.cat(hiddens, dim=1), whole.numpy())
    _close(kv_t[0], kv_whole[0].numpy())
    _close(kv_t[1], kv_whole[1].numpy())
