"""Kernels C and 16's split-KV arithmetic on the CPU:
`decode_attention_fused_split_plain` (the valid columns cut into `splits`
chunks as the CUDA kernel cuts them, each chunk's softmax sums merged with
the current token) and its read-only sibling `decode_attention_split_plain`
(kernel 16: write_pos inclusive, the block_s clip, no current token folded
in) against the Pallas kernels they replace in interpret mode, the chunking
itself over random layouts, and the splits chooser.

Tolerance 1e-5 in fp32: the split and the Pallas kernel's blocks take the
same sums in another order. The CUDA kernel is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.ops import decode_attention as tdec

TOL = dict(rtol=1e-5, atol=1e-5)
D = 64


def _inputs(seed, b, kh, g, s, n_layers=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh * g, D)).astype(np.float32)
    k_all, v_all = (rng.standard_normal((n_layers, b, kh, s, D)).astype(np.float32)
                    for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, kh, D)).astype(np.float32) for _ in range(2))
    return q, k_all, v_all, k_new, v_new


@functools.lru_cache(maxsize=None)
def _pallas(seed, b, kh, g, s, layer, plens, pad, wpos):
    """JAX's decode_attention_fused in interpret mode: (out, k_all', v_all')."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_fused

    q, k_all, v_all, k_new, v_new = _inputs(seed, b, kh, g, s)
    out, k2, v2 = decode_attention_fused(
        *(jnp.asarray(x) for x in (q, k_all, v_all, k_new, v_new)),
        jnp.asarray(layer, jnp.int32), prompt_lens=jnp.asarray(plens, jnp.int32),
        write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad, block_s=128, interpret=True)
    return np.asarray(out), np.asarray(k2), np.asarray(v2)


def _check_split(seed, b, kh, g, s, plens, pad, wpos, splits, layer=1):
    ref, k_ref, v_ref = _pallas(seed, b, kh, g, s, layer, plens, pad, wpos)
    q, k_all, v_all, k_new, v_new = (torch.from_numpy(x) for x in _inputs(seed, b, kh, g, s))
    out = tdec.decode_attention_fused_split_plain(
        q, k_all, v_all, k_new, v_new, layer, prompt_lens=torch.tensor(plens, dtype=torch.int32),
        write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=pad, splits=splits)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the cache equals the Pallas kernel's: column write_pos written, the rest as it was
    np.testing.assert_array_equal(k_all.numpy(), k_ref)
    np.testing.assert_array_equal(v_all.numpy(), v_ref)
    assert tdec.launches == 0  # a CPU tensor never launches a kernel


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 8, 16])
def test_split_plain_matches_pallas(g, splits):
    """Two rows of different prompt lengths (142 and 79 valid columns)."""
    _check_split(0, 2, 2, g, 256, (100, 37), 128, 170, splits)


@pytest.mark.parametrize("plens,pad,wpos,splits", [
    # 40 + 40 columns in two chunks: the edge between them is prompt_len - 1 | prompt_pad
    ((40, 40), 64, 104, 2),
    # 4 + 3 columns in chunks of 3: the last chunk is the one column write_pos - 1
    ((4, 4), 8, 11, 3),
    # row 0: one column for 16 CTAs, 15 chunks empty; row 1: prompt only (write_pos = pad)
    ((1, 30), 64, 64, 16),
    # more CTAs than columns in both rows, ragged: 3 and 5 columns over 8 chunks
    ((2, 4), 100, 101, 8),
])
def test_split_plain_chunk_edges_and_empty_chunks(plens, pad, wpos, splits):
    _check_split(1, 2, 2, 4, 128, plens, pad, wpos, splits)


@settings(max_examples=200, deadline=None, database=None)
@given(st.data())
def test_split_chunks_cover_the_valid_columns_once(data):
    """Over B, K and prompt_len <= prompt_pad <= write_pos < S: the chooser's
    chunks cover every valid column exactly once, never the gap
    [prompt_len, prompt_pad), never write_pos."""
    b = data.draw(st.integers(1, 32), "B")
    kh = data.draw(st.sampled_from([1, 2, 4, 8]), "K")
    s = data.draw(st.integers(1, 600), "S")
    wpos = data.draw(st.integers(0, s - 1), "write_pos")
    pad = data.draw(st.integers(0, wpos), "prompt_pad")
    plen = data.draw(st.integers(0, pad), "prompt_len")
    splits = tdec.decode_splits(b, kh, sms=data.draw(st.sampled_from([66, 132]), "SMs"))
    cols = tdec.valid_columns(plen, pad, wpos, s)
    seen = [c for f0, f1 in tdec.split_bounds(len(cols), splits) for c in cols[f0:f1]]
    assert sorted(seen) == sorted(set(seen))  # once each
    assert set(seen) == set(range(plen)) | set(range(pad, wpos))
    assert all(not plen <= c < pad for c in seen) and wpos not in seen
    bounds = tdec.split_bounds(len(cols), splits)
    assert len(bounds) == splits and all(f1 - f0 <= -(-len(cols) // splits) for f0, f1 in bounds)


@pytest.mark.parametrize("b,kh,want", [
    (1, 8, 8),     # the bench: 8 clusters of 8 CTAs (16 measured slower)
    (2, 8, 8),     # phase 2's B = 2: 128 CTAs
    (4, 8, 8),     # 256 CTAs: two waves of 132 SMs
    (8, 8, 4),     # ... held to two waves
    (24, 8, 2),    # B = 24: 192 clusters, two CTAs each
])
def test_decode_splits_fills_about_two_waves(b, kh, want):
    assert tdec.decode_splits(b, kh) == want



@functools.lru_cache(maxsize=None)
def _pallas_read(seed, b, kh, g, s, layer, plens, pad, wpos, block_s):
    """JAX's decode_attention_stacked (kernel 16's reference) in interpret mode."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_stacked

    q, k_all, v_all, _, _ = _inputs(seed, b, kh, g, s)
    out = decode_attention_stacked(
        *(jnp.asarray(x) for x in (q, k_all, v_all)), jnp.asarray(layer, jnp.int32),
        prompt_lens=jnp.asarray(plens, jnp.int32), write_pos=jnp.asarray(wpos, jnp.int32),
        prompt_pad=pad, block_s=block_s, interpret=True)
    return np.asarray(out)


# three rows over a 512-column cache, block_s 128, prompt_pad 256, write_pos
# 262 (the TPU kernel visits blocks 0-2, columns < 384): a prompt past
# write_pos and past the last visited block (cut at 384), a short one (37 +
# 7 columns), and one past prompt_pad inside the visited blocks (300)
READ_LAYOUT = dict(plens=(400, 37, 300), pad=256, wpos=262, block_s=128)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 8, 16])
def test_read_split_plain_matches_pallas(g, splits):
    """Kernel 16's split mirror against `_decode_kernel`, the cache unchanged."""
    lay = READ_LAYOUT
    ref = _pallas_read(2, 3, 2, g, 512, 1, lay["plens"], lay["pad"], lay["wpos"], lay["block_s"])
    q, k_all, v_all, _, _ = (torch.from_numpy(x) for x in _inputs(2, 3, 2, g, 512))
    k_ref, v_ref = k_all.clone(), v_all.clone()
    out = tdec.decode_attention_split_plain(
        q, k_all, v_all, torch.tensor(1, dtype=torch.int32),
        prompt_lens=torch.tensor(lay["plens"], dtype=torch.int32),
        write_pos=torch.tensor(lay["wpos"], dtype=torch.int32), prompt_pad=lay["pad"],
        splits=splits, block_s=lay["block_s"])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)
    assert tdec.launches_stacked == 0  # a CPU tensor never launches a kernel


def test_read_split_plain_gives_nan_rows_past_the_stack():
    """A layer outside [0, L) gives NaN rows, as kernel 16 writes them."""
    q, k_all, v_all, _, _ = (torch.from_numpy(x) for x in _inputs(0, 2, 2, 4, 128))
    kw = dict(prompt_lens=torch.tensor([5, 9], dtype=torch.int32),
              write_pos=torch.tensor(70, dtype=torch.int32), prompt_pad=64, splits=4)
    for layer in (-1, 2):
        out = tdec.decode_attention_split_plain(
            q, k_all, v_all, torch.tensor(layer, dtype=torch.int32), **kw)
        assert out.shape == q.shape and torch.isnan(out).all()


@settings(max_examples=200, deadline=None, database=None)
@given(st.data())
def test_read_split_chunks_cover_the_valid_columns_once(data):
    """Over B, K, block_s | S and prompt_pad <= write_pos < S, with prompt
    lengths up to S: kernel 16's chunks cover every valid column exactly
    once, write_pos included, nothing past the last block the TPU kernel
    visits, and chunks past the columns are empty."""
    b = data.draw(st.integers(1, 32), "B")
    kh = data.draw(st.sampled_from([1, 2, 4, 8]), "K")
    block_s = data.draw(st.sampled_from([8, 16, 64, 128]), "block_s")
    s = block_s * data.draw(st.integers(1, 8), "blocks")
    wpos = data.draw(st.integers(0, s - 1), "write_pos")
    pad = data.draw(st.integers(0, wpos), "prompt_pad")
    plen = data.draw(st.integers(0, s), "prompt_len")
    splits = data.draw(st.sampled_from([tdec.decode_splits(b, kh), 1, 3, 16]), "splits")
    cols = tdec.valid_columns_read(plen, pad, wpos, s, block_s)
    end = (wpos // block_s + 1) * block_s
    want = {c for c in range(s) if (c < plen or pad <= c <= wpos) and c < end}
    seen = [c for f0, f1 in tdec.split_bounds(len(cols), splits) for c in cols[f0:f1]]
    assert len(seen) == len(set(seen)) == len(cols)  # once each
    assert set(seen) == want and wpos in want
    assert all(f0 == f1 for f0, f1 in tdec.split_bounds(len(cols), splits)
               if f0 >= len(cols))
