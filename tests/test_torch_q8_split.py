"""Kernels C8 and I8 on their Hopper bodies, on the CPU: the mirrors of
their arithmetic against the Pallas kernels they replace in interpret mode,
and I8's work plan.

C8 runs kernel C's split-KV body on the int8 cache:
`decode_attention_fused_q8_split_plain` (the history dequantized to
bf16(int8 * scale), the valid columns cut into `splits` chunks as the CUDA
kernel cuts them, the new column quantized and the current token folded in
dequantized) against JAX's `decode_attention_fused` on its paired int8
cache (`_fused_kernel_paired` with kv_q8). The written cache is bit-equal:
both quantize the same bf16 K/V with the same fp32 division and round half
to even. The output: both round p to bf16 before PV, the mirror against
its chunk's max and the TPU kernel against its block's running max, so
each p may differ by two bf16 roundings (2^-8 of it) and the output by
2^-8 of V's largest magnitude; that is the tolerance at random q. With
q = 0 every p is exactly 1 on both sides and the output is the mean of V
over the valid columns and the current token, held at 1e-5 of its range:
one column too many, too few or twice moves a row far more.

I8 runs kernel H's TMA-fed weight stream with two int8 weights a stage:
`layer_swiglu_q8_stream_plain` (the kernel's partition of K over a
cluster, 128-column tiles, its order of summation) against JAX's
`layer_swiglu_q8`, at 1e-5 of the output's range: the Pallas kernel scales
the widened weight before the fp32 sum, the port scales the sum after it.
The CUDA kernels are held against these mirrors on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

D = 64
BLOCK_S = 64  # the TPU kernel's block of cache columns: several blocks a row


def _pair(a):
    """The port's (L, B, K, S, D) cache -> JAX's paired (L, B, K/2, S, 2D)."""
    n, b, kh, s, d = a.shape
    return a.reshape(n, b, kh // 2, 2, s, d).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, kh // 2, s, 2 * d)


def _unpair(paired, kh):
    """JAX's paired (L, B, K/2, S, 2D) cache -> the port's (L, B, K, S, D)."""
    a = np.asarray(paired)
    n, b, kp, s, d2 = a.shape
    return a.reshape(n, b, kp, s, 2, d2 // 2).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, kh, s, d2 // 2)


def _q8_inputs(seed, b, kh, g, s, zero_q, n_layers=2):
    """q (fp32), the int8 cache, its (layer, row, pair) scales and the new
    K/V (bf16 values, held as fp32)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh * g, D)).astype(np.float32) * (0 if zero_q else 1)
    kq, vq = (rng.integers(-127, 128, (n_layers, b, kh, s, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.03, (n_layers, b, kh // 2, 1, 1)).astype(np.float32)
              for _ in range(2))
    kn, vn = (np.asarray(jnp.asarray(rng.standard_normal((b, kh, D)), jnp.bfloat16)
                         .astype(jnp.float32)) for _ in range(2))
    return q, kq, vq, ks, vs, kn, vn


@functools.lru_cache(maxsize=None)
def _pallas_q8(seed, b, kh, g, s, zero_q, layer, plens, pad, wpos):
    """JAX's decode_attention_fused on the paired int8 cache in interpret
    mode: (out, k_all', v_all') with the caches unpaired."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_fused

    q, kq, vq, ks, vs, kn, vn = _q8_inputs(seed, b, kh, g, s, zero_q)
    out, k2, v2 = decode_attention_fused(
        jnp.asarray(q), jnp.asarray(_pair(kq)), jnp.asarray(_pair(vq)),
        jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jnp.asarray(layer, jnp.int32), prompt_lens=jnp.asarray(plens, jnp.int32),
        write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad, block_s=BLOCK_S,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    return np.asarray(out, np.float32), _unpair(k2, kh), _unpair(v2, kh)


def _check_q8_split(seed, b, kh, g, s, plens, pad, wpos, splits, zero_q, layer=1):
    ref, k_ref, v_ref = _pallas_q8(seed, b, kh, g, s, zero_q, layer, plens, pad, wpos)
    q, kq, vq, ks, vs, kn, vn = (torch.from_numpy(np.array(x))
                                 for x in _q8_inputs(seed, b, kh, g, s, zero_q))
    out = tdec.decode_attention_fused_q8_split_plain(
        q, kq, vq, kn.to(torch.bfloat16), vn.to(torch.bfloat16), layer, k_scale=ks, v_scale=vs,
        prompt_lens=torch.tensor(plens, dtype=torch.int32),
        write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=pad, splits=splits)
    # the cache equals the TPU kernel's bit for bit: column write_pos quantized, the rest kept
    np.testing.assert_array_equal(kq.numpy(), k_ref)
    np.testing.assert_array_equal(vq.numpy(), v_ref)
    assert (kq[layer, :, :, wpos] != torch.from_numpy(
        _q8_inputs(seed, b, kh, g, s, zero_q)[1][layer, :, :, wpos])).any()
    span = np.abs(ref).max()
    if zero_q:  # every p is 1: the mean of V over the valid columns and the current token
        np.testing.assert_allclose(out.numpy() / span, ref / span, rtol=1e-5, atol=1e-5)
    else:  # p rounded to bf16 against another max on each side
        v_max = (vq[layer].float() * vs[layer].repeat_interleave(2, dim=1)).abs().max().item()
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2.0 ** -8 * v_max)
    assert tdec.launches_q8 == 0  # a CPU tensor never launches a kernel


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_q8_split_plain_matches_pallas(g, splits):
    """Two rows of different prompt lengths (142 and 79 valid columns) over
    two kv-head pairs, each (layer, row, pair) with its own scales."""
    _check_q8_split(0, 2, 4, g, 256, (100, 37), 128, 170, splits, zero_q=False)


@pytest.mark.parametrize("plens,pad,wpos,splits", [
    # 40 + 40 columns in two chunks: the edge between them is prompt_len - 1 | prompt_pad
    ((40, 40), 64, 104, 2),
    # 4 + 3 columns in chunks of 3: the last chunk is the one column write_pos - 1
    ((4, 4), 8, 11, 3),
    # row 0: one column for 8 CTAs, 7 chunks empty; row 1: prompt only (write_pos = pad)
    ((1, 30), 64, 64, 8),
    # more CTAs than columns in both rows, ragged: 3 and 5 columns over 8 chunks
    ((2, 4), 100, 101, 8),
])
def test_q8_split_plain_chunk_edges_and_empty_chunks(plens, pad, wpos, splits):
    """q = 0 (every p exactly 1, so the output is a mean over the columns
    attended): chunks that meet the interval edges, a one-column last
    chunk, and empty chunks."""
    _check_q8_split(1, 2, 2, 4, 128, plens, pad, wpos, splits, zero_q=True)


@pytest.mark.parametrize("batch,want", [(1, 16), (2, 16), (4, 8), (24, 2)])
def test_q8_splits(batch, want):
    """C8's CTAs a (kv head, row) at GAR-1B's 8 kv heads: up to 16 (half of
    C's bytes a column), within two waves of 132 SMs."""
    assert tdec.decode_splits(batch, 8, sms=132, max_splits=tdec.MAX_SPLITS_Q8) == want


@settings(max_examples=200, deadline=None, database=None)
@given(st.data())
def test_stream_plan_covers_every_int8_column_and_row_once(data):
    """I8's plan at 128-column tiles, over Din (a multiple of 8), Dout (of
    16) and the chooser's cluster size (or any power of two up to 16): the
    tiles cover [0, Dout) once, and the CTAs of a tile split [0, Din) into
    contiguous ranges in rank order, each starting on a stage."""
    n = tlm.stream_n(torch.int8)
    assert n == 2 * tlm.STREAM_N == 128
    din = 8 * data.draw(st.integers(1, 1100), "Din / 8")
    dout = 16 * data.draw(st.integers(1, 150), "Dout / 16")
    tiles = -(-dout // n)
    splits = data.draw(st.sampled_from(
        [tlm.stream_splits(tiles, din, sms=132), tlm.stream_splits(tiles, din, sms=66),
         1, 2, 4, 8, 16]), "splits")
    plan = tlm.stream_plan(din, dout, splits, n)
    assert len(plan) == tiles * splits
    cols = sorted(c for t in range(tiles) for c in range(t * n, min(dout, (t + 1) * n)))
    assert cols == list(range(dout))
    for t in range(tiles):
        ranges = [(k0, k1) for tt, _, k0, k1 in plan if tt == t]
        assert [r for tt, r, _, _ in plan if tt == t] == list(range(splits))
        assert ranges[0][0] == 0 and ranges[-1][1] == din
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(k0 == k1 or k0 % tlm.STREAM_BK == 0 for k0, k1 in ranges)


@pytest.mark.parametrize("m,din,sms,want", [
    (8192, 2048, 132, 2),  # GAR-1B's gate and up: 64 tiles x 2 = 128 CTAs, one an SM
    (8192, 2048, 66, 1),   # half the SMs: half the CTAs
    (1024, 256, 132, 2),   # the narrow config: a CTA keeps at least one stage
    (128, 8192, 132, 8),   # one tile: the cluster stays within 8 CTAs
])
def test_stream_splits_at_int8_widths(m, din, sms, want):
    """I8's chooser (one CTA an SM) at int8 tile widths."""
    tiles = -(-m // tlm.stream_n(torch.int8))
    assert tlm.stream_splits(tiles, din, sms=sms, ctas_per_sm=tlm.STREAM_CTAS_PER_SM_Q8) == want


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("b,din,m", [
    (1, 200, 144),    # part stages of rows and a part tile of 128 columns
    (5, 1032, 272),   # three tiles, the last of 16 columns; rank 3 of 4 a part stage
    (24, 520, 400),   # two row tiles of x; some ranks without rows at 4 CTAs
])
def test_swiglu_q8_stream_plain_matches_pallas(rng, b, din, m, splits):
    """The I8 mirror in the kernel's order of summation against JAX's
    layer_swiglu_q8 at the first and the last layer; the wrapper on a CPU
    tensor launches nothing."""
    from grasp_any_region_tpu.ops.layer_matmul import layer_swiglu_q8

    n_layers = 3
    x = rng.standard_normal((b, din)).astype(np.float32)
    wg, wu = (rng.integers(-127, 128, (n_layers, din, m)).astype(np.int8) for _ in range(2))
    sg, su = (rng.uniform(0.5, 1.5, (n_layers, 1, m)).astype(np.float32) * din ** -0.5 / 73
              for _ in range(2))
    for layer in (0, n_layers - 1):
        ref = np.asarray(layer_swiglu_q8(
            jnp.asarray(x), jnp.asarray(wg), jnp.asarray(sg), jnp.asarray(wu), jnp.asarray(su),
            jnp.asarray(layer, jnp.int32), interpret=True))
        out = tlm.layer_swiglu_q8_stream_plain(
            *(torch.from_numpy(a) for a in (x, wg, sg, wu, su)), layer, splits)
        span = np.abs(ref).max()
        np.testing.assert_allclose(out.numpy() / span, ref / span, rtol=1e-5, atol=1e-5)
    assert tlm.launches["I8"] == 0
