"""Kernels 19 and 20 on the weight stream, on the CPU: the segment table's
plan (`layer_matmul.segment_plan`), the finishers' columns and rope pairs
(`layer_matmul.finisher_cols`), the cluster-size chooser (`qkv_splits`),
the one-segment plans of H, H8, I and I8, and the mirrors that follow the
kernels' partition and order (`layer_qkv_norm_rope_stream_plain`,
`layer_qkv_norm_rope_q8_stream_plain`) against the JAX package's Pallas
kernels in interpret mode.

Tolerance 1e-5 (rtol and atol) in fp32, as tests/test_torch_mega.py: the
same sums in another order, and the int8 scale on the sum where JAX puts
it on the widened weight. D = 1032 is not a multiple of a stage (128 rows),
so every cluster size gives its CTAs other K ranges. The CUDA kernels are
held against these mirrors on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.models import quantize as tq
from grasp_any_region_tpu_torch.ops import decode_megakernel as tmk
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

TOL = dict(rtol=1e-5, atol=1e-5)
L, LAYER, D, HQ, HK, DH, EPS = 3, 1, 1032, 192, 64, 64, 1e-5


@functools.lru_cache(maxsize=None)
def _case(q8: bool, b: int):
    """Seeded inputs (numpy, fp32; int8 weights with their scales), the
    port's (B, 64) rope rows and JAX's tiled tables, and the Pallas
    kernel's q, k, v in interpret mode at layer LAYER."""
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    rng = np.random.default_rng(1000 * b + q8)
    x = rng.standard_normal((b, D)).astype(np.float32)
    norm = (1.0 + 0.2 * rng.standard_normal((L, D))).astype(np.float32)
    ws = [(rng.standard_normal((L, D, n)) * D ** -0.5).astype(np.float32) for n in (HQ, HK, HK)]
    ang = rng.uniform(0, 40, (b, DH // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], -1)
    rows = (np.cos(ang), np.sin(ang))
    tiled = tuple(np.tile(r, (1, n // DH)) for n in (HQ, HK) for r in rows)
    if q8:
        mats = [a for w in ws for a in (t.numpy() for t in tq.quantize_int8(torch.from_numpy(w)))]
        fn = jmk.layer_qkv_norm_rope_q8
    else:
        mats, fn = ws, jmk.layer_qkv_norm_rope
    ref = fn(*map(jnp.asarray, (x, norm, *mats, *tiled)), jnp.asarray(LAYER, jnp.int32), eps=EPS,
             head_dim=DH, interpret=True)
    return x, norm, mats, rows, tiled, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("tables", ["rows", "tiled"])
@pytest.mark.parametrize("b", [1, 3, 17])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("q8", [False, True], ids=["19", "20"])
def test_qkv_stream_mirror_matches_pallas(q8, splits, b, tables):
    """The mirror of kernel 19 or 20 (its segments, tiles, CTAs' stages,
    ranks, finishers' pairs, scales, rope) at 1-8 CTAs a tile against JAX's
    kernel, with (B, 64) rope rows or JAX's tiled (B, N) tables; nothing
    launches."""
    x, norm, mats, rows, tiled, ref = _case(q8, b)
    tabs = (*rows, *rows) if tables == "rows" else tiled
    mirror = (tmk.layer_qkv_norm_rope_q8_stream_plain if q8
              else tmk.layer_qkv_norm_rope_stream_plain)
    before = dict(tmk.launches)
    out = mirror(*map(torch.from_numpy, (x, norm, *mats, *tabs)), LAYER, eps=EPS, head_dim=DH,
                 splits=splits)
    assert tmk.launches == before
    for o, r, n in zip(out, ref, (HQ, HK, HK)):
        assert o.shape == (b, n)
        np.testing.assert_allclose(o.numpy(), r, **TOL)


@settings(max_examples=200, deadline=None, database=None)
@given(st.data())
def test_segment_plan_covers_every_column_once_and_every_pair_has_one_finisher(data):
    """Over q, k and v widths (whole heads of 64), Din, the weight type and
    every cluster size the rope finishers take (up to a tile's columns / 8):
    the grid's column tiles are q's, then k's, then v's, each split over the
    ranks in order with one k_split; the tiles cover each segment's columns
    once; each tile column has one finisher, holding it in runs of 4 (the
    16-byte pieces); a roped finisher holds each first half (c % 64 < 32)
    with its partner c + 32 half its list later, so a real column's
    partner is real too."""
    hq = 64 * data.draw(st.integers(1, 40), "hq / 64")
    hk = 64 * data.draw(st.integers(1, 12), "hk / 64")
    din = 8 * data.draw(st.integers(1, 600), "Din / 8")
    n = data.draw(st.sampled_from([tlm.STREAM_N, tlm.stream_n(torch.int8)]), "tile width")
    splits = data.draw(st.sampled_from([s for s in (1, 2, 4, 8, 16) if s <= n // 8]), "splits")
    douts = (hq, hk, hk)
    plan = tlm.segment_plan(douts, din, splits, n)
    tiles = [-(-dout // n) for dout in douts]
    assert len(plan) == sum(tiles) * splits
    assert [(s, t) for s, t, r, _, _ in plan[::splits]] == [
        (s, t) for s in range(3) for t in range(tiles[s])]
    assert [r for _, _, r, _, _ in plan] == list(range(splits)) * sum(tiles)
    ranges = {r: (k0, k1) for _, r, k0, k1 in tlm.stream_plan(din, n, splits, n)}
    assert all((k0, k1) == ranges[r] for _, _, r, k0, k1 in plan)  # one k_split
    for s, dout in enumerate(douts):
        cols = sorted(c for seg, t, r, _, _ in plan if seg == s and r == 0
                      for c in range(t * n, min(dout, (t + 1) * n)))
        assert cols == list(range(dout))
    for rope in (False, True):
        fin = tlm.finisher_cols(n, splits, rope)
        assert sorted(c for cols in fin for c in cols) == list(range(n))
        for cols in fin:
            assert len(cols) == n // splits
            assert all(cols[i + 3] - cols[i] == 3 for i in range(0, len(cols), 4))
            if rope:
                half = len(cols) // 2
                for i in range(half):
                    assert cols[i] % 64 < 32 and cols[i + half] == cols[i] + 32
                    for t in range(-(-hq // n)):  # a real column's partner is real
                        assert (t * n + cols[i] < hq) == (t * n + cols[i + half] < hq)


@pytest.mark.parametrize("hq,hk,d,itemsize,sms,want", [
    (2048, 512, 2048, 2, 132, 4),   # GAR-1B, 19: 48 tiles, within two CTAs an SM
    (2048, 512, 2048, 1, 132, 8),   # GAR-1B, 20: 24 tiles of 128
    (2048, 512, 2048, 2, 66, 2),    # half the SMs: half the CTAs
    (256, 64, 256, 2, 132, 2),      # the narrow config: a CTA keeps at least one stage
    (64, 64, 8192, 2, 132, 8),      # 19's rope finishers: at most 8 a 64-column tile
    (128, 128, 8192, 1, 132, 8),    # the stream's cluster limit (20 could take 16)
])
def test_qkv_splits(hq, hk, d, itemsize, sms, want):
    tiles = tlm.qkv_tiles(hq, hk, itemsize)
    assert tmk.qkv_splits(tiles, d, itemsize, sms=sms) == want
    assert want <= tmk.box_cols(itemsize) // 8  # at least 4 pairs a finisher


@pytest.mark.parametrize("key,din,dout,n,per_sm,want", [
    ("H", 8192, 2048, 64, tlm.STREAM_CTAS_PER_SM, 8),      # w_down (wo: din 2048, also 8)
    ("H8", 8192, 2048, 128, tlm.STREAM_CTAS_PER_SM, 8),
    ("I", 2048, 8192, 64, tlm.STREAM_CTAS_PER_SM, 2),
    ("I8", 2048, 8192, 128, tlm.STREAM_CTAS_PER_SM_Q8, 2),
])
def test_one_segment_plans_are_the_streams(key, din, dout, n, per_sm, want):
    """H, H8, I and I8 run the segment table with one segment: their CTAs'
    tiles and K ranges are `stream_plan`'s, their finishers hold contiguous
    runs, and the chooser's cluster sizes at GAR-1B stay 8, 8, 2, 2."""
    splits = tlm.stream_splits(-(-dout // n), din, sms=132, ctas_per_sm=per_sm)
    assert splits == want
    assert tlm.segment_plan((dout,), din, splits, n) == [
        (0, *p) for p in tlm.stream_plan(din, dout, splits, n)]
    cols = n // splits
    assert tlm.finisher_cols(n, splits) == [list(range(q * cols, (q + 1) * cols))
                                            for q in range(splits)]
