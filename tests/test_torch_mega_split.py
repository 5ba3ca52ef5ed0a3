"""Kernels 21-23's partition and order on the CPU: the split plain versions
`layer_mlp_residual_split_plain` (the MLP tiles' K-split gate and up, each
tile's w_down column blocks, the tile-ordered sum) and
`decode_attention_wo_split_plain` (kernel C's chunks and merge, the wo
column slices, the head-ordered sum) against the Pallas kernels they
mirror in interpret mode, the two launch plans over random shapes, the
ordered sum and the MLP's splits chooser.

Tolerance 1e-5 in fp32, as tests/test_torch_mega.py: the split and the
Pallas kernels take the same sums in another order. The CUDA kernels are
held against the plain versions and these mirrors on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.models import quantize as tq
from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import decode_megakernel as tmk

TOL = dict(rtol=1e-5, atol=1e-5)
L, LAYER, DH, EPS = 3, 1, 64, 1e-5


def _no_launches():
    return not any(tmk.launches.values()) and tdec.launches == 0


def _w(rng, *shape):
    return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)


def _q8(w):
    q, s = tq.quantize_int8(torch.from_numpy(w))
    return q.numpy(), s.numpy()


@functools.lru_cache(maxsize=None)
def _mlp_inputs(b, q8, d=256, m=512):
    """x, the norm, the weights (int8: interleaved with their scales)."""
    rng = np.random.default_rng(b * 10 + q8)
    x = rng.standard_normal((b, d)).astype(np.float32)
    norm = (1.0 + 0.2 * rng.standard_normal((L, d))).astype(np.float32)
    ws = _w(rng, L, d, m), _w(rng, L, d, m), _w(rng, L, m, d)
    mats = [a for w in ws for a in _q8(w)] if q8 else list(ws)
    return x, norm, mats


@functools.lru_cache(maxsize=None)
def _mlp_pallas(b, q8):
    """JAX's layer_mlp_residual(_q8) in interpret mode, four grid steps."""
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    x, norm, mats = _mlp_inputs(b, q8)
    fn = jmk.layer_mlp_residual_q8 if q8 else jmk.layer_mlp_residual
    return np.asarray(fn(*map(jnp.asarray, (x, norm, *mats)), jnp.asarray(LAYER, jnp.int32),
                         eps=EPS, block_n=128, interpret=True))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_form", "int8"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_mlp_split_plain_matches_pallas(q8, b, splits):
    """Kernels 23 and 21's mirror (d = 256, m = 512: four tiles) against the
    Pallas kernel: one CTA a tile; two; eight, where the last ranks get no K
    rows (int8: k_split rounds up to a 64-row stage) and most get no w_down
    block."""
    x, norm, mats = _mlp_inputs(b, q8)
    t = [torch.from_numpy(a) for a in (x, norm, *mats)]
    if q8:
        weights, scales = (t[2], t[4], t[6]), (t[3], t[5], t[7])
    else:
        weights, scales = tuple(t[2:]), None
    out = tmk.layer_mlp_residual_split_plain(t[0], t[1], *weights, LAYER, eps=EPS, splits=splits,
                                             scales=scales)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _mlp_pallas(b, q8), **TOL)
    assert _no_launches()


@functools.lru_cache(maxsize=None)
def _attention_inputs(b, q8, dm):
    """JAX's own case (tests/test_kernels.py): 4 query heads over 2 kv heads
    of 64, S = 64, ragged prompt_lens, a mid-cache write_pos; wo (L, 256,
    dm)."""
    rng = np.random.default_rng(100 + b * 10 + q8)
    plens = np.array([17, 30, 9][:b], np.int32)
    q = rng.standard_normal((b, 4, DH)).astype(np.float32)
    k_all, v_all = (rng.standard_normal((L, b, 2, 64, DH)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, 2, DH)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((b, dm)).astype(np.float32)
    wo = _w(rng, L, 4 * DH, dm)
    wo, wo_scale = _q8(wo) if q8 else (wo, None)
    return (q, k_all, v_all, k_new, v_new, wo, x), wo_scale, plens, 32, 35


@functools.lru_cache(maxsize=None)
def _attention_pallas(b, q8, dm):
    """JAX's decode_attention_wo in interpret mode (block_s 16): the new
    residual and the cache."""
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    arrays, wo_scale, plens, pad, wpos = _attention_inputs(b, q8, dm)
    out = jmk.decode_attention_wo(
        *map(jnp.asarray, arrays), jnp.asarray(LAYER, jnp.int32),
        prompt_lens=jnp.asarray(plens), write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad,
        wo_scale=None if wo_scale is None else jnp.asarray(wo_scale), block_s=16,
        interpret=True)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("q8", [False, True], ids=["fp32_wo", "int8_wo"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_attention_wo_split_plain_matches_pallas(q8, b, splits):
    """Kernel 22's mirror against the Pallas kernel: the new residual and the
    whole cache (column write_pos written in place). The residual is 320
    wide (5 fp32-form chunks of 64, 3 int8 chunks of 128), so at 3 and 8
    CTAs the wo slices are ragged and some CTAs own none; at 8 CTAs most of
    the 19-33 valid columns' chunks are short or empty."""
    dm = 320
    arrays, wo_scale, plens, pad, wpos = _attention_inputs(b, q8, dm)
    jx, jk, jv = _attention_pallas(b, q8, dm)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    out = tmk.decode_attention_wo_split_plain(
        *t, LAYER, prompt_lens=torch.from_numpy(plens),
        write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=pad, splits=splits,
        wo_scale=None if wo_scale is None else torch.from_numpy(wo_scale))
    np.testing.assert_allclose(out.numpy(), jx, **TOL)
    np.testing.assert_array_equal(t[1].numpy(), jk)
    np.testing.assert_array_equal(t[2].numpy(), jv)
    assert _no_launches()


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_mlp_plan_covers_every_tile_row_and_column_once(data):
    """Every (tile, K row) of gate and up is some CTA's, once; every (tile,
    w_down column block) is some CTA's, once, rank r of tile t taking the
    blocks c with (c + t) % splits == r in order; K ranges are whole stages
    but at d."""
    d = 128 * data.draw(st.integers(1, 24))
    m = 128 * data.draw(st.integers(1, 6))
    splits = data.draw(st.sampled_from([1, 2, 4, 8, 16]))
    itemsize = data.draw(st.sampled_from([1, 2]))
    plan = tmk.mlp_plan(d, m, splits, itemsize)
    n_blocks, stage = d // tmk.box_cols(itemsize), tmk.mlp_stage_rows(itemsize)
    assert len(plan) == (m // tmk.MLP_TILE) * splits
    for t in range(m // tmk.MLP_TILE):
        ctas = [c for c in plan if c[0] == t]
        assert [c[1] for c in ctas] == list(range(splits))
        rows = [k for _, _, k0, k1, _ in ctas for k in range(k0, k1)]
        assert sorted(rows) == list(range(d))
        assert all(k0 % stage == 0 and (k1 % stage == 0 or k1 == d) for _, _, k0, k1, _ in ctas
                   if k1 > k0)
        blocks = [blk for *_, bl in ctas for blk in bl]
        assert sorted(blocks) == list(range(n_blocks))
        for _, r, _, _, bl in ctas:
            assert all((c + t) % splits == r for c in bl) and bl == sorted(bl)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_attention_wo_plan_covers_every_chunk_and_column_once(data):
    """For every kv head of a row, the CTAs of its cluster take every valid
    cache column once (kernel C's chunks) and every wo column once (whole
    128-byte chunks, ceil(chunks / splits) each)."""
    kh = data.draw(st.integers(1, 8))
    splits = data.draw(st.integers(1, 16))
    dm = 16 * data.draw(st.integers(1, 256))
    itemsize = data.draw(st.sampled_from([1, 2]))
    s = data.draw(st.integers(16, 600))
    pad = data.draw(st.integers(0, s - 1))
    plen = data.draw(st.integers(0, pad))
    wpos = data.draw(st.integers(pad, s - 1))
    cols = tdec.valid_columns(plen, pad, wpos, s)
    plan = tmk.attention_wo_plan(dm, splits, itemsize)
    assert [r for r, _, _ in plan] == list(range(splits))
    cpb = tmk.box_cols(itemsize)
    for _ in range(kh):
        chunks = tdec.split_bounds(len(cols), splits)
        seen = [cols[f] for f0, f1 in chunks for f in range(f0, f1)]
        assert seen == cols
        wcols = [c for _, c0, c1 in plan for c in range(c0, c1)]
        assert wcols == list(range(dm))
        assert all(c0 % cpb == 0 for _, c0, c1 in plan if c1 > c0)


def test_ordered_sum_plain_adds_groups_of_8_in_order():
    """Slots in groups of 8, each in slot order, then the groups in order: at
    40 slots the fp32 result is (s0 + .. + s7) + (s8 + .. + s15) + .. + (s32
    + .. + s39) exactly (4 + 4 + 4 + 0 here: the 0.5s vanish beside 2^24),
    which a plain left-to-right sum (15.5) is not."""
    vals = torch.tensor([1.0, 2.0 ** 24] + [1.0] * 6 + [-(2.0 ** 24)] + [0.5] * 31,
                        dtype=torch.float32)[:, None]
    want = None
    for g0 in range(0, 40, 8):
        acc = vals[g0]
        for v in vals[g0 + 1:g0 + 8]:
            acc = acc + v
        want = acc if want is None else want + acc
    assert torch.equal(tmk.ordered_sum_plain(vals), want) and want.item() == 12.0
    left = vals[0]
    for v in vals[1:]:
        left = left + v
    assert left.item() == 15.5


@pytest.mark.parametrize("tiles,d,itemsize,sms,fits_up_to,want", [
    (64, 2048, 1, 132, None, 4),   # GAR-1B int8: 64 tiles x 4 = 256 CTAs, two an SM
    (64, 2048, 2, 132, None, 4),   # GAR-1B bf16: the same grid
    (64, 2048, 1, 132, 2, 2),      # clusters of 4 would not all fit at once
    (16, 2048, 1, 132, None, 16),  # few tiles: the largest cluster
    (64, 128, 1, 132, None, 2),    # d = 128 int8: two 64-row stages
    (64, 128, 2, 132, None, 4),    # bf16: 32-row stages, so the grid stops it first
    (128, 2048, 2, 132, None, 2),  # 128 tiles
    (512, 2048, 2, 132, None, 1),  # a full grid without a split
])
def test_mlp_splits(tiles, d, itemsize, sms, fits_up_to, want):
    fits = None if fits_up_to is None else (lambda s: s <= fits_up_to)
    assert tmk.mlp_splits(tiles, d, itemsize, sms=sms, fits=fits) == want
