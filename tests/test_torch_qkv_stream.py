"""Kernels J and J8 on the weight stream, on the CPU: the mirrors that follow
the kernels' partition and order (`layer_qkv_stream_plain`,
`layer_qkv_q8_stream_plain`) against the JAX package's `layer_qkv` and
`layer_qkv_q8` in Pallas interpret mode, the cluster-size chooser
(`qkv_stream_splits`), the three segments' plan (`segment_plan`), and the
wrappers on CPU tensors.

Tolerance 1e-5 (rtol and atol) in fp32, as tests/test_torch_layer_matmul.py:
the same sums in another order, and J8's scale on the summed column where
JAX puts it on the widened weight. D = 2040 is not a multiple of a stage
(128 rows): at every cluster size of 1-16 each CTA keeps at least one
stage and the last a part stage. The ragged widths (Hq 136, Hk 40 in bf16;
144 and 48 in int8) leave a part tile, and k and v narrower than one tile;
(256, 64) at D = 256 is GAR-1B's narrow stand-in (chip_smoke.py's
narrow_config), where only 1 and 2 CTAs a tile keep a stage. The CUDA
kernels are held against these mirrors on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.models import quantize as tq
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

TOL = dict(rtol=1e-5, atol=1e-5)
L = 3
WIDTHS = {  # (Hq, Hk) by weight type: ragged, the narrow stand-in, GAR-1B
    False: ((136, 40), (256, 64), (2048, 512)),
    True: ((144, 48), (256, 64), (2048, 512)),
}


@functools.lru_cache(maxsize=None)
def _case(q8: bool, b: int, d: int, hq: int, hk: int):
    """Seeded inputs (numpy, fp32; int8 weights with their scales) and the
    Pallas kernel's q, k, v in interpret mode at the first and the last
    layer."""
    from grasp_any_region_tpu.ops import layer_matmul as jlm

    rng = np.random.default_rng(10000 * b + 10 * hk + q8)
    x = rng.standard_normal((b, d)).astype(np.float32)
    ws = [(rng.standard_normal((L, d, n)) * d ** -0.5).astype(np.float32) for n in (hq, hk, hk)]
    if q8:
        mats = [a for w in ws for a in (t.numpy() for t in tq.quantize_int8(torch.from_numpy(w)))]
        fn = jlm.layer_qkv_q8
    else:
        mats, fn = ws, jlm.layer_qkv
    refs = {layer: [np.asarray(r) for r in fn(*map(jnp.asarray, (x, *mats)),
                                              jnp.asarray(layer, jnp.int32), interpret=True)]
            for layer in (0, L - 1)}
    return x, mats, refs


def _mirror(q8: bool):
    return tlm.layer_qkv_q8_stream_plain if q8 else tlm.layer_qkv_stream_plain


def _check_mirror(q8, b, d, hq, hk, splits):
    x, mats, refs = _case(q8, b, d, hq, hk)
    before = dict(tlm.launches)
    for layer, ref in refs.items():
        out = _mirror(q8)(*map(torch.from_numpy, (x, *mats)), layer, splits)
        for o, r, n in zip(out, ref, (hq, hk, hk)):
            assert o.shape == (b, n) and o.dtype == torch.float32
            np.testing.assert_allclose(o.numpy(), r, **TOL)
    assert tlm.launches == before


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_qkv_stream_mirror_matches_pallas_ragged(q8, b, splits):
    """The mirror of J or J8 (its segments, tiles, CTAs' stages, ranks,
    int8 scales) at 1-16 CTAs a tile, ragged widths, D = 2040, against
    JAX's kernel at the first and the last layer; nothing launches."""
    hq, hk = WIDTHS[q8][0]
    _check_mirror(q8, b, 2040, hq, hk, splits)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_qkv_stream_mirror_matches_pallas_narrow(q8, b, splits):
    """The same at GAR-1B's narrow stand-in (D = Hq = 256, Hk = 64): k and v
    are one tile, narrower than int8's 128-column box."""
    hq, hk = WIDTHS[q8][1]
    _check_mirror(q8, b, 256, hq, hk, splits)


@pytest.mark.parametrize("hq,hk,d,itemsize,sms,want", [
    (2048, 512, 2048, 2, 132, 4),  # GAR-1B, J: 48 tiles, within two CTAs an SM
    (2048, 512, 2048, 1, 132, 8),  # GAR-1B, J8: 24 tiles of 128, the cluster limit
    (2048, 512, 2048, 2, 66, 2),   # half the SMs: half the CTAs
    (2048, 512, 2048, 1, 66, 4),
    (256, 64, 256, 2, 132, 2),     # the narrow stand-in: a CTA keeps at least one stage
    (64, 64, 8192, 2, 132, 8),     # no rope: J may take 8 CTAs of a 64-column tile
])
def test_qkv_stream_splits(hq, hk, d, itemsize, sms, want):
    """J and J8's chooser: `stream_splits` over the three segments' tiles,
    two CTAs an SM, with no cap for rope pairs."""
    tiles = tlm.qkv_tiles(hq, hk, itemsize)
    assert tiles == -(-hq // (128 // itemsize)) + 2 * -(-hk // (128 // itemsize))
    assert tlm.qkv_stream_splits(hq, hk, d, itemsize, sms=sms) == want
    assert want == tlm.stream_splits(tiles, d, sms=sms)


@pytest.mark.parametrize("widths", [0, 1, 2], ids=["ragged", "narrow", "gar_1b"])
@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_qkv_segment_plan_covers_every_column_once(q8, widths):
    """The grid's column tiles at the kernel's tile width (64 bf16, 128
    int8) are q's, then k's, then v's, `qkv_tiles` of them, each split over
    the chooser's CTAs in rank order; the tiles of each segment cover its
    columns once, a segment narrower than a tile included, and nothing past
    its width."""
    hq, hk = WIDTHS[q8][widths]
    itemsize = 1 if q8 else 2
    n, d = tlm.stream_n(torch.int8 if q8 else torch.bfloat16), 2040
    splits = tlm.qkv_stream_splits(hq, hk, d, itemsize)
    plan = tlm.segment_plan((hq, hk, hk), d, splits, n)
    assert len(plan) == tlm.qkv_tiles(hq, hk, itemsize) * splits
    assert [s for s, _, _, _, _ in plan] == sorted(s for s, _, _, _, _ in plan)
    assert [r for _, _, r, _, _ in plan] == list(range(splits)) * (len(plan) // splits)
    for s, dout in enumerate((hq, hk, hk)):
        cols = sorted(c for seg, t, r, _, _ in plan if seg == s and r == 0
                      for c in range(t * n, min(dout, (t + 1) * n)))
        assert cols == list(range(dout))
        for seg, t, _, k0, k1 in plan:
            if seg == s:
                assert t * n < dout and 0 <= k0 <= k1 <= d


@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_qkv_wrappers_on_cpu_tensors_launch_nothing(q8):
    """On CPU tensors `layer_qkv` and `layer_qkv_q8` run their plain
    versions (the mirror agrees with them) and launch no kernel."""
    hq, hk = WIDTHS[q8][0]
    x, mats, _ = _case(q8, 5, 2040, hq, hk)
    args = [torch.from_numpy(a) for a in (x, *mats)]
    before = dict(tlm.launches)
    wrapper, plain = ((tlm.layer_qkv_q8, tlm.layer_qkv_q8_plain) if q8
                      else (tlm.layer_qkv, tlm.layer_qkv_plain))
    out = wrapper(*args, 1)
    assert tlm.launches == before
    for o, r, m in zip(out, plain(*args, 1), _mirror(q8)(*args, 1, 4)):
        assert torch.equal(o, r)
        np.testing.assert_allclose(o.numpy(), m.numpy(), **TOL)
