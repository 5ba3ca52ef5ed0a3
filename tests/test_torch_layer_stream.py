"""Kernel H's work plan on the CPU (csrc/layer_matmul_sm90.cu, mirrored in
ops/layer_matmul.py): which (column tile, K range) each CTA takes
(`stream_plan`), the cluster-size chooser (`stream_splits`), and the plain
version that sums in the kernel's order (`layer_matmul_stream_plain`)
against the JAX package's Pallas kernel in interpret mode at ragged widths.

Tolerance 1e-5 in fp32: the same sums in another order. The TPU kernel
needs Dout % block_n == 0, so each Dout here is below its block_n (the
whole width is one block); the port takes any multiple of 8. The CUDA
kernel is held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

TOL = dict(rtol=1e-5, atol=1e-5)


@settings(max_examples=200, deadline=None, database=None)
@given(st.data())
def test_stream_plan_covers_every_column_and_row_once(data):
    """Over Din and Dout (multiples of 8) and the chooser's cluster size (or
    any power of two up to 16): the CTAs of a tile split [0, Din) into
    contiguous K ranges in rank order, each starting on a stage, and the
    stages of a CTA cover its range once; the tiles cover [0, Dout) once."""
    din = 8 * data.draw(st.integers(1, 1100), "Din / 8")
    dout = 8 * data.draw(st.integers(1, 300), "Dout / 8")
    tiles = -(-dout // tlm.STREAM_N)
    splits = data.draw(st.sampled_from(
        [tlm.stream_splits(tiles, din, sms=132), tlm.stream_splits(tiles, din, sms=66),
         1, 2, 4, 8, 16]), "splits")
    plan = tlm.stream_plan(din, dout, splits)
    assert len(plan) == tiles * splits
    cols = sorted(c for t in range(tiles)
                  for c in range(t * tlm.STREAM_N, min(dout, (t + 1) * tlm.STREAM_N)))
    assert cols == list(range(dout))
    for t in range(tiles):
        ranges = [(k0, k1) for tt, _, k0, k1 in plan if tt == t]
        assert [r for tt, r, _, _ in plan if tt == t] == list(range(splits))
        assert ranges[0][0] == 0 and ranges[-1][1] == din
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, in order
        for k0, k1 in ranges:
            assert k0 == k1 or k0 % tlm.STREAM_BK == 0
            rows = [r for b0 in range(k0, k1, tlm.STREAM_BK)
                    for r in range(b0, min(k1, b0 + tlm.STREAM_BK))]
            assert rows == list(range(k0, k1))  # every row once, in the stages' order


@pytest.mark.parametrize("tiles,din,sms,want", [
    (32, 8192, 132, 8),  # GAR-1B's w_down: 256 CTAs, within two an SM
    (32, 2048, 132, 8),  # wo
    (32, 8192, 66, 4),   # half the SMs: half the CTAs
    (4, 256, 132, 2),    # the narrow config: a CTA keeps at least one stage
    (4, 4096, 132, 8),   # the cluster stays within 8 CTAs
])
def test_stream_splits(tiles, din, sms, want):
    assert tlm.stream_splits(tiles, din, sms=sms) == want


@pytest.mark.parametrize("b,din,dout,splits", [
    (1, 200, 136, 1),     # one CTA a tile: part stages of rows and a part tile
    (5, 200, 136, 2),     # the second CTA's range is a part stage
    (17, 1032, 200, 4),
    (32, 2056, 200, 8),   # two CTAs of the cluster get no rows
    (24, 2056, 72, 16),
])
def test_stream_plain_matches_pallas(rng, b, din, dout, splits):
    """The plain version in the kernel's order of summation against JAX's
    layer_matmul at the first and the last layer; the wrapper on a CPU
    tensor launches nothing."""
    from grasp_any_region_tpu.ops.layer_matmul import layer_matmul

    n_layers = 3
    x = rng.standard_normal((b, din)).astype(np.float32)
    w = (rng.standard_normal((n_layers, din, dout)) * din ** -0.5).astype(np.float32)
    for layer in (0, n_layers - 1):
        ref = layer_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(layer, jnp.int32),
                           interpret=True)
        out = tlm.layer_matmul_stream_plain(torch.from_numpy(x), torch.from_numpy(w), layer,
                                            splits)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tlm.launches["H"] == 0
