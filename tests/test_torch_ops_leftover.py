"""The port's `ops/roi_align.py` and `ops/tiles.py` against JAX's: RoIAlign
three ways (JAX's `roi_align`, the numpy golden `tests/golden/roi_align_ref`,
and through `merge_tiles` the port's own tiled replay
`models/replay.roi_align_tiled`, as tests/test_model.py holds JAX's pair),
and the tile split / merge / masked merge on the same inputs.

Tolerance: RoIAlign at rtol 1e-4, atol 1e-5 (JAX's own golden tolerance);
the tile ops are reshapes, held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.ops.roi_align import roi_align as jax_roi_align
from grasp_any_region_tpu.ops import tiles as jtiles
from grasp_any_region_tpu_torch.models.replay import roi_align_tiled
from grasp_any_region_tpu_torch.ops import roi_align as tra
from grasp_any_region_tpu_torch.ops import tiles as ttiles
from tests.golden.roi_align_ref import roi_align_np

TOL = dict(rtol=1e-4, atol=1e-5)

BOXES = np.array([
    [2.0, 3.0, 30.5, 20.0],
    [0.0, 0.0, 39.0, 23.0],
    [10.2, 5.7, 11.9, 8.1],  # small box
    [-3.0, -3.0, 5.0, 5.0],  # partly out of range
    [0.5, 0.5, 0.6, 0.6],  # degenerate tiny box
    [35.0, 20.0, 60.0, 40.0],  # past the far edges: boundary collapse, zero taps
], np.float32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("out,scale,sr", [((7, 9), 0.5, 2), ((16, 16), 1.0, 2), ((5, 3), 0.25, 3)])
def test_roi_align_matches_jax_and_numpy_golden(rng, aligned, out, scale, sr):
    feat = rng.standard_normal((4, 24, 40)).astype(np.float32)
    got = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(BOXES), output_size=out,
                        spatial_scale=scale, sampling_ratio=sr, aligned=aligned)
    assert got.shape == (len(BOXES), 4) + out and got.dtype == torch.float32
    want = jax_roi_align(jnp.asarray(feat), jnp.asarray(BOXES), output_size=out,
                         spatial_scale=scale, sampling_ratio=sr, aligned=aligned)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    golden = roi_align_np(feat, BOXES, out, spatial_scale=scale, sampling_ratio=sr,
                          aligned=aligned)
    np.testing.assert_allclose(got.numpy(), golden, **TOL)


def test_roi_align_constant_and_linear_maps():
    feat = torch.full((2, 16, 16), 3.25)
    out = tra.roi_align(feat, torch.tensor([[1.0, 1.0, 10.0, 12.0]]))
    torch.testing.assert_close(out, torch.full_like(out, 3.25), rtol=1e-6, atol=0)
    yy, xx = np.meshgrid(np.arange(32, dtype=np.float32), np.arange(32, dtype=np.float32),
                         indexing="ij")
    ramp = torch.from_numpy((2.0 * xx + 3.0 * yy)[None])
    out = tra.roi_align(ramp, torch.tensor([[4.0, 6.0, 20.0, 26.0]]), output_size=(4, 4))
    x_c = 4.0 - 0.5 + (20.0 - 4.0) / 4 / 2
    y_c = 6.0 - 0.5 + (26.0 - 6.0) / 4 / 2
    np.testing.assert_allclose(float(out[0, 0, 0, 0]), 2 * x_c + 3 * y_c, rtol=1e-5)


def test_roi_align_refuses_adaptive_sampling():
    with pytest.raises(ValueError, match="adaptive"):
        tra.roi_align(torch.zeros(1, 4, 4), torch.zeros(1, 4), sampling_ratio=0)


@pytest.mark.parametrize("ncw,nch", [(3, 2), (1, 1), (2, 4)])
def test_roi_align_tiled_matches_merged(rng, ncw, nch):
    """The port's replay samples the tile array; RoIAlign over the merged
    canvas gives the same crops (tests/test_model.py's pair, here the port's)."""
    t, side, d = ncw * nch, 16, 8
    tiles = torch.from_numpy(rng.standard_normal((t, side, side, d)).astype(np.float32))
    merged = ttiles.merge_tiles(tiles.permute(0, 3, 1, 2)[None], ncw=ncw, nch=nch)[0]
    w, h = ncw * side, nch * side
    boxes = torch.tensor([[1.0, 2.0, w - 8.0, h - 2.0], [0.2, 0.1, 1.5, 1.2],
                          [w / 3, h / 4, w - 1.0, h - 0.5], [-2.0, -1.0, w + 3.0, h + 1.0]])
    ref = tra.roi_align(merged, boxes, output_size=(16, 16))
    got = roi_align_tiled(tiles, torch.tensor(ncw), torch.tensor(nch), boxes)  # (R, 16, 16, D)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), ref, **TOL)


def test_tiles_roundtrip_and_order_equal_jax(rng):
    img = rng.standard_normal((2, 3, 8 * 4, 8 * 6)).astype(np.float32)
    tiles = ttiles.split_tiles(torch.from_numpy(img), ncw=6, nch=4)
    assert tiles.shape == (2, 24, 3, 8, 8)
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(jtiles.split_tiles(jnp.asarray(img), 6, 4)))
    np.testing.assert_array_equal(ttiles.merge_tiles(tiles, ncw=6, nch=4).numpy(), img)
    canvas = np.zeros((1, 1, 4, 6), np.float32)
    for r in range(2):
        for c in range(3):
            canvas[0, 0, r * 2:(r + 1) * 2, c * 2:(c + 1) * 2] = r * 3 + c
    order = ttiles.split_tiles(torch.from_numpy(canvas), ncw=3, nch=2)
    assert order[0, :, 0, 0, 0].tolist() == list(range(6))
    with pytest.raises(ValueError, match="6 tiles for a 2 x 2 grid"):
        ttiles.merge_tiles(order, ncw=2, nch=2)


@pytest.mark.parametrize("ncw,nch,t", [(4, 2, 8), (3, 1, 8), (2, 2, 5)])
def test_merge_tiles_masked_equals_jax(rng, ncw, nch, t):
    tiles = rng.standard_normal((2, t, 2, 4, 4)).astype(np.float32)
    got = ttiles.merge_tiles_masked(torch.from_numpy(tiles), torch.tensor(ncw),
                                    torch.tensor(nch), max_grid=4)
    want = jtiles.merge_tiles_masked(jnp.asarray(tiles), jnp.int32(ncw), jnp.int32(nch),
                                     max_grid=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    static = ttiles.merge_tiles(torch.from_numpy(tiles[:, :ncw * nch]), ncw=ncw, nch=nch)
    np.testing.assert_array_equal(got[:, :, :nch * 4, :ncw * 4].numpy(), static.numpy())
    assert float(got[:, :, nch * 4:].abs().sum()) == 0.0
    assert float(got[:, :, :, ncw * 4:].abs().sum()) == 0.0
