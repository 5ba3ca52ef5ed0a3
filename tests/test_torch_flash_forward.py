"""Host-side pieces of kernels B and E's Hopper forward
(csrc/flash_forward_sm90.cu), on the CPU: the 128-row segment-id table
B's tiles skip by, against a brute-force numpy min/max, and the exactness
of that skip; and the layout checks that keep a tensor the kernels' TMA
maps cannot read from reaching them (`_build.check_operand`,
`flash_attention.check_operands`, `vit_attention.check_fused_qkv`).
"""

import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.ops import _build
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import vit_attention as va


def _documents(rng, b, s, lo, hi):
    """(B, S) int32 ids: documents 1, 2, ... of lo-hi tokens, then padding (0)."""
    seg = np.zeros((b, s), np.int32)
    for row in seg:
        off, doc = 0, 1
        while True:
            n = int(rng.integers(lo, hi))
            if off + n > s - 7:
                break
            row[off:off + n], off, doc = doc, off + n, doc + 1
    return seg


@pytest.mark.parametrize("s", [64, 127, 128, 129, 333, 1025, 4662])
@pytest.mark.parametrize("lo,hi", [(20, 150), (100, 700)])
def test_forward_segment_tiles_match_brute_force(s, lo, hi):
    """B's table: each 128-row tile's [min, max] id (the ragged last tile
    over its real rows only), against numpy."""
    rng = np.random.default_rng(s + lo)
    seg = _documents(rng, 3, s, lo, hi)
    tiles = fa.segment_tiles(torch.from_numpy(seg), fa.FWD_TILE).numpy()
    n = -(-s // 128)
    assert tiles.shape == (3, n, 2) and tiles.dtype == np.int32
    for b in range(3):
        for i in range(n):
            rows = seg[b, 128 * i:128 * (i + 1)]
            assert tiles[b, i].tolist() == [rows.min(), rows.max()]


@pytest.mark.parametrize("s", [200, 333, 1025, 4662])
def test_forward_segment_skip_is_exact(s):
    """B skips a (128-row query tile, 128-key tile) pair whose id ranges are
    disjoint (`fwd_pair_skipped`): no skipped pair holds two equal ids; from
    9 tiles a row on, packed rows of short documents leave pairs to prune."""
    seg = torch.from_numpy(_documents(np.random.default_rng(s), 2, s, 20, 150))
    tiles = fa.segment_tiles(seg, fa.FWD_TILE)
    lo, hi = tiles[..., 0], tiles[..., 1]
    disjoint = (hi[:, None, :] < lo[:, :, None]) | (lo[:, None, :] > hi[:, :, None])
    tile = torch.arange(s) // fa.FWD_TILE
    skipped = disjoint[:, tile][:, :, tile]  # (B, S, S) per (query, key)
    assert not (skipped & (seg[:, :, None] == seg[:, None, :])).any()
    if s >= 1025:
        assert disjoint.any()


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["d_stride", "row_stride", "head_stride", "misaligned",
                                  "fp32"])
def test_check_operand_rejects_layouts_the_tensor_maps_cannot_read(case):
    """TMA needs a unit stride on D, strides of 16-byte multiples and a
    16-byte aligned base; the kernels take bf16. Each breach raises."""
    x = {
        "d_stride": _bf16(1, 64, 2, 64).transpose(-1, -2),
        "row_stride": _bf16(1, 10, 68)[..., :64].unflatten(-1, (1, 64)),  # 136-byte rows
        "head_stride": _bf16(1, 10, 2, 68)[..., :64],  # 136-byte head stride
        "misaligned": _bf16(1, 10, 2, 72)[..., 1:65],  # base 2 bytes past alignment
        "fp32": torch.zeros(1, 10, 2, 64),
    }[case]
    with pytest.raises(TypeError if case == "fp32" else ValueError):
        _build.check_operand(x, "x")


def test_check_operand_takes_views_of_a_fused_buffer():
    buf = _bf16(2, 77, 12, 64)
    for x in (buf[:, :, :8], buf[:, :, 8:10], buf[:, :, 10:]):
        _build.check_operand(x, "x")


def test_check_operands_b():
    q, k = _bf16(1, 100, 8, 64), _bf16(1, 100, 2, 64)
    fa.check_operands(q, k, k, causal=True)
    fa.check_operands(q[:, :50], k, k, causal=True)  # Sq < Sk
    with pytest.raises(ValueError, match="Sk >= Sq"):
        fa.check_operands(q, k[:, :50], k[:, :50], causal=True)
    fa.check_operands(q, k[:, :50], k[:, :50], causal=False)
    with pytest.raises(ValueError, match="bad shapes"):
        fa.check_operands(q, _bf16(1, 100, 3, 64), _bf16(1, 100, 3, 64), causal=True)
    with pytest.raises(ValueError, match=r"head dims \(64, 128\)"):
        fa.check_operands(_bf16(1, 9, 2, 32), _bf16(1, 9, 2, 32), _bf16(1, 9, 2, 32), True)
    with pytest.raises(ValueError, match=r"head dims \(64, 128\)"):  # no instance at 80
        fa.check_operands(_bf16(1, 9, 2, 80), _bf16(1, 9, 2, 80), _bf16(1, 9, 2, 80), True)
    fa.check_operands(_bf16(1, 9, 8, 128), _bf16(1, 9, 2, 128), _bf16(1, 9, 2, 128), True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_operands(q, k.transpose(-1, -2).contiguous().transpose(-1, -2), k, True)


def test_check_fused_qkv_e():
    h, s = 4, 65
    qkv, cos = _bf16(2, s, 3 * h * 64), torch.ones(h, s, 64)
    va.check_fused_qkv(qkv, cos, cos, h, 64)
    with pytest.raises(ValueError):
        va.check_fused_qkv(qkv, cos, cos, h, 32)
    with pytest.raises(ValueError):
        va.check_fused_qkv(qkv, cos[:, :-1], cos, h, 64)
    with pytest.raises(TypeError):
        va.check_fused_qkv(qkv.float(), cos, cos, h, 64)
    with pytest.raises(ValueError, match="S <= 1152"):  # roped K kept whole in shared memory
        va.check_fused_qkv(_bf16(1, 1153, 3 * h * 64), torch.ones(h, 1153, 64),
                           torch.ones(h, 1153, 64), h, 64)
    va.check_fused_qkv(_bf16(1, 1152, 3 * h * 64), torch.ones(h, 1152, 64),
                       torch.ones(h, 1152, 64), h, 64)
    with pytest.raises(TypeError):  # a strided view: the one tensor map needs the buffer
        va.check_fused_qkv(_bf16(2, s, 3 * h * 64 + 8)[..., :3 * h * 64], cos, cos, h, 64)
