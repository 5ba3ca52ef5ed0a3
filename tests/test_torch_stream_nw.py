"""Kernels H8 (int8 layer matmul) and I (bf16 SwiGLU) on kernel H's TMA-fed
weight stream (csrc/layer_matmul_sm90.cu), on the CPU: their mirrors of the
kernel's order of summation against the Pallas kernels they replace in
interpret mode, their cluster-size choosers, the work plan at their tile
widths, and the wrappers on CPU tensors.

H8 is the stream at one int8 weight a stage (128-column tiles), the column
scale on the summed column: `layer_matmul_q8_stream_plain` against JAX's
`layer_matmul_q8`, which scales the widened weight before the sum. I is the
stream at two bf16 weights a stage (64-column tiles), silu(gate) * up from
the fp32 sums: `layer_swiglu_stream_plain` against JAX's `layer_swiglu`.
Both at 1e-5 of the output's range in fp32: the same sums in another
order. The TPU kernels need Dout % block_n == 0, so each Dout here is below
its block_n (the whole width is one block); the port takes any multiple of
16 (int8) or 8 (bf16). The CUDA kernels are held against these mirrors on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

# the two kernels' tile widths; both take H's chooser (STREAM_CTAS_PER_SM)
TILE = dict(H8=tlm.stream_n(torch.int8), I=tlm.STREAM_N)


def _close(out, ref):
    span = np.abs(ref).max()
    np.testing.assert_allclose(out / span, ref / span, rtol=1e-5, atol=1e-5)


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scales(rng, n_layers, din, n):
    return rng.uniform(0.5, 1.5, (n_layers, 1, n)).astype(np.float32) * din ** -0.5 / 73


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("b,din,dout", [
    (1, 200, 144),    # part stages of rows and a part tile of 128 columns
    (5, 1032, 272),   # three tiles, the last of 16 columns; rank 3 of 4 a part stage
    (24, 520, 400),   # two row tiles of x; rank 3 of 4 without rows
])
def test_matmul_q8_stream_plain_matches_pallas(rng, b, din, dout, splits):
    """The H8 mirror in the kernel's order of summation against JAX's
    layer_matmul_q8 at the first and the last layer."""
    from grasp_any_region_tpu.ops.layer_matmul import layer_matmul_q8

    n_layers = 3
    x = rng.standard_normal((b, din)).astype(np.float32)
    w, s = _int8(rng, (n_layers, din, dout)), _scales(rng, n_layers, din, dout)
    for layer in (0, n_layers - 1):
        ref = np.asarray(layer_matmul_q8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                         jnp.asarray(layer, jnp.int32), interpret=True))
        out = tlm.layer_matmul_q8_stream_plain(*(torch.from_numpy(a) for a in (x, w, s)), layer,
                                               splits)
        _close(out.numpy(), ref)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("b,din,m", [
    (1, 200, 136),    # part stages of rows and a part tile of 64 columns
    (5, 1032, 200),   # four tiles, the last of 8 columns; rank 3 of 4 a part stage
    (24, 520, 392),   # two row tiles of x; rank 3 of 4 without rows
])
def test_swiglu_stream_plain_matches_pallas(rng, b, din, m, splits):
    """The I mirror in the kernel's order of summation against JAX's
    layer_swiglu at the first and the last layer."""
    from grasp_any_region_tpu.ops.layer_matmul import layer_swiglu

    n_layers = 3
    x = rng.standard_normal((b, din)).astype(np.float32)
    wg, wu = ((rng.standard_normal((n_layers, din, m)) * din ** -0.5).astype(np.float32)
              for _ in range(2))
    for layer in (0, n_layers - 1):
        ref = np.asarray(layer_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                      jnp.asarray(layer, jnp.int32), interpret=True))
        out = tlm.layer_swiglu_stream_plain(*(torch.from_numpy(a) for a in (x, wg, wu)), layer,
                                            splits)
        _close(out.numpy(), ref)


@pytest.mark.parametrize("key,dout,din,sms,want", [
    ("H8", 2048, 2048, 132, 8),   # GAR-1B's wo: 16 tiles of 128, two 128-row stages a CTA
    ("H8", 2048, 8192, 132, 8),   # w_down: the cluster stays within 8 CTAs
    ("H8", 2048, 8192, 66, 8),    # half the SMs: 128 CTAs, still within two an SM
    ("H8", 2048, 8192, 32, 4),    # a quarter of that: half the CTAs
    ("I", 8192, 2048, 132, 2),    # GAR-1B's gate and up: 128 tiles of 64
    ("I", 8192, 2048, 66, 1),     # half the SMs: one CTA a tile, no reduction
    ("I", 1024, 256, 132, 2),     # the narrow config: a CTA keeps at least one stage
])
def test_stream_splits_of_h8_and_i(key, dout, din, sms, want):
    """The cluster sizes that the H8 and I wrappers' choosers give."""
    assert tlm.stream_splits(-(-dout // TILE[key]), din, sms=sms) == want


@settings(max_examples=100, deadline=None, database=None)
@given(st.data())
@pytest.mark.parametrize("key", ["H8", "I"])
def test_stream_plan_covers_every_column_and_row_once_at_h8_and_i(key, data):
    """The plan at the kernel's tile width, over Din (a multiple of 8), Dout
    (of 16 for int8, 8 for bf16) and its chooser's cluster size (or any
    power of two up to 16): the tiles cover [0, Dout) once, and the CTAs of
    a tile split [0, Din) into contiguous ranges in rank order, each
    starting on a stage."""
    n = TILE[key]
    step = 16 if key == "H8" else 8
    din = 8 * data.draw(st.integers(1, 1100), "Din / 8")
    dout = step * data.draw(st.integers(1, 2400 // step), "Dout / step")
    tiles = -(-dout // n)
    splits = data.draw(st.sampled_from(
        [tlm.stream_splits(tiles, din, sms=sms) for sms in (132, 66)] + [1, 2, 4, 8, 16]), "splits")
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


@pytest.mark.parametrize("key", ["H", "H8", "I", "I8"])
def test_stream_wrappers_on_cpu_tensors_launch_nothing(rng, key):
    """Each stream kernel's wrapper on CPU tensors returns its plain version
    and counts no launch."""
    din, n = 136, 144
    x = torch.from_numpy(rng.standard_normal((3, din)).astype(np.float32)).to(torch.bfloat16)
    bf = [torch.from_numpy((rng.standard_normal((2, din, n)) * din ** -0.5).astype(np.float32))
          .to(torch.bfloat16) for _ in range(2)]
    q8 = [t for _ in range(2) for t in (torch.from_numpy(_int8(rng, (2, din, n))),
                                        torch.from_numpy(_scales(rng, 2, din, n)))]
    wrapper, plain, mats = dict(
        H=(tlm.layer_matmul, tlm.layer_matmul_plain, bf[:1]),
        H8=(tlm.layer_matmul_q8, tlm.layer_matmul_q8_plain, q8[:2]),
        I=(tlm.layer_swiglu, tlm.layer_swiglu_plain, bf),
        I8=(tlm.layer_swiglu_q8, tlm.layer_swiglu_q8_plain, q8))[key]
    before = dict(tlm.launches)
    out = wrapper(x, *mats, 1)
    assert out.dtype == torch.bfloat16 and out.shape == (3, n)
    assert torch.equal(out, plain(x, *mats, 1))
    assert tlm.launches == before
