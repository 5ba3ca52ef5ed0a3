"""Ulysses and ring attention of the port on two gloo ranks, against JAX's
`ulysses_attention` and `ring_attention` on its 8-device virtual CPU mesh
(tests/conftest.py) and against `mha_reference`, on the same numpy inputs
at fp32: causal and not, GQA (4 q / 2 kv heads) and one kv head (the ring
only: Ulysses needs the heads to divide the axis, and refuses one), the
ring's gradients against `jax.grad` of JAX's ring, and Ulysses over
packed rows' and right-padded rows' segment ids.

One job of two spawned ranks (tests/torch_ranks.py) computes every case;
the cases read its results. Tolerance: 1e-5 relative to the largest
element (fp32 attention over 64 keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_ranks import attention_job, run_ranks

B, S, H, D = 2, 64, 4, 16


def _inputs(kv_heads, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, kv_heads, D)).astype(np.float32)
    v = rng.standard_normal((B, S, kv_heads, D)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, dout


INPUTS = {"gqa": _inputs(2, 0), "kv1": _inputs(1, 1)}
# whole (B, S) segment ids and right_padded: three packed segments in row
# 0, two in row 1, the second shard's first token mid-segment; and rows of
# 50 and 37 real tokens with trailing pads
_PACKED = np.array([[1] * 20 + [2] * 30 + [3] * 14, [1] * 40 + [2] * 24], np.int32)
_PADDED = np.array([[1] * 50 + [0] * 14, [1] * 37 + [0] * 27], np.int32)
SEGMENTS = {"packed": (_PACKED, False), "right_padded": (_PADDED, True)}


@pytest.fixture(scope="module")
def ranks():
    res = run_ranks(2, attention_job, INPUTS, SEGMENTS)
    return res


@pytest.fixture(scope="module")
def jax_mesh():
    from grasp_any_region_tpu.core.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(seq=2), devices=jax.devices()[:2])


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _reference(tag, causal):
    from grasp_any_region_tpu.ops.attention import mha_reference

    q, k, v, _ = INPUTS[tag]
    return mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)


def test_both_ranks_return_the_same_whole_outputs(ranks):
    assert set(ranks[0]) == set(ranks[1])
    for key, got in ranks[0].items():
        other = ranks[1][key]
        if isinstance(got, str):  # a refusal
            assert got == other
            continue
        for a, b in zip(*((x if isinstance(x, list) else [x]) for x in (got, other))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_the_reference(ranks, jax_mesh, causal):
    from grasp_any_region_tpu.parallel.ulysses import ulysses_attention

    q, k, v, _ = (jnp.asarray(x) for x in INPUTS["gqa"])
    want = jax.jit(lambda q, k, v: ulysses_attention(q, k, v, jax_mesh, causal=causal))(q, k, v)
    got = ranks[0][f"ulysses_gqa_{causal}"]
    _close(got, want)
    _close(got, _reference("gqa", causal))


@pytest.mark.parametrize("tag", ["gqa", "kv1"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_forward_matches_jax_and_the_reference(ranks, jax_mesh, tag, causal):
    from grasp_any_region_tpu.parallel.ring import ring_attention

    q, k, v, _ = (jnp.asarray(x) for x in INPUTS[tag])
    want = jax.jit(lambda q, k, v: ring_attention(q, k, v, jax_mesh, causal=causal))(q, k, v)
    got = ranks[0][f"ring_{tag}_{causal}"][0]
    _close(got, want)
    _close(got, _reference(tag, causal))


@pytest.mark.parametrize("tag", ["gqa", "kv1"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_backward_matches_jax(ranks, jax_mesh, tag, causal):
    from grasp_any_region_tpu.parallel.ring import ring_attention

    q, k, v, dout = (jnp.asarray(x) for x in INPUTS[tag])
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        ring_attention(q, k, v, jax_mesh, causal=causal) * dout), argnums=(0, 1, 2)))(q, k, v)
    for got, want in zip(ranks[0][f"ring_{tag}_{causal}"][1:], grads):
        _close(got, want)


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_ulysses_over_segment_ids_matches_jax_and_the_reference(ranks, jax_mesh, name):
    """Packed rows take the segment mask (the shards' ids all-gathered);
    right-padded rows drop it, as JAX's `mha` does."""
    from grasp_any_region_tpu.ops.attention import mha_reference
    from grasp_any_region_tpu.parallel.ulysses import ulysses_attention

    seg, right_padded = SEGMENTS[name]
    q, k, v, _ = (jnp.asarray(x) for x in INPUTS["gqa"])
    seg = jnp.asarray(seg)
    want = jax.jit(lambda q, k, v, s: ulysses_attention(
        q, k, v, jax_mesh, causal=True, segment_ids=s, right_padded=right_padded))(q, k, v, seg)
    got = ranks[0][f"ulysses_segments_{name}"]
    _close(got, want)
    ref = mha_reference(q, k, v, causal=True, segment_ids=seg)
    if right_padded:  # the real tokens: under a causal mask they never see trailing pads
        real = np.asarray(seg) != 0
        got, want = np.asarray(got)[real], np.asarray(ref)[real]
        _close(got, want)
    else:
        _close(got, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_refuses_heads_the_axis_does_not_divide(ranks, causal):
    """One kv head does not divide seq = 2: Ulysses refuses, as JAX asserts."""
    msg = ranks[0][f"ulysses_kv1_{causal}"]
    assert isinstance(msg, str) and "must divide the seq axis size 2" in msg, msg
