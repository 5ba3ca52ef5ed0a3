"""The port's attention pieces of the train step against the JAX package's
Pallas kernels in interpret mode, in fp32 on the CPU: kernel B's LSE and
segment-id forward (`flash_attention_plain`), kernels 17 and 18
(`flash_attention_bwd_plain`; 17's prep `bwd_delta` against JAX's delta;
the segment-tile skip at 64 and 18's 128 keys), kernel A's LSE and
kernel 5
(`vit_attention_bwd_plain`), and the autograd pairs `flash_attention_df`
and `vit_attention_df` against autograd through the plain forward.

The shapes are `tests/test_flash_backward.py`'s: plain causal, GQA at a
length off the block multiple, non-causal MQA, a q suffix (right-aligned
causal offset), and packed segments with padding; then head dims 128
(GAR-8B's decoder: GQA, segment ids, Sq != Sk) and 96 (its PE-G tower,
kernel 5). Tolerances: gradients
atol 2e-4, rtol 2e-3 (the kernels' tolerance against XLA autodiff in that
file: the sums run in another order); LSE 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.ops import flash_attention as jfa
from grasp_any_region_tpu.ops import flash_backward as jfb
from grasp_any_region_tpu.ops import vit_attention as jva
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import flash_backward as fb
from grasp_any_region_tpu_torch.ops import vit_attention as va

GRAD = dict(atol=2e-4, rtol=2e-3)
LSE = dict(atol=1e-5, rtol=1e-5)
OUT = dict(atol=2e-5, rtol=2e-5)

SHAPES = [  # b, sq, sk, h, kh, d, causal, segments
    (1, 128, 128, 2, 2, 32, True, False),
    (2, 192, 192, 4, 2, 32, True, False),
    (1, 256, 256, 4, 1, 32, False, False),
    (1, 100, 228, 2, 2, 32, True, False),
    (2, 160, 160, 4, 2, 32, True, True),
    (1, 256, 256, 2, 2, 64, True, True),
    (1, 333, 333, 4, 2, 64, True, True),  # ragged: documents end inside 128-key tiles
    # GAR-8B's decoder head dim, GQA 4:1 and 2:1, with and without segment ids, Sq != Sk
    (1, 128, 128, 4, 1, 128, True, False),
    (1, 100, 228, 4, 2, 128, True, False),
    (1, 200, 200, 4, 1, 128, True, True),
]


def _inputs(b, sq, sk, h, kh, d, segments, seed=0):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, kh, d)).astype(np.float32) for _ in range(2))
    seg = None
    if segments:  # two documents, then padding (id 0)
        seg = np.ones((b, sq), np.int32)
        seg[:, sq // 2:] = 2
        seg[:, sq - sq // 8:] = 0
    return q, k, v, g, seg


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,segments", SHAPES)
def test_flash_lse_and_segment_forward_match_pallas(b, sq, sk, h, kh, d, causal, segments):
    q, k, v, _, seg = _inputs(b, sq, sk, h, kh, d, segments)
    out_j, lse_j = jfa.flash_attention(_j(q), _j(k), _j(v), causal=causal, segment_ids=_j(seg),
                                       block_q=64, block_k=64, interpret=True, return_lse=True)
    out, lse = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg),
                                  return_lse=True)
    _close(out, out_j, **OUT)
    _close(lse, lse_j, **LSE)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,segments", SHAPES)
def test_flash_backward_plain_matches_pallas(b, sq, sk, h, kh, d, causal, segments):
    q, k, v, g, seg = _inputs(b, sq, sk, h, kh, d, segments)
    out_j, lse_j = jfa.flash_attention(_j(q), _j(k), _j(v), causal=causal, segment_ids=_j(seg),
                                       block_q=64, block_k=64, interpret=True, return_lse=True)
    ref = jfb.flash_attention_bwd(_j(q), _j(k), _j(v), out_j, lse_j, _j(g), causal=causal,
                                  segment_ids=_j(seg), block_q=64, block_k=64, interpret=True)
    got = fb.flash_attention_bwd(_t(q), _t(k), _t(v), _t(out_j), _t(lse_j), _t(g),
                                 causal=causal, segment_ids=_t(seg))
    for name, a, e in zip(("dq", "dk", "dv"), got, ref):
        _close(a, e, err_msg=name, **GRAD)


@pytest.mark.parametrize("t,s,h,d,fused_v", [
    (2, 160, 3, 32, False),
    # head dim 64, S on both sides of the 64-row query and 128-key tile edges
    (1, 64, 2, 64, False),
    (1, 128, 2, 64, False),
    (1, 129, 2, 64, False),
    (1, 257, 2, 64, False),
    (2, 129, 2, 64, True),  # v a strided view of a (T, S, 3, H, 64) buffer, as the tower's
    # GAR-8B's PE-G head dim 96, S past the 64-row query and 128-key tile edges
    (1, 129, 2, 96, False),
    (1, 257, 2, 96, False),
    (2, 129, 2, 96, True),
])
def test_vit_lse_and_onepass_backward_match_pallas(t, s, h, d, fused_v):
    q, k, v, g, _ = _inputs(t, s, s, h, h, d, False, seed=1)
    v_t = _t(v)
    if fused_v:
        qkv = torch.zeros((t, s, 3, h, d))
        qkv[:, :, 2] = v_t
        v_t = qkv[:, :, 2]
        assert v_t.stride(1) == 3 * h * d
    out_j, lse_j = jva.vit_attention(_j(q), _j(k), _j(v), return_lse=True, interpret=True)
    out, lse = va.vit_attention(_t(q), _t(k), v_t, return_lse=True)
    _close(out, out_j, **OUT)
    _close(lse, lse_j, **LSE)
    ref = jva.vit_attention_bwd_onepass(_j(q), _j(k), _j(v), out_j, lse_j, _j(g),
                                        interpret=True)
    got = va.vit_attention_bwd(_t(q), _t(k), v_t, _t(out_j), _t(lse_j), _t(g))
    for name, a, e in zip(("dq", "dk", "dv"), got, ref):
        _close(a, e, err_msg=name, **GRAD)


def _autograd(fn, inputs, w):
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (fn(*xs) * w).sum().backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("causal,segments,kh", [(True, False, 2), (False, False, 4),
                                                (True, True, 1)])
def test_flash_attention_df_gives_autograd_of_the_plain_forward(causal, segments, kh):
    q, k, v, g, seg = _inputs(2, 96, 96, 4, kh, 32, segments, seed=2)
    w, seg = _t(g), _t(seg)
    got = _autograd(lambda q, k, v: fa.flash_attention_df(q, k, v, causal=causal,
                                                           segment_ids=seg), (q, k, v), w)
    ref = _autograd(lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=causal,
                                                              segment_ids=seg), (q, k, v), w)
    for name, a, e in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5, msg=name)


def test_vit_attention_df_gives_autograd_of_the_plain_forward():
    q, k, v, g, _ = _inputs(3, 70, 70, 2, 2, 32, False, seed=3)
    got = _autograd(va.vit_attention_df, (q, k, v), _t(g))
    ref = _autograd(va.vit_attention_plain, (q, k, v), _t(g))
    for name, a, e in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5, msg=name)


def test_df_forms_take_the_plain_call_without_a_gradient():
    """No gradient needed: the df forms return what the plain wrappers
    return, and under inference mode they save nothing."""
    q, k, v, _, _ = _inputs(1, 64, 64, 2, 2, 32, False)
    with torch.inference_mode():
        a = fa.flash_attention_df(_t(q), _t(k), _t(v))
        b = va.vit_attention_df(_t(q), _t(k), _t(v))
    torch.testing.assert_close(a, fa.flash_attention(_t(q), _t(k), _t(v)))
    torch.testing.assert_close(b, va.vit_attention(_t(q), _t(k), _t(v)))
    assert a.grad_fn is None and b.grad_fn is None


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,segments", [
    (1, 192, 192, 4, 2, 64, True, False),
    (2, 160, 160, 4, 2, 32, True, True),
    (1, 100, 228, 2, 1, 64, True, False),
    (1, 333, 333, 4, 2, 64, True, True),
])
def test_flash_backward_plain_rounds_as_pallas_at_bf16(b, sq, sk, h, kh, d, causal, segments):
    """At bf16 the Pallas kernels round p and ds to bf16 before their dots;
    `flash_attention_bwd_plain` at bf16 inputs, the reference the card holds
    kernels 17 and 18 to, rounds at the same points. From the same bf16
    inputs it lands within a fiftieth of each output's RMS of
    JAX's (the fp32 sums run in another order; one bf16 rounding of the
    output)."""
    q, k, v, g, seg = _inputs(b, sq, sk, h, kh, d, segments, seed=7)
    q, k, v, g = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    jseg = _j(seg)
    out_j, lse_j = jfa.flash_attention(q, k, v, causal=causal, segment_ids=jseg, block_q=64,
                                       block_k=64, interpret=True, return_lse=True)
    ref = jfb.flash_attention_bwd(q, k, v, out_j, lse_j, g, causal=causal, segment_ids=jseg,
                                  block_q=64, block_k=64, interpret=True)

    def bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)

    got = fb.flash_attention_bwd_plain(bf16(q), bf16(k), bf16(v), bf16(out_j), _t(lse_j),
                                       bf16(g), causal=causal, segment_ids=_t(seg))
    for name, a, e in zip(("dq", "dk", "dv"), got, ref):
        e = torch.from_numpy(np.array(e.astype(jnp.float32)))
        assert a.dtype == torch.bfloat16
        rms = e.pow(2).mean().sqrt().item()
        torch.testing.assert_close(a.float(), e, atol=rms / 50, rtol=2.0 ** -8, msg=name)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_bwd_delta_matches_jax(dtype):
    """Kernel 17's plain prep `bwd_delta` against the JAX package's delta,
    rowsum(dO * O) in fp32 as `flash_attention_bwd` forms it
    (grasp_any_region_tpu/ops/flash_backward.py:283-287), from fp32 or bf16
    inputs (their products are exact in fp32; the sums run in another
    order)."""
    rng = np.random.default_rng(5)
    out, g = (rng.normal(size=(2, 77, 6, 64)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    out_j, g_j = jnp.asarray(out, jdt), jnp.asarray(g, jdt)
    ref = jnp.einsum("bshd,bshd->bhs", g_j.astype(jnp.float32), out_j.astype(jnp.float32))
    got = fb.bwd_delta(_t(out).to(tdt), _t(g).to(tdt))
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got, ref, atol=1e-5, rtol=1e-5)


_SKIP_CASES = [pytest.param(s, kt, d, id=f"{s}{'-k128' if kt == 128 else ''}"
                             f"{'' if d == 64 else f'-d{d}'}")
               for d in (64, 96, 128) for kt in (64, 128) for s in (256, 300, 1000)]


@pytest.mark.parametrize("s,key_tile,d", _SKIP_CASES)
def test_segment_tile_skip_keeps_every_equal_id_pair(s, key_tile, d):
    """The kernels skip a (query tile, key tile) pair whose [min, max]
    segment-id ranges (`segment_tiles`) are disjoint: 18 at its query tile
    for head dim d (`flash_backward.bwd_query_tile`, both instances) and 128
    keys (`flash_backward.BWD_KEY_TILE`), here also at 64 keys; B's 128 x
    128 pairs are in tests/test_torch_flash_forward.py. That is exact: no
    skipped pair holds two equal ids; and it does prune."""
    rows_q = fb.bwd_query_tile(d)
    rng = np.random.default_rng(s)
    seg = np.zeros((2, s), np.int32)
    for row in seg:
        off, doc = 0, 1
        while off + 150 < s - 20:
            n = int(rng.integers(20, 150))
            row[off:off + n], off, doc = doc, off + n, doc + 1
    seg = torch.from_numpy(seg)
    q_tiles, k_tiles = fa.segment_tiles(seg, rows_q), fa.segment_tiles(seg, key_tile)
    for tiles, size in ((q_tiles, rows_q), (k_tiles, key_tile)):
        for b in range(2):
            for i in range(tiles.shape[1]):
                rows = seg[b, size * i:size * (i + 1)]
                assert tiles[b, i].tolist() == [int(rows.min()), int(rows.max())]
    lo, hi = q_tiles[..., 0], q_tiles[..., 1]
    klo, khi = k_tiles[..., 0], k_tiles[..., 1]
    disjoint = (khi[:, None, :] < lo[:, :, None]) | (klo[:, None, :] > hi[:, :, None])
    qt, kt = torch.arange(s) // rows_q, torch.arange(s) // key_tile
    skipped = disjoint[:, qt][:, :, kt]  # (B, S, S) per (query, key)
    assert not (skipped & (seg[:, :, None] == seg[:, None, :])).any()
    assert disjoint.any()
