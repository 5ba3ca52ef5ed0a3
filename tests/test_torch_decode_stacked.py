"""Kernel 16's surface: the port's `decode_attention`, `decode_attention_stacked`
and their plain version `decode_attention_plain` against the JAX package's
Pallas kernel (`_decode_kernel`) in interpret mode on the CPU, and the
`scale` keyword of `decode_attention_reference` against JAX's.

Tolerance 1e-5 in fp32: the plain version takes the kernel's rounding
points and sums its blocks in another order. bf16 within 1e-2: p is rounded
to bf16 before PV in both, the fp32 sums differ in order, and the output
is rounded once to bf16 (one ulp near 2 is 1.6e-2, so a rounding that
falls on the other side is allowed for by rtol). The CUDA kernel is held
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.ops import attention as tattn
from grasp_any_region_tpu_torch.ops import decode_attention as tdec

L, KH, S, D = 3, 2, 512, 64
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _inputs(rng, b, h=8):
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    k = rng.standard_normal((L, b, KH, S, D)).astype(np.float32)
    v = rng.standard_normal((L, b, KH, S, D)).astype(np.float32)
    return q, k, v


def _jax(a, dtype):
    return jnp.asarray(a, dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _int32(x):
    return jnp.asarray(x, jnp.int32), torch.tensor(x, dtype=torch.int32)


# prompt_pad 256; prompt_lens below it, at it and past it (past write_pos + 1
# too, where the columns the TPU kernel visits depend on block_s)
CASES = [  # (b, layer, block_s, scale, prompt_lens, write_pos)
    (2, 0, 128, None, (100, 300), 300),
    (2, L - 1, 512, 0.1, (256, 37), 256),
    (1, L - 1, 128, 0.1, (0,), 300),    # row 0's first block fully masked
    (1, 0, 512, None, (400,), 280),
    (2, 1, 128, None, (400, 0), 280),   # the same prompt past write_pos, block_s 128
    (2, 0, 512, 0.1, (5, 511), 511),    # write_pos at S - 1
]


@pytest.mark.parametrize("b,layer,block_s,scale,plens,wpos", CASES)
def test_decode_attention_stacked_matches_pallas(rng, b, layer, block_s, scale, plens, wpos):
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_stacked

    q, k, v = _inputs(rng, b)
    (jl, tl), (jp, tp), (jw, tw) = _int32(layer), _int32(list(plens)), _int32(wpos)
    ref = decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl, prompt_lens=jp, write_pos=jw,
        prompt_pad=256, scale=scale, block_s=block_s, interpret=True)
    kw = dict(prompt_lens=tp, write_pos=tw, prompt_pad=256, scale=scale, block_s=block_s)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    for fn in (tdec.decode_attention_plain, tdec.decode_attention_stacked):
        out = fn(torch.from_numpy(q), kt, vt, tl, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    assert torch.equal(kt, torch.from_numpy(k)) and torch.equal(vt, torch.from_numpy(v))
    assert tdec.launches_stacked == 0  # a CPU tensor never launches the kernel


@pytest.mark.parametrize("block_s,scale,plens", [(128, None, (100, 300)), (512, 0.1, (256, 0))])
def test_decode_attention_matches_pallas(rng, block_s, scale, plens):
    """The unstacked form is the stacked one over k_cache[None] at layer 0."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention

    q, k, v = _inputs(rng, 2)
    (jp, tp), (jw, tw) = _int32(list(plens)), _int32(300)
    ref = decode_attention(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]), prompt_lens=jp,
                           write_pos=jw, prompt_pad=256, scale=scale, block_s=block_s,
                           interpret=True)
    out = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k[1]),
                                torch.from_numpy(v[1]), prompt_lens=tp, write_pos=tw,
                                prompt_pad=256, scale=scale, block_s=block_s)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)


@pytest.mark.parametrize("block_s,group", [(128, 4), (512, 1)])
def test_decode_attention_stacked_bf16_matches_pallas(rng, block_s, group):
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_stacked

    q, k, v = _inputs(rng, 2, h=KH * group)
    (jl, tl), (jp, tp), (jw, tw) = _int32(1), _int32([100, 300]), _int32(300)
    ref = decode_attention_stacked(
        _jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16), _jax(v, jnp.bfloat16), jl,
        prompt_lens=jp, write_pos=jw, prompt_pad=256, block_s=block_s, interpret=True)
    out = tdec.decode_attention_stacked(
        _torch(q, torch.bfloat16), _torch(k, torch.bfloat16), _torch(v, torch.bfloat16), tl,
        prompt_lens=tp, write_pos=tw, prompt_pad=256, block_s=block_s)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **BF16)


def test_decode_attention_block_s_must_divide_the_cache(rng):
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_stacked

    q, k, v = _inputs(rng, 1)
    k, v = k[:, :, :, :384], v[:, :, :, :384]
    (jl, tl), (jp, tp), (jw, tw) = _int32(0), _int32([10]), _int32(300)
    with pytest.raises(AssertionError, match="multiple of block_s"):
        decode_attention_stacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
                                 prompt_lens=jp, write_pos=jw, prompt_pad=256, block_s=256,
                                 interpret=True)
    kw = dict(prompt_lens=tp, write_pos=tw, prompt_pad=256, block_s=256)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    for fn in (tdec.decode_attention_plain, tdec.decode_attention_stacked):
        with pytest.raises(ValueError, match="multiple of block_s"):
            fn(*args, tl, **kw)
    with pytest.raises(ValueError, match="multiple of block_s"):
        tdec.decode_attention(args[0], args[1][0], args[2][0], **kw)
    # a block_s past the cache is cut to it, as in JAX
    out = tdec.decode_attention_stacked(*args, tl, **{**kw, "block_s": 1024})
    assert out.shape == (1, 8, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [None, 0.1])
def test_decode_attention_reference_scale_matches_jax(rng, dtype, scale):
    """`scale` is rounded to q's dtype and multiplies q, as JAX's reference
    does (bf16: 0.1 becomes 0.10009765625). In bf16 at most 1% of the
    outputs may differ from JAX's (sums in another order); an unrounded 0.1
    moves about half of them."""
    from grasp_any_region_tpu.ops.attention import decode_attention_reference

    q, k, v = _inputs(rng, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (jp, tp), (jw, tw) = _int32([100, 300]), _int32(300)
    ref = decode_attention_reference(_jax(q, jdt), _jax(k[0], jdt), _jax(v[0], jdt),
                                     prompt_lens=jp, write_pos=jw, prompt_pad=256, scale=scale)
    out = tattn.decode_attention_reference(_torch(q, tdt), _torch(k[0], tdt), _torch(v[0], tdt),
                                           prompt_lens=tp, write_pos=tw, prompt_pad=256,
                                           scale=scale)
    assert out.dtype == tdt
    got, want = out.float().numpy(), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, want, **(FP32 if dtype == "float32" else BF16))
    if dtype == "bfloat16":
        assert (got != want).mean() <= 0.01
