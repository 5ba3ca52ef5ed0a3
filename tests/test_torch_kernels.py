"""The plain PyTorch versions of kernels A, B and C against the Pallas
kernels they replace, run in Pallas interpret mode on the CPU, and the
wrappers' CPU dispatch.

Tolerance 1e-5 in fp32: the online softmax of the Pallas kernels and the
one-shot softmax of the plain versions take the same sums in another order.
The CUDA kernels themselves are checked against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import flash_attention as tflash
from grasp_any_region_tpu_torch.ops import vit_attention as tvit

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))  # a copy: kernels write in place


def _counts():
    return tvit.launches, tflash.launches, tdec.launches


def test_vit_attention_plain_matches_pallas(rng):
    from grasp_any_region_tpu.ops.vit_attention import vit_attention

    t, s, h, d = 2, 200, 2, 64  # S not a multiple of 128: the kernel pads and masks
    q, k, v = (rng.standard_normal((t, s, h, d)).astype(np.float32) for _ in range(3))
    ref = vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    for fn in (tvit.vit_attention_plain, tvit.vit_attention):
        np.testing.assert_allclose(fn(_t(q), _t(k), _t(v)).numpy(), np.asarray(ref), **TOL)
    assert _counts() == (0, 0, 0)  # a CPU tensor never launches a kernel


@pytest.mark.parametrize("sq,sk,h,kh,causal", [
    (256, 256, 4, 2, True),    # causal, Sq == Sk
    (130, 300, 4, 1, True),    # Sq < Sk: right-aligned q_offset, ragged blocks
    (200, 333, 2, 2, False),   # full attention, ragged kv tail
    (300, 300, 8, 2, True),    # GQA H/K = 4, lengths not block multiples
])
def test_flash_attention_plain_matches_pallas(rng, sq, sk, h, kh, causal):
    from grasp_any_region_tpu.ops.flash_attention import flash_attention

    d = 64
    q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, kh, d)).astype(np.float32)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                          block_q=128, block_k=128, interpret=True)
    for fn in (tflash.flash_attention_plain, tflash.flash_attention):
        out = fn(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert _counts() == (0, 0, 0)


def test_flash_attention_rejects_unported_options(rng):
    """Segment ids and the LSE output are ported (tests/test_torch_train_kernels.py);
    segment ids outside self-attention have no kernel and raise on any device."""
    q, k = torch.zeros(1, 8, 2, 64), torch.zeros(1, 12, 2, 64)
    with pytest.raises(ValueError, match="self-attention"):
        tflash.flash_attention(q, k, k, segment_ids=torch.ones(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="self-attention"):
        tflash.flash_attention(q, q, q, segment_ids=torch.ones(1, 9, dtype=torch.int32))
    out, lse = tflash.flash_attention(q, q, q, return_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 2, 8)


def test_decode_attention_fused_plain_matches_pallas(rng):
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_fused

    L, b, kh, s, d, h = 3, 2, 2, 256, 64, 8
    layer, prompt_pad, wpos = 2, 128, 170
    plens = np.array([100, 37], np.int32)  # prompt_lens < prompt_pad < wpos
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k_all = rng.standard_normal((L, b, kh, s, d)).astype(np.float32)
    v_all = rng.standard_normal((L, b, kh, s, d)).astype(np.float32)
    k_new = rng.standard_normal((b, kh, d)).astype(np.float32)
    v_new = rng.standard_normal((b, kh, d)).astype(np.float32)
    ref, k_ref, v_ref = decode_attention_fused(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(layer, jnp.int32),
        prompt_lens=jnp.asarray(plens), write_pos=jnp.asarray(wpos, jnp.int32),
        prompt_pad=prompt_pad, block_s=128, interpret=True)

    for fn in (tdec.decode_attention_fused_plain, tdec.decode_attention_fused):
        kc, vc = _t(k_all), _t(v_all)
        out = fn(_t(q), kc, vc, _t(k_new), _t(v_new), layer,
                 prompt_lens=torch.from_numpy(plens),
                 write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=prompt_pad)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        # column wpos of layer `layer` holds the new K/V ...
        np.testing.assert_array_equal(kc[layer, :, :, wpos].numpy(), k_new)
        np.testing.assert_array_equal(vc[layer, :, :, wpos].numpy(), v_new)
        # ... and every other entry is bit-identical to before (and to Pallas)
        k_exp, v_exp = k_all.copy(), v_all.copy()
        k_exp[layer, :, :, wpos], v_exp[layer, :, :, wpos] = k_new, v_new
        np.testing.assert_array_equal(kc.numpy(), k_exp)
        np.testing.assert_array_equal(vc.numpy(), v_exp)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(k_ref))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(v_ref))
    assert _counts() == (0, 0, 0)
