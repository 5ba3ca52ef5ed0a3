"""Kernel 24's surface: the port's `layer_norm_fused` and its plain version
against the JAX package's Pallas LayerNorm (`_ln_kernel`) in interpret mode
on the CPU, and the gradients of `layer_norm_fused_df` against `jax.grad`
through the JAX package's custom-gradient wrapper `_layer_norm_tpu`.

Tolerances: fp32 1e-5 (the same arithmetic, sums in another order); bf16
within one bf16 ulp of the output (one rounding of fp32 values that differ
in their last bits may fall on either side), plus 2^-20 where x w + b
cancels to near 0 (its fp32 rounding at the operands' scale, ~1, is then
larger than the output's ulp); gradients 1e-4, as the JAX package's own
wrapper test. The CUDA kernel is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu_torch.ops import norms as tnorms


def _ulp_bf16(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("d", [64, 256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_fused_matches_pallas(rng, d, dtype):
    from grasp_any_region_tpu.ops.norms import layer_norm_fused

    x = rng.standard_normal((3, 37, d)).astype(np.float32) * 2 + 0.5  # 111 rows: not a
    w = rng.standard_normal(d).astype(np.float32)                     # multiple of 16
    b = rng.standard_normal(d).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = layer_norm_fused(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                           block_rows=16, interpret=True)
    ref = np.asarray(ref, np.float32)
    args = [torch.from_numpy(a).to(tdt) for a in (x, w, b)]
    for fn in (tnorms.layer_norm_fused_plain, tnorms.layer_norm_fused):
        out = fn(*args)
        assert out.dtype == tdt and out.shape == x.shape
        got = out.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(got - ref) <= _ulp_bf16(ref) + 2.0 ** -20).all()
    out = tnorms.layer_norm_fused(*args, block_rows=4)  # the TPU tiling changes nothing
    assert torch.equal(out, tnorms.layer_norm_fused_plain(*args))
    assert tnorms.launches == 0  # a CPU tensor never launches the kernel


def test_layer_norm_fused_df_grads_match_the_jax_wrapper(rng, monkeypatch):
    """The port's autograd pair against `jax.grad` through `_layer_norm_tpu`,
    its forward in interpret mode (monkeypatched, as tests/test_ops.py does);
    the loss is sum(LN(x)^2) over a ragged row count."""
    from grasp_any_region_tpu.ops import norms as jnorms

    orig = jnorms.layer_norm_fused
    monkeypatch.setattr(jnorms, "layer_norm_fused", lambda x, w, b, eps=1e-6, **kw: orig(
        x, w, b, eps, interpret=True, block_rows=4))
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)

    def loss(x, w, b):
        return jnp.sum(jnorms._layer_norm_tpu(x, w, b, 1e-6) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (tnorms.layer_norm_fused_df(*args) ** 2).sum().backward()
    for a, r in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    # only what needs a gradient gets one
    x_only = torch.from_numpy(x).requires_grad_()
    tnorms.layer_norm_fused_df(x_only, torch.from_numpy(w), torch.from_numpy(b)).sum().backward()
    assert x_only.grad.shape == x.shape
