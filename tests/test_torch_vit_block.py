"""The fused ViT block of the PyTorch port (kernels D, E, F, G: plain
versions, rope tables, the fused form of `vision_forward`) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

Tolerance 1e-5 per op and 1e-4 per tower in fp32: the frameworks take the
same sums in another order, and a tower compounds the fp32 rounding over
its layers. The TPU kernels need S % 8 == 0, so their inputs are padded and
their outputs cut back to S; the port takes S as it is. The CUDA kernels
themselves are checked against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.ops import vit_attention as tva
from grasp_any_region_tpu_torch.ops import vit_block as tvb

TOL = dict(rtol=1e-5, atol=1e-5)
TOWER = dict(rtol=1e-4, atol=1e-4)
T, S, D, H = 2, 65, 128, 2  # S = 1 + 8 * 8 at the 112-pixel tile: not a multiple of 8


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pad(a, s_pad):
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, s_pad - a.shape[1]), (0, 0)))


def _no_launches():
    return tvb.launches == dict(D=0, F=0, G=0) and tva.launches == tva.launches_fused == 0


def _vision_cfg(mod, rope_mixed, fast_gelu):
    """The config of tests/test_vit_fused.py: width 128, 2 heads of 64, 112²."""
    return mod.VisionConfig(width=D, depth=2, num_heads=H, mlp_ratio=2.0,
                            img_size=(112, 112), patch_size=14, rope_mixed=rope_mixed,
                            fast_gelu=fast_gelu)


@pytest.mark.parametrize("op,layer_scale,fast_gelu", [
    ("ln_qkv", None, None),
    ("wo", True, None),
    ("wo", False, None),
    ("mlp", True, True),
    ("mlp", True, False),
    ("mlp", False, True),
])
def test_block_kernel_plain_matches_pallas(rng, op, layer_scale, fast_gelu):
    from grasp_any_region_tpu.ops import vit_block as jvb

    m = 2 * D
    s_pad = S + (-S) % 8

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = w(T, S, D, scale=1.0) + 0.5
    ln = (1.0 + w(D, scale=0.2), w(D, scale=0.2))
    ls = w(D, scale=0.5) if layer_scale else None
    jls = None if ls is None else jnp.asarray(ls)
    tls = None if ls is None else _t(ls)
    if op == "ln_qkv":
        args = (ln[0], ln[1], w(D, 3 * D), w(3 * D))
        ref = jvb.vit_ln_qkv(_pad(x, s_pad), *map(jnp.asarray, args), interpret=True)
        out = tvb.vit_ln_qkv(_t(x), *map(_t, args))
    elif op == "wo":
        attn, args = w(T, S, D, scale=1.0), (w(D, D), w(D))
        ref = jvb.vit_wo_residual(_pad(attn, s_pad), _pad(x, s_pad), *map(jnp.asarray, args),
                                  jls, interpret=True)
        out = tvb.vit_wo_residual(_t(attn), _t(x), *map(_t, args), tls)
    else:
        args = (ln[0], ln[1], w(D, m), w(m), w(m, D), w(D))
        ref = jvb.vit_mlp_residual(_pad(x, s_pad), *map(jnp.asarray, args), jls,
                                   fast_gelu=fast_gelu, interpret=True)
        out = tvb.vit_mlp_residual(_t(x), *map(_t, args), tls, fast_gelu=fast_gelu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :S], **TOL)
    assert _no_launches()  # a CPU tensor never launches a kernel


@pytest.mark.parametrize("s", [127, 129])
@pytest.mark.parametrize("layer_scale", [True, False])
def test_wo_residual_plain_matches_pallas_across_row_tiles(rng, s, layer_scale):
    """F's plain version at T * S rows on both sides of kernel F's 128-row
    tile edge (254 = 128 + 126, 258 = 2 x 128 + 2)."""
    from grasp_any_region_tpu.ops import vit_block as jvb

    s_pad = s + (-s) % 8
    x, attn = (rng.standard_normal((T, s, D)).astype(np.float32) for _ in range(2))
    wo, bo = (rng.standard_normal(shape).astype(np.float32) * 0.05 for shape in ((D, D), (D,)))
    ls = rng.standard_normal(D).astype(np.float32) * 0.5 if layer_scale else None
    ref = jvb.vit_wo_residual(_pad(attn, s_pad), _pad(x, s_pad), jnp.asarray(wo),
                              jnp.asarray(bo), None if ls is None else jnp.asarray(ls),
                              interpret=True)
    out = tvb.vit_wo_residual(_t(attn), _t(x), _t(wo), _t(bo), None if ls is None else _t(ls))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :s], **TOL)
    assert _no_launches()


def _wo_operands(case):
    """CPU operands of kernel F, the (2, 129, 256) accepted ones or one
    thing wrong with them."""
    d = 192 if case == "width" else 256
    attn, x = torch.zeros((2, 129, d), dtype=torch.bfloat16), torch.zeros((2, 129, d),
                                                                          dtype=torch.bfloat16)
    wo = torch.zeros((d, d), dtype=torch.bfloat16)
    if case == "dtype":
        attn = attn.float()
    elif case == "strided":
        x = torch.zeros((2, 129, 2 * d), dtype=torch.bfloat16)[..., :d]
    elif case == "misaligned":  # contiguous, but 2 bytes past an aligned base
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    elif case == "rows":
        attn = attn[:, :128]
    elif case == "weight":
        wo = torch.zeros((d, d + 128), dtype=torch.bfloat16)
    return attn, x, wo


def test_check_wo_residual_accepts_the_towers_operands():
    tvb.check_wo_residual(*_wo_operands("ok"))


@pytest.mark.parametrize("case,error", [("dtype", TypeError), ("strided", ValueError),
                                        ("misaligned", ValueError), ("width", ValueError),
                                        ("rows", ValueError), ("weight", ValueError)])
def test_check_wo_residual_refuses(case, error):
    with pytest.raises(error):
        tvb.check_wo_residual(*_wo_operands(case))


def _mlp_split_plain(x, ln_scale, ln_bias, fc1, b1, fc2, b2, ls=None, *, eps=1e-6,
                     fast_gelu=False):
    """G as the card runs it: the LayerNorm pass, fc1 + b1 and GELU rounded
    to x's dtype (the hidden that leaves the chip), then fc2 as kernel F's
    product and epilogue with K = M."""
    from grasp_any_region_tpu_torch.ops.norms import layer_norm

    xn = layer_norm(x, ln_scale, ln_bias, eps)
    h = tvb.gelu_f32(xn.float() @ fc1.float() + b1.float(), fast_gelu).to(x.dtype)
    return tvb.vit_wo_residual_plain(h, x, fc2, b2, ls)


def _mlp_args(rng, layer_scale, m=2 * D):
    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = w(T, S, D, scale=1.0) + 0.5
    args = (1.0 + w(D, scale=0.2), w(D, scale=0.2), w(D, m), w(m), w(m, D), w(D))
    return x, args, (w(D, scale=0.5) if layer_scale else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fast_gelu", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("layer_scale", [True, False], ids=["ls", "no_ls"])
def test_mlp_split_mirror_equals_plain(rng, dtype, fast_gelu, layer_scale):
    """G's split structure (LayerNorm, fc1 + GELU to a rounded hidden, F's
    product and epilogue on it) computes `vit_mlp_residual_plain` bit for
    bit: the hidden's trip through device memory moves no rounding point."""
    x, args, ls = _mlp_args(rng, layer_scale)
    x, args = _t(x).to(dtype), [_t(a).to(dtype) for a in args]
    ls = None if ls is None else _t(ls).to(dtype)
    want = tvb.vit_mlp_residual_plain(x, *args, ls, fast_gelu=fast_gelu)
    got = _mlp_split_plain(x, *args, ls, fast_gelu=fast_gelu)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("fast_gelu", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("layer_scale", [True, False], ids=["ls", "no_ls"])
def test_mlp_split_mirror_matches_pallas(rng, fast_gelu, layer_scale):
    """The split mirror against the JAX kernel in interpret mode at M = 4D,
    as `test_block_kernel_plain_matches_pallas` holds the plain version."""
    from grasp_any_region_tpu.ops import vit_block as jvb

    x, args, ls = _mlp_args(rng, layer_scale, m=4 * D)
    s_pad = S + (-S) % 8
    ref = jvb.vit_mlp_residual(_pad(x, s_pad), *map(jnp.asarray, args),
                               None if ls is None else jnp.asarray(ls), fast_gelu=fast_gelu,
                               interpret=True)
    out = _mlp_split_plain(_t(x), *map(_t, args), None if ls is None else _t(ls),
                           fast_gelu=fast_gelu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :S], **TOL)
    assert _no_launches()


def _block_operands(kernel, case):
    """CPU operands of kernel D (x, wqkv) or G (x, fc1, fc2) at (2, 129,
    256), hidden 512: the accepted ones, or one thing wrong with them."""
    d = 192 if case == "width" else 256
    n = (320 if case == "out_width" else 2 * d) if kernel == "mlp" else (
        3 * d + 64 if case == "out_width" else 3 * d)
    x = torch.zeros((2, 129, d), dtype=torch.bfloat16)
    ws = [torch.zeros((d, n), dtype=torch.bfloat16)]
    if kernel == "mlp":
        ws.append(torch.zeros((n, d), dtype=torch.bfloat16))
    if case == "dtype":
        ws[0] = ws[0].float()
    elif case == "strided":
        x = torch.zeros((2, 129, 2 * d), dtype=torch.bfloat16)[..., :d]
    elif case == "misaligned":  # contiguous, but 2 bytes past an aligned base
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    elif case == "shape":  # the last weight's rows or columns do not meet x's width
        ws[-1] = torch.zeros((ws[-1].shape[0], d + 128) if kernel == "mlp" else (d + 128, n),
                             dtype=torch.bfloat16)
    return x, *ws


CHECKS = dict(ln_qkv=tvb.check_ln_qkv, mlp=tvb.check_mlp_residual)


@pytest.mark.parametrize("kernel", ["ln_qkv", "mlp"])
def test_block_checks_accept_the_towers_operands(kernel):
    CHECKS[kernel](*_block_operands(kernel, "ok"))


@pytest.mark.parametrize("case,error", [("dtype", TypeError), ("strided", ValueError),
                                        ("misaligned", ValueError), ("width", ValueError),
                                        ("out_width", ValueError), ("shape", ValueError)])
@pytest.mark.parametrize("kernel", ["ln_qkv", "mlp"])
def test_block_checks_refuse(kernel, case, error):
    """check_ln_qkv and check_mlp_residual refuse, on CPU tensors, a weight
    that is not bfloat16, a non-contiguous x, a misaligned base, D (and N
    or M) not a multiple of 128, and a weight whose shape does not meet x."""
    with pytest.raises(error):
        CHECKS[kernel](*_block_operands(kernel, case))


def _angles(rng, mixed):
    """(H|1, N, d/2) rope angles of the 8 x 8 patch grid: per head (mixed,
    random learned frequencies) or one table for all heads (axial)."""
    from grasp_any_region_tpu_torch.ops.rope import axial_rope_angles, mixed_rope_angles

    cfg = _vision_cfg(tcfg, mixed, False)
    if not mixed:
        return axial_rope_angles(cfg)[None].numpy()
    freqs = rng.uniform(-1.0, 1.0, (1, H, 32, 2)).astype(np.float32)
    return mixed_rope_angles(torch.from_numpy(freqs), cfg)[0].numpy()


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "axial"])
def test_rope_head_tables_match_pair_tables(rng, mixed):
    from grasp_any_region_tpu.ops.rope import rope_pair_tables
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    ang = _angles(rng, mixed)
    s_pad = S + (-S) % 8
    cos2, sin2 = rope_pair_tables(jnp.broadcast_to(ang, (H,) + ang.shape[1:]), s_pad, 1)
    cos, sin = rope_head_tables(torch.from_numpy(ang), H, 1)
    assert cos.shape == sin.shape == (H, S, 64) and cos.dtype == torch.float32
    for port, pair in ((cos, cos2), (sin, sin2)):
        per_head = np.asarray(pair).reshape(H // 2, s_pad, 2, 64).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(port.numpy(), per_head.reshape(H, s_pad, 64)[:, :S],
                                   rtol=1e-6, atol=1e-6)
    assert (cos[:, 0] == 1).all() and (sin[:, 0] == 0).all()  # CLS: identity


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "axial"])
def test_vit_attention_fused_qkv_plain_matches_pallas(rng, mixed):
    from grasp_any_region_tpu.ops.rope import rope_pair_tables
    from grasp_any_region_tpu.ops.vit_attention import vit_attention_fused_qkv as jfused
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    ang = _angles(rng, mixed)
    qkv = rng.standard_normal((T, S, 3 * D)).astype(np.float32)
    s_pad = S + (-S) % 8
    cos2, sin2 = rope_pair_tables(jnp.broadcast_to(ang, (H,) + ang.shape[1:]), s_pad, 1)
    ref = jfused(_pad(qkv, s_pad), cos2, sin2, H, 64, kv_valid=S, interpret=True)
    cos, sin = rope_head_tables(torch.from_numpy(ang), H, 1)
    out = tva.vit_attention_fused_qkv(_t(qkv), cos, sin, H, 64)
    assert out.shape == (T, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :S], **TOL)
    assert _no_launches()


def _vision_pair(rope_mixed, fast_gelu, seed):
    """JAX vision params at the fused test config and the port's copy."""
    from grasp_any_region_tpu.models.vision import init_vision_params
    from grasp_any_region_tpu_torch.models.vision import VisionParams

    cfg_j = _vision_cfg(jcfg, rope_mixed, fast_gelu)
    cfg_t = _vision_cfg(tcfg, rope_mixed, fast_gelu)
    params = init_vision_params(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    tparams = VisionParams(cfg_t, dtype=torch.float32)
    with torch.no_grad():
        for name, p in tparams.named_parameters():
            node = params
            for key in name.split("."):
                node = node[key]
            p.copy_(_t(node))
    return cfg_j, cfg_t, params, tparams


@pytest.mark.parametrize("rope_mixed,fast_gelu", [(True, False), (False, True)],
                         ids=["mixed_erf", "axial_tanh"])
def test_vision_forward_fused_matches_jax(rng, rope_mixed, fast_gelu):
    from grasp_any_region_tpu.models.vision import vision_forward as jforward
    from grasp_any_region_tpu_torch.models.vision import vision_forward as tforward

    cfg_j, cfg_t, params, tparams = _vision_pair(rope_mixed, fast_gelu, seed=1)
    pix = rng.standard_normal((T, 3, 112, 112)).astype(np.float32)
    me = (rng.standard_normal((T, cfg_t.num_patches, D)) * 0.1).astype(np.float32)
    ref = jforward(params, cfg_j, jnp.asarray(pix), mask_embeds=jnp.asarray(me),
                   compute_dtype=jnp.float32, fused_blocks=True)
    out = tforward(tparams, cfg_t, _t(pix), _t(me), compute_dtype=torch.float32,
                   fused_blocks=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOWER)
    assert _no_launches()


@pytest.mark.parametrize("rope_mixed", [True, False], ids=["mixed", "axial"])
def test_vision_forward_fused_matches_unfused(rng, rope_mixed):
    """The port's two forms of the tower agree at the JAX package's
    tolerance for the same check (tests/test_vit_fused.py)."""
    from grasp_any_region_tpu_torch.models.vision import vision_forward

    _, cfg, _, tparams = _vision_pair(rope_mixed, True, seed=0)
    pix = _t(rng.standard_normal((T, 3, 112, 112)))
    fused = vision_forward(tparams, cfg, pix, compute_dtype=torch.float32, fused_blocks=True)
    plain = vision_forward(tparams, cfg, pix, compute_dtype=torch.float32, fused_blocks=False)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=2e-3, atol=2e-4)


def test_vision_forward_auto_form_on_cpu_is_unfused(rng, monkeypatch):
    """fused_blocks=None takes the fused form only on a CUDA tensor: on a
    CPU tensor the unfused form runs and no kernel is counted."""
    from grasp_any_region_tpu_torch.models import vision as tv

    _, cfg, _, tparams = _vision_pair(True, True, seed=0)
    assert cfg.head_dim == 64 and cfg.num_heads % 2 == 0 and cfg.use_rope
    pix = _t(rng.standard_normal((T, 3, 112, 112)))
    ref = tv.vision_forward(tparams, cfg, pix, compute_dtype=torch.float32, fused_blocks=False)

    def fail(*args):
        raise AssertionError("the fused form ran on a CPU tensor")

    monkeypatch.setattr(tv, "_fused_block", fail)
    out = tv.vision_forward(tparams, cfg, pix, compute_dtype=torch.float32)
    assert torch.equal(out, ref)
    assert _no_launches()
    no_rope = dataclasses.replace(cfg, use_rope=False)
    with pytest.raises(ValueError, match="rope"):
        tv.vision_forward(tparams, no_rope, pix, fused_blocks=True)
