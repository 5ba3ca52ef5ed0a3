"""The layer-indexed decode matmuls of the PyTorch port (kernels H, I, J:
plain versions, CPU dispatch) and its fused decode step, against the JAX
package's Pallas kernels and fused step, run in interpret mode on the CPU.

Tolerance 1e-5 per op and rtol 1e-4 / atol 1e-5 per decode step in fp32:
the frameworks take the same sums in another order, and a step compounds
the fp32 rounding over its layers (the JAX package's own fused-step test
uses the same bounds). The TPU kernels need Dout % block_n == 0, so the
widths here are multiples of 128 (or the whole width); the port takes any
multiple of 8. The CUDA kernels themselves are checked against these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

TOL = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-5)
L, LAYER, DIN = 3, 1, 96  # DIN: not a multiple of the CUDA kernels' 64-row slabs


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))  # a copy: the step writes in place


def _no_launches():
    return (not any(tlm.launches.values()) and tdec.launches == 0
            and tdec.launches_q8 == 0)


def _op_case(rng, op, b):
    """(JAX function, port plain version, port wrapper, arrays) of one op."""
    from grasp_any_region_tpu.ops import layer_matmul as jlm

    def w(*shape):
        return (rng.standard_normal(shape) * DIN ** -0.5).astype(np.float32)

    x = rng.standard_normal((b, DIN)).astype(np.float32)
    if op == "matmul":
        return jlm.layer_matmul, tlm.layer_matmul_plain, tlm.layer_matmul, (x, w(L, DIN, 128))
    if op == "swiglu":
        return (jlm.layer_swiglu, tlm.layer_swiglu_plain, tlm.layer_swiglu,
                (x, w(L, DIN, 256), w(L, DIN, 256)))
    return (jlm.layer_qkv, tlm.layer_qkv_plain, tlm.layer_qkv,
            (x, w(L, DIN, 128), w(L, DIN, 32), w(L, DIN, 32)))


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", ["matmul", "swiglu", "qkv"])
def test_layer_kernel_matches_pallas(rng, op, b, fn):
    jax_fn, plain, wrapper, arrays = _op_case(rng, op, b)
    ref = jax_fn(*map(jnp.asarray, arrays), jnp.asarray(LAYER, jnp.int32), interpret=True)
    out = (plain if fn == "plain" else wrapper)(*map(_t, arrays), LAYER)
    refs, outs = (ref, out) if op == "qkv" else ((ref,), (out,))
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert _no_launches()  # a CPU tensor never launches a kernel


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,error", [
    ("fits", None),
    ("x_fp32", TypeError),
    ("w_fp32", TypeError),
    ("layer_past_end", IndexError),
    ("layer_negative", IndexError),
    ("x_not_contiguous", ValueError),
    ("x_misaligned", ValueError),
    ("rows_past_32", ValueError),
    ("din_not_multiple_of_8", ValueError),
    ("dout_not_multiple_of_8", ValueError),
    ("w_din_differs", ValueError),
    ("w_one_layer", ValueError),
])
def test_layer_kernel_operand_check(case, error):
    """The check the wrappers run before a launch on the card: what the
    kernels cannot take raises, with the error type the GPU tests expect."""
    x, w, layer = _bf16(3, 64), _bf16(L, 64, 128), LAYER
    if case == "x_fp32":
        x = x.float()
    elif case == "w_fp32":
        w = w.float()
    elif case == "layer_past_end":
        layer = L
    elif case == "layer_negative":
        layer = -1
    elif case == "x_not_contiguous":
        x = _bf16(64, 3).t()
    elif case == "x_misaligned":
        x = _bf16(3 * 64 + 1)[1:].view(3, 64)  # contiguous, 2 bytes past a 16-byte boundary
    elif case == "rows_past_32":
        x = _bf16(tlm.MAX_ROWS + 1, 64)
    elif case == "din_not_multiple_of_8":
        x, w = _bf16(3, 60), _bf16(L, 60, 128)
    elif case == "dout_not_multiple_of_8":
        w = _bf16(L, 64, 100)
    elif case == "w_din_differs":
        w = _bf16(L, 72, 128)
    elif case == "w_one_layer":
        w = w[LAYER]
    if error is None:
        tlm._check(x, layer, w, w, w)
    else:
        with pytest.raises(error):
            tlm._check(x, layer, w, w, w)


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (8 significant bits)."""
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def test_layer_swiglu_bf16_rounds_once(rng):
    """At bf16, SiLU * up is taken in fp32 from the fp32 sums and rounded
    once, as JAX's kernel does: the port's output is within one bf16 ulp
    of it (the sums differ only in order). The XLA form, which rounds gate,
    up and their product separately, is not."""
    from grasp_any_region_tpu.ops.layer_matmul import layer_swiglu as jswiglu

    b, din, m = 3, 256, 256
    x = rng.standard_normal((b, din)).astype(np.float32)
    wg, wu = (rng.standard_normal((L, din, m)).astype(np.float32) * din ** -0.5
              for _ in range(2))
    ref = jswiglu(*(jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu)),
                  jnp.asarray(LAYER, jnp.int32), interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    xb, gb, ub = (_t(a).to(torch.bfloat16) for a in (x, wg, wu))
    out = tlm.layer_swiglu(xb, gb, ub, LAYER)
    assert out.dtype == torch.bfloat16
    gap = np.abs(out.float().numpy() - ref)
    assert (gap <= _bf16_ulp(ref)).all(), gap.max()
    three = (torch.nn.functional.silu(xb @ gb[LAYER]) * (xb @ ub[LAYER])).float().numpy()
    assert (np.abs(three - ref) > _bf16_ulp(ref)).any()
    assert _no_launches()


def _decode_setup(rng, rope_scaling=None):
    """gar_tiny decoder params (seeded, in both frameworks), an unpaired
    cache with ragged prompt_lens and a mid-cache write_pos, one input."""
    from grasp_any_region_tpu.models.llama import KVCache as JCache
    from grasp_any_region_tpu_torch.models.llama import KVCache, LlamaParams

    cfg_j = dataclasses.replace(jcfg.gar_tiny().text, rope_scaling_factor=rope_scaling)
    cfg_t = dataclasses.replace(tcfg.gar_tiny().text, rope_scaling_factor=rope_scaling)
    d, m, n = cfg_t.hidden_size, cfg_t.intermediate_size, cfg_t.num_layers
    qd, kd = cfg_t.num_heads * cfg_t.head_dim, cfg_t.num_kv_heads * cfg_t.head_dim
    shapes = dict(wq=(n, d, qd), wk=(n, d, kd), wv=(n, d, kd), wo=(n, qd, d),
                  w_gate=(n, d, m), w_up=(n, d, m), w_down=(n, m, d))
    blocks = {k: (rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
              for k, s in shapes.items()}
    for name in ("attn_norm", "mlp_norm"):
        blocks[name] = (1.0 + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    tparams = LlamaParams(cfg_t, vocab_rows=8, dtype=torch.float32)
    with torch.no_grad():
        for name, arr in blocks.items():
            getattr(tparams.blocks, name).copy_(_t(arr))
    jparams = {"blocks": {k: jnp.asarray(v) for k, v in blocks.items()}}

    b, s_max, prompt_pad, wpos = 3, 64, 32, 35
    plens = np.array([17, 30, 9], np.int32)
    kv = [rng.standard_normal((n, b, cfg_t.num_kv_heads, s_max, cfg_t.head_dim))
          .astype(np.float32) for _ in range(2)]
    emb = rng.standard_normal((b, 1, d)).astype(np.float32)
    jcache = JCache(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]), prompt_lens=jnp.asarray(plens),
                    write_pos=jnp.asarray(wpos, jnp.int32))

    def tcache():
        return KVCache(k=_t(kv[0]), v=_t(kv[1]), prompt_lens=torch.from_numpy(plens),
                       write_pos=torch.tensor(wpos, dtype=torch.int32))

    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jparams=jparams, tparams=tparams, jcache=jcache,
                tcache=tcache, emb=emb, prompt_pad=prompt_pad, wpos=wpos)


@pytest.mark.parametrize("rope_scaling", [None, 32.0], ids=["tiny", "llama3_rope"])
@pytest.mark.parametrize("reference", ["jax_fused", "jax_xla", "port_xla"])
def test_fused_decode_step(rng, reference, rope_scaling):
    """The port's fused step against JAX `llama_decode_step_fused` (Pallas
    interpret mode), JAX's XLA form, and the port's own XLA form: hidden,
    the whole K/V cache, and write_pos."""
    from grasp_any_region_tpu.models import llama as jl
    from grasp_any_region_tpu_torch.models import llama as tl

    c = _decode_setup(rng, rope_scaling)
    pad = c["prompt_pad"]
    if reference.startswith("jax"):
        args = (c["jparams"], c["cfg_j"], jnp.asarray(c["emb"]), c["jcache"], pad)
        if reference == "jax_fused":
            h_ref, cache_ref = jl.llama_decode_step_fused(*args, interpret=True)
        else:
            h_ref, cache_ref = jl.llama_decode_step(*args, use_kernel=False)
    else:
        h_ref, cache_ref = tl.llama_decode_step(c["tparams"], c["cfg_t"], _t(c["emb"]),
                                                c["tcache"](), pad, use_kernel=False)
    cache = c["tcache"]()
    h, out_cache = tl.llama_decode_step(c["tparams"], c["cfg_t"], _t(c["emb"]), cache, pad,
                                        use_kernel="fused")
    assert out_cache is cache and h.shape == (3, 1, c["cfg_t"].hidden_size)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **STEP)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(cache_ref.k), **STEP)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(cache_ref.v), **STEP)
    assert int(cache.write_pos) == int(cache_ref.write_pos) == c["wpos"] + 1
    assert _no_launches()


def test_decode_auto_rule_on_cpu(rng, monkeypatch):
    """use_kernel=None takes the XLA form on a CPU tensor (no launches), as
    JAX takes it off the TPU; GAR_DECODE_PATH (default "fused") on a CUDA
    device; "mega" runs the mega form's plain versions on the CPU, through
    gar_decode_step too."""
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.models import gar as tg, llama as tl

    c = _decode_setup(rng)
    cfg, params, pad = c["cfg_t"], c["tparams"], c["prompt_pad"]
    monkeypatch.delenv("GAR_DECODE_PATH", raising=False)
    assert tl.decode_kernel_choice(cfg, torch.device("cuda", 0)) == "fused"
    assert tl.decode_kernel_choice(cfg, "cpu") is False
    ref, _ = tl.llama_decode_step(params, cfg, _t(c["emb"]), c["tcache"](), pad,
                                  use_kernel=False)

    def fail(*args, **kwargs):
        raise AssertionError("the fused form ran on a CPU tensor")

    monkeypatch.setattr(tl, "llama_decode_step_fused", fail)
    for auto in (None, True):
        out, cache = tl.llama_decode_step(params, cfg, _t(c["emb"]), c["tcache"](), pad,
                                          use_kernel=auto)
        assert torch.equal(out, ref) and int(cache.write_pos) == c["wpos"] + 1
    assert _no_launches()
    mega, cache = tl.llama_decode_step(params, cfg, _t(c["emb"]), c["tcache"](), pad,
                                       use_kernel="mega")
    np.testing.assert_allclose(mega.numpy(), ref.numpy(), **STEP)
    assert int(cache.write_pos) == c["wpos"] + 1
    gcfg = dataclasses.replace(gar_tiny(), text=cfg)
    gparams = tg.GARParams(gcfg, dtype=torch.float32)
    logits, cache = tg.gar_decode_step(gparams, gcfg, torch.tensor([1, 2, 3], dtype=torch.int32),
                                       c["tcache"](), pad, use_kernel="mega")
    assert logits.shape[0] == 3 and int(cache.write_pos) == c["wpos"] + 1
    assert _no_launches()
