"""The mega decode step of the PyTorch port (kernels 19-23: plain versions,
CPU dispatch, operand checks) against the JAX package's Pallas kernels in
interpret mode and its decode steps, on the CPU.

Tolerance 1e-5 per op and rtol 1e-4 / atol 1e-5 per decode step in fp32,
as tests/test_torch_layer_matmul.py: the frameworks take the same sums in
another order (and the int8 kernels scale the weight before the sum in JAX,
the sum after it in the port). The TPU MLP kernels need M % block_n == 0 and
the attention kernel S % block_s == 0; block_n and block_s are set so that
each runs more than one grid step. The CUDA kernels are checked against
these plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.models import quantize as tq
from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import decode_megakernel as tmk
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

TOL = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-5)
L, LAYER, D, DH, EPS = 3, 1, 96, 64, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: the attention kernel writes in place


def _no_launches():
    return (not any(tmk.launches.values()) and not any(tlm.launches.values())
            and tdec.launches == 0 and tdec.launches_q8 == 0)


def _w(rng, *shape):
    return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)


def _q8(w):
    """int8 values and fp32 column scales of an fp32 (L, Din, N) stack."""
    q, s = tq.quantize_int8(torch.from_numpy(w))
    return q.numpy(), s.numpy()


def _norm(rng):
    return (1.0 + 0.2 * rng.standard_normal((L, D))).astype(np.float32)


def _rope_tables(rng, b, n):
    """JAX's tiled (B, n) cos / sin of seeded positions, and the port's
    (B, DH) rows of the same angles."""
    ang = rng.uniform(0, 40, (b, DH // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], -1)
    rows = np.cos(ang), np.sin(ang)
    return rows, tuple(np.tile(r, (1, n // DH)) for r in rows)


def _qkv_case(rng, b, q8):
    """(JAX function, port plain, port wrapper, JAX args, port args)."""
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    hq, hk = 2 * DH, DH
    x = rng.standard_normal((b, D)).astype(np.float32)
    ws = [_w(rng, L, D, n) for n in (hq, hk, hk)]
    (cos, sin), (cq, sq) = _rope_tables(rng, b, hq)
    ck, sk = cq[:, :hk], sq[:, :hk]
    if q8:
        mats = [a for w in ws for a in _q8(w)]
        fns = jmk.layer_qkv_norm_rope_q8, tmk.layer_qkv_norm_rope_q8_plain, \
            tmk.layer_qkv_norm_rope_q8
    else:
        mats = ws
        fns = jmk.layer_qkv_norm_rope, tmk.layer_qkv_norm_rope_plain, tmk.layer_qkv_norm_rope
    norm = _norm(rng)
    return (*fns, (x, norm, *mats, cq, sq, ck, sk), (x, norm, *mats, cos, sin, cos, sin))


def _mlp_case(rng, b, q8):
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    m = 512
    x = rng.standard_normal((b, D)).astype(np.float32)
    ws = _w(rng, L, D, m), _w(rng, L, D, m), _w(rng, L, m, D)
    if q8:
        mats = [a for w in ws for a in _q8(w)]
        fns = jmk.layer_mlp_residual_q8, tmk.layer_mlp_residual_q8_plain, \
            tmk.layer_mlp_residual_q8
    else:
        mats = list(ws)
        fns = jmk.layer_mlp_residual, tmk.layer_mlp_residual_plain, tmk.layer_mlp_residual
    args = (x, _norm(rng), *mats)
    return (*fns, args, args)


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", ["qkv_norm_rope", "qkv_norm_rope_q8", "mlp_residual",
                                "mlp_residual_q8"])
def test_mega_layer_kernel_matches_pallas(rng, op, b, fn):
    """Kernels 19, 20, 23, 21: the plain version (and the wrapper on a CPU
    tensor) against the Pallas kernel in interpret mode. 19 and 20 get
    JAX's tiled rope tables on the JAX side and (B, 64) rows on the port's;
    the MLP kernels run four grid steps (block_n 128 of M = 512)."""
    q8 = op.endswith("q8")
    case = _qkv_case if op.startswith("qkv") else _mlp_case
    jax_fn, plain, wrapper, jargs, targs = case(rng, b, q8)
    layer = jnp.asarray(LAYER, jnp.int32)
    if op.startswith("qkv"):
        ref = jax_fn(*map(jnp.asarray, jargs), layer, eps=EPS, head_dim=DH, interpret=True)
        out = (plain if fn == "plain" else wrapper)(*map(_t, targs), LAYER, eps=EPS,
                                                    head_dim=DH)
    else:
        ref = (jax_fn(*map(jnp.asarray, jargs), layer, eps=EPS, block_n=128, interpret=True),)
        out = ((plain if fn == "plain" else wrapper)(*map(_t, targs), LAYER, eps=EPS),)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert _no_launches()  # a CPU tensor never launches a kernel


def _attention_case(rng, b, q8):
    """JAX's own case (tests/test_kernels.py): ragged prompt_lens, a
    mid-cache write_pos; 4 query heads over 2 kv heads of 64, S = 64."""
    s, pad, wpos, h, kh = 64, 32, 35, 4, 2
    plens = np.array([17, 30, 9][:b], np.int32)
    q = rng.standard_normal((b, h, DH)).astype(np.float32)
    k_all, v_all = (rng.standard_normal((L, b, kh, s, DH)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, kh, DH)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((b, D)).astype(np.float32)
    wo = _w(rng, L, h * DH, D)
    wo, wo_scale = _q8(wo) if q8 else (wo, None)
    return (q, k_all, v_all, k_new, v_new, wo, x), wo_scale, plens, pad, wpos


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("wo", ["fp32", "int8"])
def test_decode_attention_wo_matches_pallas(rng, wo, b, fn):
    """Kernel 22 against the Pallas kernel in interpret mode (block_s 16:
    four blocks of history): the new residual and the whole cache, written
    at column write_pos in place."""
    from grasp_any_region_tpu.ops import decode_megakernel as jmk

    arrays, wo_scale, plens, pad, wpos = _attention_case(rng, b, wo == "int8")
    jx, jk, jv = jmk.decode_attention_wo(
        *map(jnp.asarray, arrays), jnp.asarray(LAYER, jnp.int32),
        prompt_lens=jnp.asarray(plens), write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad,
        wo_scale=None if wo_scale is None else jnp.asarray(wo_scale), block_s=16,
        interpret=True)
    targs = list(map(_t, arrays))
    kw = dict(prompt_lens=torch.from_numpy(plens), write_pos=torch.tensor(wpos, dtype=torch.int32),
              prompt_pad=pad, wo_scale=None if wo_scale is None else _t(wo_scale))
    out = (tmk.decode_attention_wo_plain if fn == "plain" else tmk.decode_attention_wo)(
        *targs, LAYER, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_array_equal(targs[1].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(targs[2].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(targs[1][LAYER, :, :, wpos].numpy(), arrays[3])
    assert _no_launches()


# ------------------------------------------------------------- the mega step


def _llm(rng, q8):
    """gar_tiny decoder params (seeded), in both frameworks: fp32 weights,
    or int8 weights with the bf16 copies dropped (so JAX's XLA step
    projects through the int8 ones, as the mega step does)."""
    from grasp_any_region_tpu_torch.models.llama import LlamaParams

    cfg_j, cfg_t = jcfg.gar_tiny().text, tcfg.gar_tiny().text
    d, m, n = cfg_t.hidden_size, cfg_t.intermediate_size, cfg_t.num_layers
    qd, kd = cfg_t.num_heads * cfg_t.head_dim, cfg_t.num_kv_heads * cfg_t.head_dim
    shapes = dict(wq=(n, d, qd), wk=(n, d, kd), wv=(n, d, kd), wo=(n, qd, d),
                  w_gate=(n, d, m), w_up=(n, d, m), w_down=(n, m, d))
    blocks = {k: _w(rng, *s) for k, s in shapes.items()}
    for name in ("attn_norm", "mlp_norm"):
        blocks[name] = (1.0 + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    if q8:
        for name in shapes:
            blocks[f"{name}_q8"], blocks[f"{name}_scale"] = _q8(blocks.pop(name))
    tparams = LlamaParams(cfg_t, vocab_rows=8, dtype=torch.float32,
                          q8=tuple(shapes) if q8 else None, drop_bf16=q8)
    with torch.no_grad():
        for name, arr in blocks.items():
            getattr(tparams.blocks, name).copy_(_t(arr))
    jparams = {"blocks": {k: jnp.asarray(v) for k, v in blocks.items()}}
    return cfg_j, cfg_t, jparams, tparams


def _caches(rng, cfg_t, b=3):
    from grasp_any_region_tpu.models.llama import KVCache as JCache
    from grasp_any_region_tpu_torch.models.llama import KVCache

    s_max, pad = 64, 32
    plens = np.array([17, 30, 9][:b], np.int32)
    kv = [rng.standard_normal((cfg_t.num_layers, b, cfg_t.num_kv_heads, s_max, cfg_t.head_dim))
          .astype(np.float32) for _ in range(2)]
    jcache = JCache(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]), prompt_lens=jnp.asarray(plens),
                    write_pos=jnp.asarray(pad, jnp.int32))
    tcache = KVCache(k=_t(kv[0]), v=_t(kv[1]), prompt_lens=torch.from_numpy(plens),
                     write_pos=torch.tensor(pad, dtype=torch.int32))
    return jcache, tcache, pad


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("reference", ["jax_xla", "jax_mega"])
def test_mega_decode_steps_match_jax(rng, reference, weights):
    """Three mega steps of the port against JAX's XLA step
    (`use_kernel=False`) or JAX's mega step (Pallas interpret mode), at
    gar_tiny fp32, with fp32 weights or int8 weights: hidden, the whole
    cache and write_pos after each step."""
    from grasp_any_region_tpu.models import llama as jl
    from grasp_any_region_tpu_torch.models import llama as tl

    cfg_j, cfg_t, jparams, tparams = _llm(rng, weights == "int8")
    jcache, tcache, pad = _caches(rng, cfg_t)
    for step in range(3):
        emb = rng.standard_normal((3, 1, cfg_t.hidden_size)).astype(np.float32)
        if reference == "jax_mega":
            h_ref, jcache = jl.llama_decode_step_mega(jparams, cfg_j, jnp.asarray(emb), jcache,
                                                      pad, interpret=True)
        else:
            h_ref, jcache = jl.llama_decode_step(jparams, cfg_j, jnp.asarray(emb), jcache, pad,
                                                 use_kernel=False)
        h, out = tl.llama_decode_step(tparams, cfg_t, _t(emb), tcache, pad, use_kernel="mega")
        assert out is tcache and h.shape == (3, 1, cfg_t.hidden_size)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **STEP)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **STEP)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **STEP)
        assert int(tcache.write_pos) == int(jcache.write_pos) == pad + step + 1
    assert _no_launches()


def test_mega_greedy_tokens_match_the_xla_step(rng, monkeypatch):
    """Eight greedy steps of the port's mega step give the XLA step's
    tokens at gar_tiny fp32 (the step's hidden through a seeded head);
    GAR_DECODE_PATH=mega leaves the CPU's choice at the XLA form."""
    from grasp_any_region_tpu_torch.models import llama as tl

    _, cfg, _, params = _llm(rng, False)
    head = torch.from_numpy(rng.standard_normal((cfg.hidden_size, 50)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((50, cfg.hidden_size)).astype(np.float32))
    monkeypatch.setenv("GAR_DECODE_PATH", "mega")
    assert tl.decode_kernel_choice(cfg, "cpu") is False
    assert tl.decode_kernel_choice(cfg, torch.device("cuda", 0)) == "mega"
    tokens = {}
    for form in ("mega", None):
        _, cache, pad = _caches(np.random.default_rng(5), cfg)
        tok, seq = torch.tensor([1, 2, 3]), []
        for _ in range(8):
            h, cache = tl.llama_decode_step(params, cfg, table[tok][:, None], cache, pad,
                                            use_kernel=form)
            tok = (h[:, 0] @ head).argmax(-1)
            seq.append(tok.tolist())
        tokens[form] = seq
    assert tokens["mega"] == tokens[None]
    assert len({t for step in tokens[None] for t in step}) > 3  # not one repeated token
    assert _no_launches()


# ------------------------------------------------------------- operand checks


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _i8(*shape):
    return torch.zeros(shape, dtype=torch.int8)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


QKV_CASES = [("fits", None), ("x_fp32", TypeError), ("w_fp32", TypeError),
             ("norm_fp32", TypeError), ("layer_past_end", IndexError),
             ("head_dim_32", ValueError), ("rows_past_32", ValueError),
             ("heads_not_whole", ValueError), ("table_width", ValueError),
             ("wv_differs", ValueError)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case,error", QKV_CASES)
def test_qkv_norm_rope_operand_check(case, error, q8):
    """What kernels 19 and 20 cannot take raises before a launch."""
    b, hq, hk, head_dim, layer = 3, 128, 64, 64, LAYER
    x, norm = _bf16(b, 64), _bf16(L, 64)
    mk = _i8 if q8 else _bf16
    ws = [mk(L, 64, hq), mk(L, 64, hk), mk(L, 64, hk)]
    tables = [_f32(b, 64)] * 4
    if case == "x_fp32":
        x = x.float()
    elif case == "w_fp32":
        ws[0] = ws[0].float()
    elif case == "norm_fp32":
        norm = norm.float()
    elif case == "layer_past_end":
        layer = L
    elif case == "head_dim_32":
        head_dim = 32
    elif case == "rows_past_32":
        x = _bf16(tmk.MAX_ROWS + 1, 64)
    elif case == "heads_not_whole":
        ws[0] = mk(L, 64, 96)
    elif case == "table_width":
        tables[0] = _f32(b, 32)
    elif case == "wv_differs":
        ws[2] = mk(L, 64, 128)
    scales = None if not q8 else [_f32(L, 1, w.shape[-1]) for w in ws]

    def run():
        tmk.check_qkv_norm_rope(x, norm, ws, scales, tables, layer, head_dim)

    if error is None:
        run()
    else:
        with pytest.raises(error):
            run()


MLP_CASES = [("fits", None), ("x_fp32", TypeError), ("w_fp32", TypeError),
             ("scale_bf16", TypeError), ("layer_negative", IndexError),
             ("d_not_multiple_of_128", ValueError), ("m_not_multiple_of_128", ValueError),
             ("down_shape", ValueError), ("x_not_contiguous", ValueError)]


@pytest.mark.parametrize("case,error,q8", [
    (c, e, q8) for q8 in (False, True) for c, e in MLP_CASES if q8 or c != "scale_bf16"])
def test_mlp_residual_operand_check(case, error, q8):
    """What kernels 23 and 21 cannot take raises before a launch."""
    b, d, m, layer = 2, 128, 256, LAYER
    mk = _i8 if q8 else _bf16
    x, norm = _bf16(b, d), _bf16(L, d)
    wg, wu, wd = mk(L, d, m), mk(L, d, m), mk(L, m, d)
    scales = [_f32(L, 1, m), _f32(L, 1, m), _f32(L, 1, d)] if q8 else None
    if case == "x_fp32":
        x = x.float()
    elif case == "w_fp32":
        wu = wu.float()
    elif case == "scale_bf16":
        scales[2] = scales[2].bfloat16()
    elif case == "layer_negative":
        layer = -1
    elif case == "d_not_multiple_of_128":
        x, norm = _bf16(b, 192), _bf16(L, 192)
        wg, wu, wd = mk(L, 192, m), mk(L, 192, m), mk(L, m, 192)
    elif case == "m_not_multiple_of_128":
        wg, wu, wd = mk(L, d, 192), mk(L, d, 192), mk(L, 192, d)
    elif case == "down_shape":
        wd = mk(L, d, m)
    elif case == "x_not_contiguous":
        x = _bf16(d, b).t()

    def run():
        tmk.check_mlp_residual(x, norm, wg, wu, wd, scales, layer)

    if error is None:
        run()
    else:
        with pytest.raises(error):
            run()


ATTN_CASES = [("fits", None), ("q_fp32", TypeError), ("wo_fp32", TypeError),
              ("head_dim_32", ValueError), ("group_3", ValueError), ("kv_heads_16", ValueError),
              ("layer_past_end", IndexError), ("k_new_shape", ValueError),
              ("write_pos_int64", ValueError), ("dm_past_4096", ValueError)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case,error", ATTN_CASES)
def test_attention_wo_operand_check(case, error, q8):
    """What kernel 22 cannot take raises before a launch."""
    b, h, kh, s, d, dm, layer = 2, 4, 2, 128, 64, 256, LAYER
    q, x = _bf16(b, h, d), _bf16(b, dm)
    k_all = v_all = _bf16(L, b, kh, s, d)
    k_new = v_new = _bf16(b, kh, d)
    wo = (_i8 if q8 else _bf16)(L, h * d, dm)
    wo_scale = _f32(L, 1, dm) if q8 else None
    plens, wpos = torch.zeros(b, dtype=torch.int32), torch.tensor(64, dtype=torch.int32)
    if case == "q_fp32":
        q = q.float()
    elif case == "wo_fp32":
        wo = wo.float()
    elif case == "head_dim_32":
        q, k_all, k_new = _bf16(b, h, 32), _bf16(L, b, kh, s, 32), _bf16(b, kh, 32)
        v_all, v_new = k_all, k_new
    elif case == "group_3":
        q, wo = _bf16(b, 6, d), (_i8 if q8 else _bf16)(L, 6 * d, dm)
    elif case == "kv_heads_16":
        q, wo = _bf16(b, 16, d), (_i8 if q8 else _bf16)(L, 16 * d, dm)
        k_all = v_all = _bf16(L, b, 16, s, d)
        k_new = v_new = _bf16(b, 16, d)
    elif case == "layer_past_end":
        layer = L
    elif case == "k_new_shape":
        k_new = _bf16(b, kh + 1, d)
    elif case == "write_pos_int64":
        wpos = wpos.long()
    elif case == "dm_past_4096":
        x = _bf16(b, 4096 + 16)
        wo = (_i8 if q8 else _bf16)(L, h * d, 4096 + 16)
        wo_scale = _f32(L, 1, 4096 + 16) if q8 else None

    def run():
        tmk.check_attention_wo(q, k_all, v_all, k_new, v_new, wo, x, layer, plens, wpos,
                               wo_scale)

    if error is None:
        run()
    else:
        with pytest.raises(error):
            run()
