"""The int8 inference path of the PyTorch port against the JAX package's
(`models/quantize.py`, the q8 layer matmuls, the int8 KV cache) at
gar_tiny, on the CPU: the port's plain versions against the Pallas kernels
in interpret mode.

Tolerances: the quantized values and scales are computed by the same fp32
operations in both frameworks, so they are bit-equal. A q8 matmul is held
to 1e-5 of its output range: the Pallas kernels scale the weight before the
fp32 sum and the port scales the sum after it. Prefill and a decode step in
fp32 are held to 1e-4 (of the range for a step), as the bf16 path's tests
hold them (sums in another order, compounded over layers). An appended
int8 cache column may differ by one step of the scale: the new K/V are
rounded to bf16 and quantized, and fp32 noise can move a value across a
rounding boundary.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params
from grasp_any_region_tpu.models import quantize as jq
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import load_flat_params
from grasp_any_region_tpu_torch.models import quantize as tq
from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm

F32 = torch.float32
TOWER = dict(rtol=1e-4, atol=1e-4)
L, LAYER, DIN = 3, 1, 96


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: decode steps write in place


def _no_launches():
    return not any(tlm.launches.values()) and tdec.launches == 0 and tdec.launches_q8 == 0


def _cfgs(tie=True):
    def make(mod):
        cfg = mod.gar_tiny()
        return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                 tie_word_embeddings=tie))
    return make(jcfg), make(tcfg)


def _jax_params(cfg_j, scale_decoder=10.0):
    """JAX gar_tiny params with a random mask_embed and the decoder
    projections scaled up, so greedy decoding does not repeat one token
    (as tests/test_torch_model.py builds them)."""
    from grasp_any_region_tpu.models import init_gar_params

    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in jq.DECODE_MATMULS:
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * scale_decoder
    return params


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _tree(params):
    return {n.replace(".", "/"): p.detach() for n, p in params.named_parameters()}


# ------------------------------------------------------------- (a) quantize


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_int8_matches_jax(rng, axis):
    """Values and scales bit-equal, ties rounded half to even, |q| <= 127."""
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    ties = np.array([127.0, 63.5, -0.5, 0.5, 1.5, 2.5, -2.5, 126.5], np.float32)
    if axis == -2:
        w[1, :8, 0] = ties  # one column whose scale is exactly 1
        w[1, 8:, 0] = 0.0
    else:
        w[1, 0, :8] = ties
        w[1, 0, 8:] = 0.0
    q_ref, s_ref = jq.quantize_int8(jnp.asarray(w), axis=axis)
    q, s = tq.quantize_int8(_t(w), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == F32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert q.abs().max() <= 127
    np.testing.assert_array_equal(tq.dequantize(q, s, F32).numpy(),
                                  np.asarray(jq.dequantize(q_ref, s_ref, jnp.float32)))


@pytest.mark.parametrize("drop_bf16", [False, True], ids=["dual", "serving"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_quantize_decode_weights_matches_jax(tie, drop_bf16):
    """The port's quantize_decode_weights on the loaded bf16 tree, and the
    loader on JAX's quantized tree, both give JAX's tree: the same names,
    shapes and dtypes, int8 values and scales bit-equal, the input tree
    untouched."""
    cfg_j, cfg_t = _cfgs(tie)
    params = _jax_params(cfg_j, scale_decoder=1.0)
    ref = flatten_params(jq.quantize_decode_weights(params, drop_bf16=drop_bf16))
    base = load_flat_params(flatten_params(params), cfg_t, device="cpu")
    ported = _tree(tq.quantize_decode_weights(base, drop_bf16=drop_bf16))
    loaded = _tree(load_flat_params(ref, cfg_t, device="cpu", dtype=torch.bfloat16))
    assert set(ported) == set(loaded) == set(ref)
    for key, arr in ref.items():
        assert tuple(ported[key].shape) == tuple(loaded[key].shape) == arr.shape, key
        assert _dtype_name(ported[key]) == str(arr.dtype), key  # fp32 and int8 leaves
        np.testing.assert_array_equal(ported[key].numpy(), arr, err_msg=key)
        if key.startswith("llm/") and ("_q8" in key or key.endswith("_scale")):
            # int8 and fp32 whatever the load dtype
            assert _dtype_name(loaded[key]) == str(arr.dtype), key
            np.testing.assert_array_equal(loaded[key].numpy(), arr, err_msg=key)
    assert "wq" in base.llm.blocks._parameters and hasattr(base.llm, "embed" if tie else "lm_head")
    assert not hasattr(base.llm, "lm_head_q8")


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_init_gar_serving_int8_tree_matches_jax(tie):
    """init_gar_serving_int8 builds JAX's serving-only tree: the same names,
    shapes and dtypes (the numbers come from a torch generator), with int8
    values in [-127, 127]; the loader takes JAX's such tree too."""
    cfg_j, cfg_t = _cfgs(tie)
    ref = flatten_params(jq.init_gar_serving_int8(jax.random.PRNGKey(0), cfg_j))
    got = _tree(tq.init_gar_serving_int8(cfg_t, torch.Generator().manual_seed(0), device="cpu"))
    assert set(got) == set(ref)
    for key, arr in ref.items():
        assert tuple(got[key].shape) == arr.shape, key
        assert _dtype_name(got[key]) == str(arr.dtype), key
        if got[key].dtype == torch.int8:
            assert got[key].abs().max() <= 127 and got[key].float().std() > 50, key
    loaded = load_flat_params(ref, cfg_t, device="cpu", dtype=torch.bfloat16)
    assert {k: _dtype_name(v) for k, v in _tree(loaded).items()} == \
        {k: str(a.dtype) for k, a in ref.items()}


# ------------------------------------------------------------- (b) H8, I8, J8


def _q8_case(rng, op, b):
    """(JAX function, port plain version, port wrapper, arrays) of one op:
    int8 weights in [-127, 127] and positive fp32 column scales."""
    from grasp_any_region_tpu.ops import layer_matmul as jlm

    def w(n):
        q = rng.integers(-127, 128, (L, DIN, n)).astype(np.int8)
        s = (rng.uniform(0.5, 1.5, (L, 1, n)) * DIN ** -0.5 / 73.3).astype(np.float32)
        return q, s

    x = rng.standard_normal((b, DIN)).astype(np.float32)
    if op == "matmul":
        return jlm.layer_matmul_q8, tlm.layer_matmul_q8_plain, tlm.layer_matmul_q8, (x, *w(128))
    if op == "swiglu":
        return (jlm.layer_swiglu_q8, tlm.layer_swiglu_q8_plain, tlm.layer_swiglu_q8,
                (x, *w(256), *w(256)))
    return (jlm.layer_qkv_q8, tlm.layer_qkv_q8_plain, tlm.layer_qkv_q8,
            (x, *w(128), *w(32), *w(32)))


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", ["matmul", "swiglu", "qkv"])
def test_layer_q8_kernel_matches_pallas(rng, op, b, fn):
    jax_fn, plain, wrapper, arrays = _q8_case(rng, op, b)
    ref = jax_fn(*map(jnp.asarray, arrays), jnp.asarray(LAYER, jnp.int32), interpret=True)
    out = (plain if fn == "plain" else wrapper)(*map(_t, arrays), LAYER)
    refs, outs = (ref, out) if op == "qkv" else ((ref,), (out,))
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        assert o.dtype == F32 and o.shape == r.shape
        span = np.abs(r).max()
        np.testing.assert_allclose(o.numpy() / span, r / span, rtol=1e-5, atol=1e-5)
    assert _no_launches()  # a CPU tensor never launches a kernel


@pytest.mark.parametrize("case,error", [
    ("fits", None),
    ("w_bf16", TypeError),
    ("scale_bf16", TypeError),
    ("scale_per_layer", ValueError),
    ("dout_not_multiple_of_16", ValueError),
    ("layer_past_end", IndexError),
])
def test_layer_q8_operand_check(case, error):
    """The int8 wrappers' check before a launch: int8 weights with rows of
    whole 16-byte chunks, fp32 (L, 1, Dout) scales."""
    x = torch.zeros((3, 64), dtype=torch.bfloat16)
    w, s, layer = torch.zeros((L, 64, 128), dtype=torch.int8), torch.ones((L, 1, 128)), LAYER
    if case == "w_bf16":
        w = w.to(torch.bfloat16)
    elif case == "scale_bf16":
        s = s.to(torch.bfloat16)
    elif case == "scale_per_layer":
        s = torch.ones((L, 1, 1))
    elif case == "dout_not_multiple_of_16":
        w, s = torch.zeros((L, 64, 40), dtype=torch.int8), torch.ones((L, 1, 40))
    elif case == "layer_past_end":
        layer = L
    if error is None:
        tlm._check_q8(x, layer, (w, s), (w, s))
    else:
        with pytest.raises(error):
            tlm._check_q8(x, layer, (w, s))


# ------------------------------------------------------------- (c) the int8 cache


def _unpair(paired, kh):
    """JAX's paired (L, B, K/2, S, 2D) cache -> the port's (L, B, K, S, D)."""
    a = np.asarray(paired)
    n, b, kp, s, d2 = a.shape
    return a.reshape(n, b, kp, s, 2, d2 // 2).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, kh, s, d2 // 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_seed_int8_cache_matches_jax(rng, dtype):
    """Scales bit-equal, and the int8 cache bit-equal to JAX's paired one
    unpaired: one amax per (layer, batch row, kv pair) over both heads and
    every column, the right-pad garbage of short rows and the zero tail
    included, after the cast to the cache dtype."""
    from grasp_any_region_tpu.models.gar import seed_cache_from_prefill as jseed
    from grasp_any_region_tpu_torch.models.gar import seed_cache_from_prefill as tseed

    n, b, s, kh, d, max_len = 2, 3, 40, 4, 16, 64
    kv = [rng.standard_normal((n, b, s, kh, d)).astype(np.float32) for _ in range(2)]
    kv[0][1, 2, :, 2:] *= 9.0  # one pair of one row and layer runs hot
    kv[1][:, :, 30:] *= 5.0  # pad columns of the short rows count toward amax
    plens = np.array([40, 17, 29], np.int32)
    ref = jseed(jcfg.gar_tiny(), tuple(map(jnp.asarray, kv)), jnp.asarray(plens), max_len,
                dtype=getattr(jnp, dtype), paired=True, quantize_kv=True)
    out = tseed(tcfg.gar_tiny(), tuple(map(_t, kv)), _t(plens), max_len,
                dtype=getattr(torch, dtype), quantize_kv=True)
    assert out.k.dtype == torch.int8 and out.k.shape == (n, b, kh, max_len, d)
    for got, want in ((out.k, ref.k), (out.v, ref.v)):
        np.testing.assert_array_equal(got.numpy(), _unpair(want, kh))
    for got, want in ((out.k_scale, ref.k_scale), (out.v_scale, ref.v_scale)):
        assert got.shape == (n, b, kh // 2, 1, 1) and got.dtype == F32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(out.write_pos) == s and out.prompt_lens.tolist() == plens.tolist()


def test_seed_int8_cache_needs_kv_pairs(rng):
    from grasp_any_region_tpu_torch.models.gar import seed_cache_from_prefill as tseed

    kv = tuple(torch.zeros((1, 1, 8, 3, 16)) for _ in range(2))
    with pytest.raises(ValueError, match="odd"):
        tseed(tcfg.gar_tiny(), kv, torch.tensor([8]), 16, quantize_kv=True)


# ------------------------------------------------------------- (d) decode steps


def _pair(a):
    """The port's (L, B, K, S, D) cache -> JAX's paired (L, B, K/2, S, 2D)."""
    n, b, kh, s, d = a.shape
    return a.reshape(n, b, kh // 2, 2, s, d).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, kh // 2, s, 2 * d)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_q8_matches_pallas(rng, dtype, group):
    """Kernel C8's plain version against JAX `decode_attention_fused` on the
    paired int8 cache (`_fused_kernel_paired`, interpret mode): the output
    within 1e-5 of its range, the whole cache bit-equal after the append
    (the same bf16 K/V quantized by the same fp32 operations), with ragged
    prompt lengths, 2 kv-head pairs and per-(layer, row, pair) scales."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_fused as jdec

    n, b, kh, s, d, layer, pad, wpos = 2, 3, 4, 64, 16, 1, 32, 37
    kq, vq = (rng.integers(-127, 128, (n, b, kh, s, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.03, (n, b, kh // 2, 1, 1)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, kh * group, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, kh, d)).astype(np.float32) for _ in range(2))
    plens = np.array([32, 17, 9], np.int32)
    out_ref, k_ref, v_ref = jdec(
        jnp.asarray(q, dtype), jnp.asarray(_pair(kq)), jnp.asarray(_pair(vq)),
        jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jnp.asarray(layer, jnp.int32), prompt_lens=jnp.asarray(plens),
        write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    k_all, v_all = _t(kq), _t(vq)
    out = tdec.decode_attention_fused(
        _t(q).to(getattr(torch, dtype)), k_all, v_all, _t(kn).to(torch.bfloat16),
        _t(vn).to(torch.bfloat16), layer, prompt_lens=_t(plens),
        write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=pad,
        k_scale=_t(ks), v_scale=_t(vs))
    ref = np.asarray(out_ref, np.float32)
    span = np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy() / span, ref / span, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(k_all.numpy(), _unpair(k_ref, kh))
    np.testing.assert_array_equal(v_all.numpy(), _unpair(v_ref, kh))
    assert (k_all[layer, :, :, wpos] != torch.from_numpy(kq[layer, :, :, wpos])).any()
    assert _no_launches()


def _llm_pair(rng, cfg_j, cfg_t, b):
    """gar_tiny decoder params quantized by JAX (dual tree) and the same
    tree in the port; random prefill K/V seeded into JAX's paired int8
    cache and into the port's."""
    from grasp_any_region_tpu.models.gar import seed_cache_from_prefill as jseed
    from grasp_any_region_tpu_torch.models.gar import seed_cache_from_prefill as tseed
    from grasp_any_region_tpu_torch.models.llama import LlamaParams

    t = cfg_t.text
    d, m, n = t.hidden_size, t.intermediate_size, t.num_layers
    qd, kd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    shapes = dict(wq=(n, d, qd), wk=(n, d, kd), wv=(n, d, kd), wo=(n, qd, d),
                  w_gate=(n, d, m), w_up=(n, d, m), w_down=(n, m, d))
    blocks = {k: (rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
              for k, s in shapes.items()}
    for name in ("attn_norm", "mlp_norm"):
        blocks[name] = (1.0 + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    llm = {"blocks": {k: jnp.asarray(v) for k, v in blocks.items()},
           "embed": jnp.asarray(rng.standard_normal((8, d)).astype(np.float32)),
           "final_norm": jnp.ones((d,), jnp.float32)}
    jparams = jq.quantize_decode_weights({"llm": llm})["llm"]
    flat = flatten_params(jparams)
    tparams = LlamaParams(t, vocab_rows=8, dtype=F32, q8=jq.DECODE_MATMULS)
    with torch.no_grad():
        for name, p in tparams.named_parameters():
            p.copy_(_t(flat[name.replace(".", "/")]))

    s, max_len = 32, 64
    plens = np.array([32, 17, 9][:b], np.int32)
    kv = [rng.standard_normal((n, b, s, t.num_kv_heads, t.head_dim)).astype(np.float32)
          for _ in range(2)]
    jcache = jseed(cfg_j, tuple(map(jnp.asarray, kv)), jnp.asarray(plens), max_len,
                   paired=True, quantize_kv=True)
    tcache = tseed(cfg_t, tuple(map(_t, kv)), _t(plens), max_len, quantize_kv=True)
    return jparams, tparams, jcache, tcache, s


@pytest.mark.parametrize("cache", ["int8", "fp32"])
def test_int8_decode_steps_match_jax(rng, cache):
    """Three fused decode steps with int8 weights (J8, C8 or C, H8, I8, H8)
    against JAX `llama_decode_step` in fp32. With the int8 cache JAX routes
    its paired cache to `llama_decode_step_fused` in interpret mode, and the
    port its int8 cache to its fused form on the CPU; with an fp32 cache
    both run the fused form with kernel C.

    Every cache entry but the appended columns stays equal, and those are
    within one quantization step: the new K/V are rounded to bf16 and to
    int8 from fp32 values that differ by fp32 noise between the frameworks,
    so an entry can land on the other side of a rounding boundary (a flip).
    A flipped V entry moves the hidden by up to about p * scale (3e-4 of
    its range here), so the hidden is held to 1e-4 of its range in a step
    without a flip and to 5e-3 in one with. After each step the port's
    appended columns take JAX's values, so each step starts from the same
    cache."""
    from grasp_any_region_tpu.models import llama as jl
    from grasp_any_region_tpu.models.llama import KVCache as JCache
    from grasp_any_region_tpu_torch.models import llama as tl
    from grasp_any_region_tpu_torch.models.llama import KVCache

    cfg_j, cfg_t = _cfgs()
    kh = cfg_t.text.num_kv_heads
    jparams, tparams, jcache, tcache, pad = _llm_pair(rng, cfg_j, cfg_t, b=3)
    if cache == "fp32":  # the same (dequantized) values in an fp32 cache on both sides
        deq = [(c.float() * s.repeat_interleave(2, dim=2)).numpy()
               for c, s in ((tcache.k, tcache.k_scale), (tcache.v, tcache.v_scale))]
        jcache = JCache(k=jnp.asarray(deq[0]), v=jnp.asarray(deq[1]),
                        prompt_lens=jcache.prompt_lens, write_pos=jcache.write_pos)
        tcache = KVCache(k=_t(deq[0]), v=_t(deq[1]), prompt_lens=tcache.prompt_lens,
                         write_pos=tcache.write_pos)
    start = tcache.k.clone()
    for step in range(3):
        col = pad + step
        emb = rng.standard_normal((3, 1, cfg_t.text.hidden_size)).astype(np.float32)
        h_ref, jcache = jl.llama_decode_step(jparams, cfg_j.text, jnp.asarray(emb), jcache, pad,
                                             use_kernel="fused")
        h, out = tl.llama_decode_step(tparams, cfg_t.text, _t(emb), tcache, pad,
                                      use_kernel=False if cache == "int8" else "fused")
        assert out is tcache
        assert int(tcache.write_pos) == int(jcache.write_pos) == col + 1
        refs = ((jcache.k, jcache.v) if cache == "fp32" else
                (_unpair(jcache.k, kh), _unpair(jcache.v, kh)))
        flips = 0
        for got, want in zip((tcache.k, tcache.v), refs):
            want = np.asarray(want)
            if cache == "int8":
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(np.delete(got.numpy(), col, axis=3),
                                              np.delete(want, col, axis=3))
                gap = np.abs(got[:, :, :, col].numpy().astype(int) - want[:, :, :, col])
                assert gap.max() <= 1 and (want[:, :, :, col] != 0).any()
                flips += int(np.count_nonzero(gap))
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
            got[:, :, :, col] = torch.from_numpy(want[:, :, :, col].copy())
        h_ref = np.asarray(h_ref)
        rel = np.abs(h.numpy() - h_ref).max() / np.abs(h_ref).max()
        tol = 1e-4 if flips == 0 else 5e-3
        assert flips <= 2 and rel <= tol, f"step {step}: {flips} flips, hidden {rel:.2e}"
    assert not torch.equal(tcache.k, start)
    assert _no_launches()


# ------------------------------------------------------------- (e) generate


def _ragged(batch, prompt_lens, short):
    """Shorten row 1 of a synthetic batch by `short` tokens (right padding)."""
    ids, seg, pos = (np.array(x) for x in (batch.input_ids, batch.segment_ids,
                                            batch.positions))
    lens = np.array(prompt_lens)
    n = lens[1] - short
    ids[1, n:], seg[1, n:], pos[1, n:] = 0, 0, n - 1
    lens[1] = n
    return dict(input_ids=ids, segment_ids=seg, positions=pos), lens


def test_int8_generate_greedy_tokens_match_jax():
    """Greedy `generate` with int8 decode weights and an int8 cache, token
    for token and num_generated equal, on a batch of 2 with different
    prompt lengths and a forced eot in one row. JAX runs at fp32 (its
    compute dtype patched as in tests/test_torch_model.py) and seeds its
    paired int8 cache off the TPU (`paired_cache_wanted` patched to True)."""
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb
    from grasp_any_region_tpu_torch.models.generate import generate as tgen

    cfg_j, cfg_t = _cfgs()
    params = _jax_params(cfg_j)
    jparams = jq.quantize_decode_weights(params)
    tparams = tq.quantize_decode_weights(load_flat_params(flatten_params(params), cfg_t,
                                                          device="cpu"))
    jb, _, jlens = jsb(cfg_j, batch=2, grid=(2, 1), seed=0)
    tb, _, _ = tsb(cfg_t, batch=2, grid=(2, 1), seed=0, device="cpu")
    fields, lens = _ragged(jb, jlens, 12)
    jb = jb._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tb._replace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    n_new = 10
    kw = dict(max_new_tokens=n_new, compute_dtype=F32, quantize_kv=True)
    free = tgen(tparams, cfg_t, tb, torch.from_numpy(lens), eot_id=-1, **kw).tokens.numpy()
    eot = next(int(t) for t in free[1, 2:] if t not in free[0])

    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    patched = {
        "gar_prefill": functools.partial(jg.gar_prefill, compute_dtype=jnp.float32),
        "gar_decode_step": functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32),
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in patched.items():
            mp.setattr(jmod, name, fn)
        mp.setattr("grasp_any_region_tpu.models.llama.paired_cache_wanted", lambda cfg: True)
        jgen = jax.jit(jmod.generate.__wrapped__,
                       static_argnames=("cfg", "max_new_tokens", "eot_id", "quantize_kv"))
        ref = jgen(jparams, cfg_j, jb, jnp.asarray(lens), max_new_tokens=n_new, eot_id=eot,
                   quantize_kv=True)
    out = tgen(tparams, cfg_t, tb, torch.from_numpy(lens), eot_id=eot, **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.num_generated.numpy(), np.asarray(ref.num_generated))
    assert out.num_generated[0] == n_new and out.num_generated[1] < n_new
    assert _no_launches()


# ------------------------------------------------------------- (f) serving-only prefill


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_serving_only_prefill_matches_jax(rng, tie):
    """serving_weights: prefill projects through the int8 leaves (`_proj`),
    the tied tree gathers its embeddings from the int8 head, and the logits
    come from the int8 head, all against JAX's in fp32."""
    from grasp_any_region_tpu.models import llama as jl
    from grasp_any_region_tpu_torch.models import llama as tl

    cfg_j, cfg_t = _cfgs(tie)
    params = _jax_params(cfg_j, scale_decoder=1.0)
    jsv = jq.serving_weights(params)["llm"]
    tsv = tq.serving_weights(load_flat_params(flatten_params(params), cfg_t, device="cpu")).llm
    assert ("embed" in jsv) == hasattr(tsv, "embed") == (not tie)
    ids = rng.integers(0, cfg_t.text.vocab_size, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    e_ref = jl.embed_tokens(jsv, jnp.asarray(ids), jnp.float32)
    e = tl.embed_tokens(tsv, _t(ids), F32)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-6, atol=1e-7)
    h_ref, (k_ref, v_ref) = jl.llama_prefill(jsv, cfg_j.text, e_ref, jnp.asarray(pos),
                                             use_flash=False)
    h, (k, v) = tl.llama_prefill(tsv, cfg_t.text, e, _t(pos))
    for got, want in ((h, h_ref), (k, k_ref), (v, v_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER)
    vocab = cfg_t.extended_vocab_size
    l_ref = np.asarray(jl.lm_logits(jsv, cfg_j.text, h_ref[:, -1], valid_vocab=vocab))
    logits = tl.lm_logits(tsv, cfg_t.text, h[:, -1], valid_vocab=vocab)
    span = np.abs(l_ref[:, :vocab]).max()
    np.testing.assert_allclose(logits[:, :vocab].numpy() / span, l_ref[:, :vocab] / span, **TOWER)
    np.testing.assert_array_equal(logits[:, vocab:].numpy(), l_ref[:, vocab:])


# ------------------------------------------------------------- (g) the loader


def test_load_flat_params_rejects_bad_int8_trees():
    cfg_j, cfg_t = _cfgs()
    flat = flatten_params(jq.quantize_decode_weights(_jax_params(cfg_j, scale_decoder=1.0)))
    missing = dict(flat)
    del missing["llm/blocks/wq_scale"]
    with pytest.raises(KeyError, match="wq_scale"):
        load_flat_params(missing, cfg_t, device="cpu")
    floats = dict(flat, **{"llm/blocks/wo_q8": flat["llm/blocks/wo_q8"].astype(np.float32)})
    with pytest.raises(TypeError, match="wo_q8"):
        load_flat_params(floats, cfg_t, device="cpu")
    extra = dict(flat, **{"llm/blocks/attn_norm_q8": np.zeros((2, 64), np.int8)})
    with pytest.raises(KeyError, match="attn_norm_q8"):
        load_flat_params(extra, cfg_t, device="cpu")


# ------------------------------------------------------------- entry points


def test_entry_points_default_to_the_card():
    """The factories build on the card unless asked for the CPU; without a
    card the default raises instead of falling back."""
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch

    cfg_j, cfg = _cfgs()
    flat = flatten_params(_jax_params(cfg_j, scale_decoder=1.0))
    card = torch.cuda.is_available()
    gen = torch.Generator(device="cuda" if card else "cpu")
    calls = {
        "load_flat_params": lambda: load_flat_params(flat, cfg).llm.embed,
        "init_gar_params": lambda: init_gar_params(cfg, gen).llm.embed,
        "init_gar_serving_int8": lambda: tq.init_gar_serving_int8(cfg, gen).llm.final_norm,
        "synthetic_batch": lambda: synthetic_batch(cfg)[0].input_ids,
    }
    for name, call in calls.items():
        if card:
            assert call().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
