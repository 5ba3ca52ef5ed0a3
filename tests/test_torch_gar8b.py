"""GAR-8B's path in the PyTorch port against the JAX package, on the CPU, at
a narrow config of GAR-8B's shape: the PE-G tower at head dim 96 (width
192, 2 heads, depth 2), the decoder at head dim 128 with GQA 4:1 (hidden
512, 4 query heads over 1 kv head, 2 layers, intermediate 1024), the
untied LM head and llama3 rope at factor 8 (or the tied head where a test
says so).

The kernels' plain versions at GAR-8B's head dims against the Pallas
kernels in interpret mode: A at 96 (`vit_attention`), B at 128
(`flash_attention`, causal, GQA 4:1, Sq not a multiple of 128) and C at 128
(`decode_attention_fused`, G = 4, the append at write_pos) and its split
mirror. Then the modules at the narrow config in fp32: the tower, the
prefill embeddings (projector, assembly, replay), the prefill, the fused
decode step (the port's J, C, H, I, H plain versions) against JAX's XLA
step, greedy `generate` token for token, the int8 untied head; and
`init_gar_serving_int8`'s layout at full gar_8b, built on the meta device
(no weights materialised) against `jax.eval_shape`. Last, the guards that
keep the card from running a head dim with no instance (C8, the mega
step, the backward kernels, A and B at 80), on CPU tensors.

Tolerances: 1e-5 of the output for the plain versions against the Pallas
kernels (fp32 sums in another order); 1e-4 for towers and steps in fp32,
as tests/test_torch_model.py holds gar_tiny (a few layers compound the
fp32 rounding); an int8 head's logits 1e-5 of their range.
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
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.ops import decode_attention as tdec
from grasp_any_region_tpu_torch.ops import flash_attention as tfa
from grasp_any_region_tpu_torch.ops import layer_matmul as tlm
from grasp_any_region_tpu_torch.ops import vit_attention as tva

F32 = torch.float32
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOWER = dict(rtol=1e-4, atol=1e-4)


def _narrow(mod, tie=False):
    """GAR-8B's shape at narrow widths (module docstring)."""
    cfg = mod.gar_8b()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, width=192, num_heads=2, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=512, num_heads=4, num_kv_heads=1,
                                 head_dim=128, num_layers=2, intermediate_size=1024,
                                 tie_word_embeddings=tie))


def _no_launches():
    return (tva.launches == 0 and tfa.launches == 0 and tdec.launches == 0
            and tdec.launches_q8 == 0 and not any(tlm.launches.values()))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOWER))


def test_narrow_config_keeps_gar8b_head_dims():
    """The narrow config is GAR-8B's in what the kernels see: head dims 96
    and 128, four query heads a kv head, the untied head, rope factor 8;
    and the full preset's PE-G MLP is 8960 wide (ratio 5.8333)."""
    for mod in (jcfg, tcfg):
        cfg = _narrow(mod)
        assert cfg.vision.head_dim == 96 and cfg.text.head_dim == 128
        assert cfg.text.q_per_kv == 4 and not cfg.text.tie_word_embeddings
        assert cfg.text.rope_scaling_factor == 8.0 and cfg.vision.fast_gelu
        full = mod.gar_8b()
        assert full.vision.mlp_hidden == 8960 and full.vision.head_dim == 96
        assert full.text.q_per_kv == 4 and full.max_num_tiles == 8
    assert dataclasses.asdict(_narrow(tcfg)) == dataclasses.asdict(_narrow(jcfg))


# ------------------------------------------------------------- the kernels' plain versions


@pytest.mark.parametrize("t,s,h", [(2, 129, 2), (1, 333, 3)])
def test_vit_attention_plain_d96_matches_pallas(t, s, h):
    """Kernel A's plain version at head dim 96 against JAX `vit_attention`
    in interpret mode, output and LSE, at a one-row last query tile (129)
    and a ragged S; views of one qkv buffer, as the unfused block passes them."""
    from grasp_any_region_tpu.ops.vit_attention import vit_attention as jva

    qkv = np.random.default_rng(s).standard_normal((t, s, 3, h, 96)).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))
    ref, ref_lse = jva(*(jnp.asarray(x) for x in (q, k, v)), return_lse=True, interpret=True)
    buf = torch.from_numpy(qkv)
    out, lse = tva.vit_attention(buf[:, :, 0], buf[:, :, 1], buf[:, :, 2], return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **KERNEL_TOL)
    assert _no_launches()


@pytest.mark.parametrize("b,sq,sk,causal", [(1, 200, 200, True), (2, 100, 333, True),
                                            (1, 200, 333, False)])
def test_flash_attention_plain_d128_matches_pallas(b, sq, sk, causal):
    """Kernel B's plain version at head dim 128, GQA 4:1 (8 query heads
    over 2 kv heads), Sq not a multiple of 128, causal (right-aligned when
    Sq < Sk) and full, against JAX `flash_attention` in interpret mode,
    output and LSE."""
    from grasp_any_region_tpu.ops.flash_attention import flash_attention as jfa

    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, sq, 8, 128)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, 2, 128)).astype(np.float32) for _ in range(2))
    ref, ref_lse = jfa(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, return_lse=True,
                       interpret=True)
    out, lse = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                   return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **KERNEL_TOL)
    assert _no_launches()


@pytest.mark.parametrize("splits", [1, 8])
def test_decode_attention_plain_d128_matches_pallas(splits):
    """Kernel C's plain version and its split mirror at head dim 128 and G
    = 4 against JAX `decode_attention_fused` in interpret mode (as
    tests/test_torch_decode_split.py holds them at 64): two rows of
    different prompt lengths, the append at write_pos; the cache after it
    bit-equal to JAX's."""
    from grasp_any_region_tpu.ops.decode_attention import decode_attention_fused as jdec

    rng = np.random.default_rng(splits)
    n, b, kh, g, s, layer, d = 2, 2, 2, 4, 256, 1, 128
    plens, pad, wpos = (100, 37), 128, 170
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    k_all, v_all = (rng.standard_normal((n, b, kh, s, d)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, kh, d)).astype(np.float32) for _ in range(2))
    ref, k_ref, v_ref = jdec(*(jnp.asarray(x) for x in (q, k_all, v_all, k_new, v_new)),
                             jnp.asarray(layer, jnp.int32),
                             prompt_lens=jnp.asarray(plens, jnp.int32),
                             write_pos=jnp.asarray(wpos, jnp.int32), prompt_pad=pad, block_s=128,
                             interpret=True)
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32),
              write_pos=torch.tensor(wpos, dtype=torch.int32), prompt_pad=pad)
    for fn in (tdec.decode_attention_fused,
               functools.partial(tdec.decode_attention_fused_split_plain, splits=splits)):
        kc, vc = torch.from_numpy(k_all.copy()), torch.from_numpy(v_all.copy())
        out = fn(torch.from_numpy(q), kc, vc, torch.from_numpy(k_new), torch.from_numpy(v_new),
                 layer, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(k_ref))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(v_ref))
    assert _no_launches()


# ------------------------------------------------------------- the modules at the narrow config


@pytest.fixture(scope="module")
def pairs():
    """`_pair(tie)` built once a module run and freed after it."""
    built = {}

    def get(tie: bool):
        if tie not in built:
            built[tie] = _pair(tie)
        return built[tie]

    yield get
    built.clear()


def _pair(tie: bool):
    """JAX params of the narrow config (a random mask_embed, the decoder's
    projections scaled by 3 so greedy decoding does not repeat one token),
    the same tree in the port, and one synthetic batch of 2 rows, row 1
    shortened by 12 tokens (right padding)."""
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    cfg_j, cfg_t = _narrow(jcfg, tie), _narrow(tcfg, tie)
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 3.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")
    jb, _, jlens = jsb(cfg_j, batch=2, grid=(2, 1), seed=0)
    tb, _, _ = tsb(cfg_t, batch=2, grid=(2, 1), seed=0, device="cpu")
    ids, seg, pos = (np.array(x) for x in (jb.input_ids, jb.segment_ids, jb.positions))
    lens = np.array(jlens)
    n = lens[1] - 12
    ids[1, n:], seg[1, n:], pos[1, n:] = 0, 0, n - 1
    lens[1] = n
    fields = dict(input_ids=ids, segment_ids=seg, positions=pos)
    jb = jb._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tb._replace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, tparams=tparams, jb=jb, tb=tb,
                jlens=jnp.asarray(lens), tlens=torch.from_numpy(lens))


def test_vision_tower_at_head_dim_96(pairs):
    """The unfused PE-G block (the form GAR-8B's tower takes: head dim 96)
    and the whole tower against JAX's in fp32, on the mask embeds of one
    sample's tiles."""
    from grasp_any_region_tpu.models import gar as jg, vision as jv
    from grasp_any_region_tpu_torch.models import gar as tg, vision as tv

    p = pairs(False)
    cfg_j, cfg_t = p["cfg_j"], p["cfg_t"]
    me_j = jg.mask_patch_embed(p["params"], cfg_j,
                               jg.decode_mask_values(cfg_j, p["jb"].mask_values[0], compat=True))
    me_t = tg.mask_patch_embed(p["tparams"], cfg_t,
                               tg.decode_mask_values(cfg_t, p["tb"].mask_values[0], compat=True))
    _close(me_t, me_j, rtol=1e-5, atol=1e-5)
    vp_j, vp_t = p["params"]["vision"], p["tparams"].vision
    x_j, ang_j = jv.vision_embed(vp_j, cfg_j.vision, p["jb"].pixel_values[0], me_j,
                                 compute_dtype=jnp.float32)
    x_t, ang_t = tv.vision_embed(vp_t, cfg_t.vision, p["tb"].pixel_values[0], me_t,
                                 compute_dtype=F32)
    bp_j = jax.tree_util.tree_map(lambda a: a[0], vp_j["blocks"])
    _close(tv._block(cfg_t.vision, x_t, vp_t.blocks.layer(0), ang_t[0]),
           jv._block(cfg_j.vision, x_j, bp_j, ang_j[0], use_flash=False))
    ref = jv.vision_forward(vp_j, cfg_j.vision, p["jb"].pixel_values[0], me_j,
                            compute_dtype=jnp.float32)
    out = tv.vision_forward(vp_t, cfg_t.vision, p["tb"].pixel_values[0], me_t,
                            compute_dtype=F32)
    _close(out, ref)
    assert _no_launches()


def test_build_prefill_embeds(pairs):
    """The projector (192 -> 512, GAR-8B's 1536 -> 4096 at narrow widths),
    the image-feature scatter and the region replay, against JAX's in fp32."""
    from grasp_any_region_tpu.models.gar import build_prefill_embeds as jbuild
    from grasp_any_region_tpu_torch.models.gar import build_prefill_embeds as tbuild

    p = pairs(False)
    ref = jbuild(p["params"], p["cfg_j"], p["jb"], compute_dtype=jnp.float32)
    out = tbuild(p["tparams"], p["cfg_t"], p["tb"], compute_dtype=F32)
    _close(out, ref)


def test_llama_prefill_and_fused_decode_step(pairs):
    """The prefill at head dim 128 with llama3 rope at factor 8 (hidden and
    the per-layer K/V) against JAX's; then three steps of the port's fused
    decode step (the plain versions of J, C, H, I, H on the CPU) against
    JAX's XLA step from the same seeded cache, hidden and cache, in fp32."""
    from grasp_any_region_tpu.models import gar as jg, llama as jl
    from grasp_any_region_tpu_torch.models import gar as tg, llama as tl

    p = pairs(False)
    cfg_j, cfg_t = p["cfg_j"], p["cfg_t"]
    embeds = jg.build_prefill_embeds(p["params"], cfg_j, p["jb"], compute_dtype=jnp.float32)
    h_j, kv_j = jl.llama_prefill(p["params"]["llm"], cfg_j.text, embeds, p["jb"].positions,
                                 segment_ids=p["jb"].segment_ids)
    h_t, kv_t = tl.llama_prefill(p["tparams"].llm, cfg_t.text, torch.from_numpy(np.array(embeds)),
                                 p["tb"].positions, segment_ids=p["tb"].segment_ids)
    _close(h_t, h_j)
    _close(kv_t[0], kv_j[0])
    _close(kv_t[1], kv_j[1])

    s = embeds.shape[1]
    max_len = (s // 512 + 1) * 512
    cache_j = jg.seed_cache_from_prefill(cfg_j, kv_j, p["jlens"], max_len, dtype=jnp.float32)
    cache_t = tg.seed_cache_from_prefill(cfg_t, kv_t, p["tlens"], max_len, dtype=F32)
    rng = np.random.default_rng(3)
    for step in range(3):
        emb = rng.standard_normal((2, 1, cfg_t.text.hidden_size)).astype(np.float32)
        h_ref, cache_j = jl.llama_decode_step(p["params"]["llm"], cfg_j.text, jnp.asarray(emb),
                                              cache_j, s, use_kernel=False)
        h, cache_t = tl.llama_decode_step(p["tparams"].llm, cfg_t.text, torch.from_numpy(emb),
                                          cache_t, s, use_kernel="fused")
        h_ref = np.asarray(h_ref)
        span = np.abs(h_ref).max()
        _close(h / span, h_ref / span)
        _close(cache_t.k, cache_j.k)
        _close(cache_t.v, cache_j.v)
        assert int(cache_t.write_pos) == int(cache_j.write_pos) == s + step + 1
    assert _no_launches()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_generate_greedy_tokens_match_jax(pairs, tie):
    """Greedy `generate` token for token and num_generated equal, at fp32,
    on 2 rows of different prompt lengths with a forced eot in one row; JAX
    at fp32 by patching its compute dtype, as tests/test_torch_model.py
    does."""
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.models.generate import generate as tgen

    p = pairs(tie)
    n_new = 10
    free = tgen(p["tparams"], p["cfg_t"], p["tb"], p["tlens"], max_new_tokens=n_new, eot_id=-1,
                compute_dtype=F32).tokens.numpy()
    eot = next(int(t) for t in free[1, 2:] if t not in free[0])
    jmod = sys.modules["grasp_any_region_tpu.models.generate"]
    patched = {
        "gar_prefill": functools.partial(jg.gar_prefill, compute_dtype=jnp.float32),
        "gar_decode_step": functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32),
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in patched.items():
            mp.setattr(jmod, name, fn)
        jgen = jax.jit(jmod.generate.__wrapped__,
                       static_argnames=("cfg", "max_new_tokens", "eot_id"))
        ref = jgen(p["params"], p["cfg_j"], p["jb"], p["jlens"], max_new_tokens=n_new,
                   eot_id=eot)
    out = tgen(p["tparams"], p["cfg_t"], p["tb"], p["tlens"], max_new_tokens=n_new, eot_id=eot,
               compute_dtype=F32)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.num_generated.numpy(), np.asarray(ref.num_generated))
    assert out.num_generated[0] == n_new and out.num_generated[1] < n_new
    assert len(set(free[0].tolist())) > 2  # not one token repeated
    assert _no_launches()


def test_int8_untied_head_matches_jax(pairs):
    """`quantize_decode_weights` on the untied head ((D, V) int8, one scale
    per vocab column) and `lm_logits` through it, against JAX's, the int8
    values and scales bit-equal and the logits within 1e-5 of their range."""
    from grasp_any_region_tpu.models import llama as jl, quantize as jq
    from grasp_any_region_tpu_torch.models import llama as tl, quantize as tq

    p = pairs(False)
    jparams = jq.quantize_decode_weights(p["params"])
    tparams = tq.quantize_decode_weights(p["tparams"])
    for name in ("lm_head_q8", "lm_head_scale"):
        np.testing.assert_array_equal(getattr(tparams.llm, name).detach().numpy(),
                                      np.asarray(jparams["llm"][name]), err_msg=name)
    assert tuple(tparams.llm.lm_head_scale.shape) == (1, p["cfg_t"].padded_vocab_size)
    x = np.random.default_rng(4).standard_normal((3, 512)).astype(np.float32)
    valid = p["cfg_t"].extended_vocab_size
    ref = np.asarray(jl.lm_logits(jparams["llm"], p["cfg_j"].text, jnp.asarray(x),
                                  valid_vocab=valid))
    got = tl.lm_logits(tparams.llm, p["cfg_t"].text, torch.from_numpy(x),
                       valid_vocab=valid).numpy()
    span = np.abs(ref[:, :valid]).max()
    np.testing.assert_allclose(got[:, :valid] / span, ref[:, :valid] / span, **KERNEL_TOL)
    assert (got[:, valid:] == ref[:, valid:]).all()


def test_init_gar_serving_int8_layout_at_gar8b():
    """`init_gar_serving_int8` at the full gar_8b config: the names, shapes
    and dtypes of JAX's serving-only tree (`jax.eval_shape`, nothing
    materialised), the port's built on the meta device (9.8 B parameters,
    no memory)."""
    from grasp_any_region_tpu.models import quantize as jq
    from grasp_any_region_tpu_torch.models import quantize as tq

    cfg_j, cfg_t = jcfg.gar_8b(), tcfg.gar_8b()
    shapes = jax.eval_shape(lambda: jq.init_gar_serving_int8(jax.random.PRNGKey(0), cfg_j))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    params = tq.init_gar_serving_int8(cfg_t, torch.Generator().manual_seed(0), device="meta")
    got = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    assert set(got) == set(ref)
    for key, leaf in ref.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype).replace("torch.", "") == str(leaf.dtype), key
    assert got["llm/blocks/wq_q8"].shape == (32, 4096, 4096)
    assert got["llm/lm_head_q8"].shape == (4096, cfg_t.padded_vocab_size)
    assert got["llm/embed"].dtype == torch.bfloat16  # the untied head keeps a bf16 table


# ------------------------------------------------------------- guards and plans


def _bf16(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def _c_operands(d, int8=False):
    """Kernel C's (C8's) operands at head dim d on CPU tensors: 2 layers, B =
    1, 2 kv heads of 4 query heads each, 64 columns."""
    cache = torch.int8 if int8 else torch.bfloat16
    k_all = torch.zeros((2, 1, 2, 64, d), dtype=cache)
    scale = torch.ones((2, 1, 1, 1, 1)) if int8 else None
    return (_bf16(1, 8, d), k_all, k_all.clone(), _bf16(1, 2, d), _bf16(1, 2, d), 0,
            torch.tensor([3], dtype=torch.int32), torch.tensor(9, dtype=torch.int32),
            scale, scale)


def _mega_qkv(d):
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk

    x, norm = _bf16(1, 512), _bf16(2, 512)
    w = (_bf16(2, 512, 512), _bf16(2, 512, d), _bf16(2, 512, d))
    tables = (torch.zeros(1, d),) * 4
    mk.check_qkv_norm_rope(x, norm, w, None, tables, 0, d)


def _mega_attn_wo(d):
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk

    k_all = _bf16(2, 1, 1, 64, d)
    mk.check_attention_wo(_bf16(1, 4, d), k_all, k_all.clone(), _bf16(1, 1, d), _bf16(1, 1, d),
                          _bf16(2, 4 * d, 512), _bf16(1, 512), 0,
                          torch.tensor([3], dtype=torch.int32), torch.tensor(9, dtype=torch.int32),
                          None)


# case: (the call at GAR-8B's head dim, the same call at a head dim with an
# instance, the kernel the message names)
GUARDS = {
    "C8 at 128": (lambda: tdec.check_fused(*_c_operands(128, int8=True)),
                  lambda: tdec.check_fused(*_c_operands(64, int8=True)), "kernel C8"),
    "C at 96": (lambda: tdec.check_fused(*_c_operands(96)),
                lambda: tdec.check_fused(*_c_operands(128)), "kernel C is built"),
    "mega 19 and 20 at 128": (lambda: _mega_qkv(128), lambda: _mega_qkv(64), "19 and 20"),
    "mega 22 at 128": (lambda: _mega_attn_wo(128), lambda: _mega_attn_wo(64), "kernel 22"),
    # the backward kernels have their 8B instances (5 at 96, 17 and 18 at
    # 128): those pass, and what still has none (80; 17 and 18 causal at 96,
    # where only kernel 5's full-attention instance exists) raises
    "train 5 at 96": (
        lambda: tva.check_backward_head_dim(80, "kernel 5 (the ViT attention backward)"),
        lambda: tva.check_backward_head_dim(96, "kernel 5 (the ViT attention backward)"),
        "kernel 5"),
    "train 17 and 18 at 128": (
        lambda: tfa_check_bwd(96), lambda: tfa_check_bwd(128), "kernels 17 and 18"),
    "A at 80": (lambda: tva.check_operands(*(_bf16(1, 9, 2, 80),) * 3),
                lambda: tva.check_operands(*(_bf16(1, 9, 2, 96),) * 3), "kernel A is built"),
    "B at 80": (lambda: tfa.check_operands(*(_bf16(1, 9, 2, 80),) * 3, causal=True),
                lambda: tfa.check_operands(*(_bf16(1, 9, 2, 128),) * 3, causal=True),
                "kernel B is built"),
}


def tfa_check_bwd(d):
    from grasp_any_region_tpu_torch.ops import flash_backward as tfb

    tfb.check_backward_head_dim(d, "kernels 17 and 18 (the flash backward)", causal=True)


@pytest.mark.parametrize("case", list(GUARDS))
def test_guards_refuse_head_dims_without_an_instance(case):
    """What the card would launch at GAR-8B's head dims where no instance
    exists (an int8 cache, the mega step, a train step, A or B at 80)
    raises, with a message naming the kernel, before anything launches;
    the same check passes at a head dim that has an instance."""
    bad, good, name = GUARDS[case]
    good()
    with pytest.raises(ValueError, match=name):
        bad()
    assert _no_launches()


def test_stream_chooser_at_8b_widths():
    """The weight stream's CTAs a column tile at GAR-8B's widths on 132 SMs
    (H, I, J at two CTAs an SM, I8 at one), and the plans cover each weight
    once: w_down (14336 -> 4096) and wo (4096 -> 4096) 4 CTAs a tile (256
    CTAs), I (4096 -> 14336, 224 tiles) 1, J (q 4096, k and v 1024: 96
    tiles) 2; int8: H8 8 (32 tiles of 128), I8 1 (112 tiles), J8 4 (48
    tiles)."""
    n8 = tlm.stream_n(torch.int8)
    got = {
        "H w_down": tlm.stream_splits(4096 // 64, 14336),
        "H wo": tlm.stream_splits(4096 // 64, 4096),
        "I": tlm.stream_splits(14336 // 64, 4096),
        "J": tlm.qkv_stream_splits(4096, 1024, 4096, 2),
        "H8 w_down": tlm.stream_splits(4096 // n8, 14336),
        "H8 wo": tlm.stream_splits(4096 // n8, 4096),
        "I8": tlm.stream_splits(14336 // n8, 4096, ctas_per_sm=tlm.STREAM_CTAS_PER_SM_Q8),
        "J8": tlm.qkv_stream_splits(4096, 1024, 4096, 1),
    }
    assert got == {"H w_down": 4, "H wo": 4, "I": 1, "J": 2, "H8 w_down": 8, "H8 wo": 8,
                   "I8": 1, "J8": 4}
    for din, dout, n, splits in ((14336, 4096, 64, 4), (4096, 14336, 64, 1),
                                 (14336, 4096, n8, 8), (4096, 14336, n8, 1)):
        plan = tlm.stream_plan(din, dout, splits, n)
        rows = {}
        for t, _, k0, k1 in plan:
            rows.setdefault(t, []).append((k0, k1))
        assert len(rows) == -(-dout // n)
        for spans in rows.values():  # each tile's ranks cover [0, din) once, in order
            assert spans[0][0] == 0 and spans[-1][1] == din
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert tlm.qkv_tiles(4096, 1024, 2) == 96 and tlm.qkv_tiles(4096, 1024, 1) == 48
