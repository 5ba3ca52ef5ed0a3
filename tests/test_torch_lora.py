"""The port's LoRA regime (`train/lora.py`, `OptimizerConfig.lora_only`, the
adapters in `llama_prefill`) against the JAX package's at gar_tiny in fp32:
JAX's `add_lora_params` tree (flattened to numpy, loaded into the port), the
same synthetic batch, its mask plane read as binary (mask_compat=False).

The adapters cover every target, with B seeded random on both sides (B = 0
at init would leave A's gradient path untested), and `mask_embed` seeded
random as in tests/test_torch_train.py. JAX's `loss_fn` fixes bf16, so the
JAX side composes its pieces at fp32 and the port passes
compute_dtype=float32.

Tolerances: the loss to rtol 1e-5; each gradient leaf within 1e-4 of that
leaf's max |g| (the frameworks sum in another order over whole towers);
parameters after three AdamW steps within 1e-5 and grad_norm to rtol 1e-5;
merged weights within 1e-6 of JAX's (one fp32 rank-4 product a weight);
merged against unmerged prefill within 1e-5 of the hidden state's range.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params
from grasp_any_region_tpu.train import lora as jlora
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import flat_grads, load_flat_params
from grasp_any_region_tpu_torch.train import lora as tlora

F32 = torch.float32
LR = 1e-4  # as tests/test_torch_train.py: Adam's first steps carry fp32 noise at ~1% of lr
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
JLC = jlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)
TLC = tlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)


def _jax_loss(cfg):
    from grasp_any_region_tpu.models.gar import build_prefill_embeds
    from grasp_any_region_tpu.models.llama import llama_prefill
    from grasp_any_region_tpu.train.losses import chunked_cross_entropy, shift_labels

    def loss(params, batch, labels):
        embeds = build_prefill_embeds(params, cfg, batch, mask_compat=False, remat=True,
                                      compute_dtype=jnp.float32)
        hidden, _ = llama_prefill(params["llm"], cfg.text, embeds, batch.positions,
                                  segment_ids=batch.segment_ids, remat=True)
        return chunked_cross_entropy(params["llm"], cfg.text, hidden, shift_labels(labels),
                                     valid_vocab=cfg.extended_vocab_size)

    return loss


@pytest.fixture(scope="module")
def setup():
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    base = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)
    base["mask_embed"]["kernel"] = jnp.asarray(
        rng.standard_normal(base["mask_embed"]["kernel"].shape).astype(np.float32) * 0.02)
    params = jlora.add_lora_params(jax.random.PRNGKey(1), base, cfg_j.text, JLC)
    blocks = dict(params["llm"]["blocks"])
    for t in TARGETS:
        shape = blocks[f"{t}_lora_b"].shape
        blocks[f"{t}_lora_b"] = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.02)
    params["llm"] = dict(params["llm"], blocks=blocks)
    jb, jlabels, _ = jsb(cfg_j, batch=1, grid=(1, 1), seed=0)
    tb, tlabels, _ = tsb(cfg_t, batch=1, grid=(1, 1), seed=0, device="cpu")
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(cfg_j)))
    loss_j, grads_j = value_and_grad(params, jb, jlabels)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, base=base, params=params,
                flat=flatten_params(params), jb=jb, jlabels=jlabels, tb=tb, tlabels=tlabels,
                value_and_grad=value_and_grad, loss_j=float(loss_j),
                grads_j=flatten_params(grads_j))


def _port(setup, grad=True, flat=None):
    params = load_flat_params(setup["flat"] if flat is None else flat, setup["cfg_t"],
                              device="cpu")
    if grad:
        for p in params.parameters():
            p.requires_grad_(True)
    return params


def _assert_leaves_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for name, g in want.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got[name] - g).max())
        assert err <= rel * scale + 1e-12, (name, err, scale)


def test_jax_lora_tree_loads_under_the_same_names(setup):
    params = _port(setup, grad=False)
    names = {n.replace(".", "/") for n, _ in params.named_parameters()}
    assert names == set(setup["flat"])
    assert {f"llm/blocks/{t}_lora_{x}" for t in TARGETS for x in "ab"} <= names
    assert "llm/lora_scaling" in names
    # the adapters and the scaling stay fp32 under a bf16 base
    bf16 = load_flat_params(setup["flat"], setup["cfg_t"], device="cpu", dtype=torch.bfloat16)
    assert bf16.llm.blocks.wq.dtype == torch.bfloat16
    assert bf16.llm.blocks.wq_lora_a.dtype == bf16.llm.lora_scaling.dtype == F32
    assert bf16.llm.lora_scaling.item() == JLC.scaling


def test_add_lora_params_matches_jax_layout_and_starts_at_the_base(setup):
    from grasp_any_region_tpu_torch.models.llama import embed_tokens, llama_prefill

    cfg = setup["cfg_t"]
    base = load_flat_params(flatten_params(setup["base"]), cfg, device="cpu")
    adapted = tlora.add_lora_params(base, cfg.text, TLC, torch.Generator().manual_seed(0))
    want = flatten_params(jlora.add_lora_params(jax.random.PRNGKey(1), setup["base"],
                                                setup["cfg_j"].text, JLC))
    got = {n.replace(".", "/"): p for n, p in adapted.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(np.shape(w)), name
        assert str(got[name].dtype).rsplit(".", 1)[-1] == str(np.asarray(w).dtype), name
    a = adapted.llm.blocks.wq_lora_a
    assert abs(a.std().item() - TLC.rank ** -0.5) < 0.05 and not adapted.llm.blocks.wq_lora_b.any()
    assert not hasattr(base.llm, "lora_scaling")  # the input tree is left as it was
    assert adapted.llm.blocks.wq is base.llm.blocks.wq  # unchanged leaves are shared
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 1000, (1, 12)))
    pos = torch.arange(12)[None]

    def hidden(p):
        return llama_prefill(p.llm, cfg.text, embed_tokens(p.llm, ids, F32), pos)[0]

    torch.testing.assert_close(hidden(adapted), hidden(base), rtol=0, atol=0)


def test_loss_and_every_gradient_leaf_match_jax(setup):
    from grasp_any_region_tpu_torch.train import loss_fn

    params = _port(setup)
    loss = loss_fn(params, setup["cfg_t"], setup["tb"], setup["tlabels"], mask_compat=False,
                   compute_dtype=F32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), setup["loss_j"], rtol=1e-5)
    grads = flat_grads(params)
    _assert_leaves_close(grads, setup["grads_j"], 1e-4)
    for name in ("llm/lora_scaling", "llm/blocks/wq_lora_a", "llm/blocks/w_down_lora_b",
                 "llm/blocks/wq", "vision/pos_embed", "mask_embed/kernel"):
        assert np.abs(grads[name]).max() > 0, name


def test_trainable_mask_matches_jax(setup):
    from grasp_any_region_tpu_torch.train import OptimizerConfig, make_optimizer

    params = _port(setup, grad=False)
    for train_embeddings in (True, False):
        want = flatten_params(jlora.lora_trainable_mask(setup["params"],
                                                        train_embeddings=train_embeddings))
        got = tlora.lora_trainable_mask(params, train_embeddings=train_embeddings)
        assert got == {n: bool(m) for n, m in want.items()}
        assert got["vision/pos_embed"] == train_embeddings  # the reference's suffix rule
        assert not got["vision/patch_embed/kernel"] and not got["llm/lora_scaling"]
    # lora_only: lm_head and the embeddings follow unfreeze_vocab, not unfreeze_lm_head
    for kw, trained in ((dict(), True), (dict(unfreeze_lm_head=False), True),
                        (dict(unfreeze_vocab=False), False)):
        names = make_optimizer(params, OptimizerConfig(lora_only=True, **kw)).names
        assert ("llm.embed" in names) == trained and ("vision.pos_embed" in names) == trained
        assert "llm.blocks.wv_lora_b" in names and "mask_embed.kernel" in names
        assert "llm.blocks.wv" not in names and "llm.lora_scaling" not in names


def test_three_lora_only_adamw_steps_match_optax(setup):
    from grasp_any_region_tpu.train.optimizer import OptimizerConfig as JOpt, make_optimizer
    from grasp_any_region_tpu_torch.train import OptimizerConfig, init_state, make_train_step

    kw = dict(lr=LR, total_steps=100, warmup_ratio=0.0, weight_decay=0.01, lora_only=True)
    params = setup["params"]
    tx = make_optimizer(params, JOpt(**kw))
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, optax.global_norm(grads)

    losses_j, norms_j = [], []
    for _ in range(3):
        loss, grads = setup["value_and_grad"](params, setup["jb"], setup["jlabels"])
        params, opt_state, norm = update(params, opt_state, grads)
        losses_j.append(float(loss))
        norms_j.append(float(norm))
    want = flatten_params(params)

    state, ttx = init_state(_port(setup, grad=False), OptimizerConfig(**kw), device="cpu")
    step = make_train_step(setup["cfg_t"], ttx, mask_compat=False, device="cpu",
                           compute_dtype=F32)
    losses_t, norms_t = [], []
    for _ in range(3):
        state, metrics = step(state, setup["tb"], setup["tlabels"])
        losses_t.append(metrics["loss"].item())
        norms_t.append(metrics["grad_norm"].item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    np.testing.assert_allclose(norms_t, norms_j, rtol=1e-5)  # over every gradient
    assert losses_t[2] < losses_t[0]
    got = {n.replace(".", "/"): p.detach().numpy() for n, p in state.params.named_parameters()}
    mask = tlora.lora_trainable_mask(state.params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w, np.float32), atol=1e-5, rtol=0,
                                   err_msg=name)
        assert np.array_equal(got[name], setup["flat"][name]) != mask[name], name
    assert all(p.grad is None for p in state.params.parameters())


def test_merge_lora_matches_jax_and_keeps_the_prefill(setup):
    from grasp_any_region_tpu_torch.models.llama import embed_tokens, llama_prefill

    cfg = setup["cfg_t"]
    params = _port(setup, grad=False)
    merged = tlora.merge_lora(params, TLC)
    want = flatten_params(jlora.merge_lora(setup["params"], JLC))
    got = {n.replace(".", "/"): p.detach().numpy() for n, p in merged.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
    assert hasattr(params.llm, "lora_scaling")  # the input tree is left as it was
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 1000, (2, 17)))
    pos = torch.arange(17).expand(2, 17)

    def hidden(p):
        return llama_prefill(p.llm, cfg.text, embed_tokens(p.llm, ids, F32), pos)[0]

    h_adapted, h_merged = hidden(params), hidden(merged)
    span = (h_adapted.max() - h_adapted.min()).item()
    assert (h_merged - h_adapted).abs().max().item() <= 1e-5 * span
    # the adapters act: without them the prefill differs
    base = load_flat_params(flatten_params(setup["base"]), cfg, device="cpu")
    assert (hidden(base) - h_adapted).abs().max().item() > 1e-3 * span
    # JAX's prefill of the adapted tree gives the same hidden state
    from grasp_any_region_tpu.models.llama import embed_tokens as jembed
    from grasp_any_region_tpu.models.llama import llama_prefill as jprefill

    jids = jnp.asarray(ids.numpy(), jnp.int32)
    jh, _ = jprefill(setup["params"]["llm"], setup["cfg_j"].text,
                     jembed(setup["params"]["llm"], jids, jnp.float32),
                     jnp.asarray(pos.numpy(), jnp.int32), use_flash=False)
    assert np.abs(np.asarray(jh) - h_adapted.numpy()).max() <= 1e-5 * span


def _decode_calls(params, cfg):
    """Each decode or serving entry point of models/llama.py on tiny inputs."""
    from grasp_any_region_tpu_torch.models import llama as tl

    t = cfg.text
    L, kh, dh, d = t.num_layers, t.num_kv_heads, t.head_dim, t.hidden_size

    def cache():
        kv = torch.zeros((L, 1, kh, 8, dh))
        return tl.KVCache(kv, kv.clone(), torch.tensor([2], dtype=torch.int32),
                          torch.tensor(4, dtype=torch.int32))

    x = torch.zeros((1, 1, d))
    pool = torch.zeros((L, kh, 4, 4, dh))
    paged = dict(block_table=torch.zeros((1, 2), dtype=torch.int32),
                 seq_lens=torch.tensor([3], dtype=torch.int32), active=torch.tensor([True]))
    return {
        "llama_decode_step": lambda: tl.llama_decode_step(params.llm, t, x, cache(), 4),
        "llama_decode_step_fused": lambda: tl.llama_decode_step_fused(params.llm, t, x, cache(), 4),
        "llama_decode_step_mega": lambda: tl.llama_decode_step_mega(params.llm, t, x, cache(), 4),
        "llama_decode_step_paged": lambda: tl.llama_decode_step_paged(
            params.llm, t, x, pool, pool.clone(), **paged),
        "llama_decode_step_paged_fused": lambda: tl.llama_decode_step_paged_fused(
            params.llm, t, x, pool, pool.clone(), **paged),
        "llama_prefill_chunk": lambda: tl.llama_prefill_chunk(
            params.llm, t, torch.zeros((1, 3, d)), torch.arange(3)[None]),
    }


DECODE_ENTRIES = ("llama_decode_step", "llama_decode_step_fused", "llama_decode_step_mega",
                  "llama_decode_step_paged", "llama_decode_step_paged_fused",
                  "llama_prefill_chunk")


@pytest.mark.parametrize("entry", DECODE_ENTRIES)
def test_decode_steps_refuse_an_unmerged_tree(setup, entry):
    params = _port(setup, grad=False)
    with pytest.raises(ValueError, match="merge_lora"):
        _decode_calls(params, setup["cfg_t"])[entry]()
    # merged, the same call runs
    _decode_calls(tlora.merge_lora(params, TLC), setup["cfg_t"])[entry]()


def test_lora_only_step_on_a_bf16_base_keeps_the_adapters_fp32(setup):
    """The 8B regime in small: a bf16 base with fp32 adapters, lora_only,
    the bf16 compute path; the base does not move, the adapters do, and
    every gradient is freed by the step."""
    from grasp_any_region_tpu_torch.train import OptimizerConfig, init_state, make_train_step

    params = load_flat_params(setup["flat"], setup["cfg_t"], device="cpu", dtype=torch.bfloat16)
    state, tx = init_state(params, OptimizerConfig(lr=1e-3, total_steps=10, warmup_ratio=0.0,
                                                   lora_only=True), device="cpu")
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    step = make_train_step(setup["cfg_t"], tx, mask_compat=False, device="cpu")
    state, metrics = step(state, setup["tb"], setup["tlabels"])
    assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
    for n, p in state.params.named_parameters():
        if n not in tx.names:
            assert torch.equal(p, before[n]), n  # frozen leaves never move
        assert p.grad is None
    for n in ("llm.blocks.wq_lora_a", "llm.blocks.w_down_lora_b", "mask_embed.kernel"):
        assert not torch.equal(state.params.get_parameter(n), before[n]), n
    assert all(m.dtype == F32 for m, n in zip(state.opt_state.mu, tx.names) if "_lora_" in n)
    assert state.params.llm.blocks.wq_lora_b.dtype == F32
    assert "llm.blocks.wq_lora_b" in tx.names and "llm.blocks.wq" not in tx.names
    assert dataclasses.is_dataclass(OptimizerConfig()) and not OptimizerConfig().lora_only
