"""The port's train step against the JAX package's at gar_tiny in fp32: the
same JAX-initialised parameters (flattened to numpy and loaded into the
port), the same synthetic batch, its mask plane read as binary (mask_compat=False,
as `chip_smoke.py` and the JAX bench read it).

JAX's `loss_fn` and `packed_loss_fn` fix the compute dtype at bf16, so the
JAX side composes the same pieces at fp32 (`build_prefill_embeds` and
`llama_prefill` under remat, `chunked_cross_entropy`), and the port's
functions take compute_dtype=float32. JAX's optimizer is its optax chain
(`make_optimizer`). `mask_embed` is zero at init, which would leave its
gradient's path untested, so both trees get the same seeded random values.

Tolerances: the loss to rtol 1e-5, each gradient leaf within 1e-4 of that
leaf's max |g| (the frameworks sum in another order over whole towers),
and the parameters after three AdamW steps within 1e-5; at bf16 the AdamW
updates alone (the same gradients on both sides) are equal bit for bit.
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
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.weights import flat_grads, load_flat_params

F32 = torch.float32
# the bench's lr. Adam's first updates are ±lr·g/(|g| + eps), so an element
# whose gradient is near eps carries the frameworks' fp32 summation noise
# into its update at about 1% of lr: at 1e-4 that is 10x under the 1e-5
# tolerance on the parameters (at 1e-3 it reached 1.05e-5 under xdist).
LR = 1e-4


def _jax_loss(cfg, ce_chunk=1024):
    from grasp_any_region_tpu.models.gar import build_prefill_embeds
    from grasp_any_region_tpu.models.llama import llama_prefill
    from grasp_any_region_tpu.train.losses import chunked_cross_entropy, shift_labels

    def loss(params, batch, labels):
        embeds = build_prefill_embeds(params, cfg, batch, mask_compat=False, remat=True,
                                      compute_dtype=jnp.float32)
        hidden, _ = llama_prefill(params["llm"], cfg.text, embeds, batch.positions,
                                  segment_ids=batch.segment_ids, remat=True)
        return chunked_cross_entropy(params["llm"], cfg.text, hidden, shift_labels(labels),
                                     valid_vocab=cfg.extended_vocab_size, chunk_size=ce_chunk)

    return loss


@pytest.fixture(scope="module")
def setup():
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    cfg_j, cfg_t = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 0.02)
    flat = flatten_params(params)
    jb, jlabels, _ = jsb(cfg_j, batch=1, grid=(1, 1), seed=0)
    tb, tlabels, _ = tsb(cfg_t, batch=1, grid=(1, 1), seed=0, device="cpu")
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(cfg_j)))
    loss_j, grads_j = value_and_grad(params, jb, jlabels)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, flat=flat, jb=jb, jlabels=jlabels,
                tb=tb, tlabels=tlabels, value_and_grad=value_and_grad,
                loss_j=float(loss_j), grads_j=flatten_params(grads_j))


def _port(setup, grad=True):
    params = load_flat_params(setup["flat"], setup["cfg_t"], device="cpu")
    if grad:
        for p in params.parameters():
            p.requires_grad_(True)
    return params


def _port_loss_and_grads(setup, params=None, **kw):
    from grasp_any_region_tpu_torch.train import loss_fn

    params = params if params is not None else _port(setup)
    loss = loss_fn(params, setup["cfg_t"], setup["tb"], setup["tlabels"], mask_compat=False,
                   compute_dtype=F32, **kw)
    loss.backward()
    return loss.item(), flat_grads(params)


def _assert_leaves_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    worst = {}
    for name, g in want.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got[name] - g).max())
        worst[name] = err / scale if scale else err
        assert err <= rel * scale + 1e-12, (name, err, scale)
    return worst


def test_loss_and_every_gradient_leaf_match_jax(setup):
    loss, grads = _port_loss_and_grads(setup)
    np.testing.assert_allclose(loss, setup["loss_j"], rtol=1e-5)
    _assert_leaves_close(grads, setup["grads_j"], 1e-4)
    # the mask embed, the tower and the decoder all receive a gradient
    for name in ("mask_embed/kernel", "vision/blocks/wqkv", "vision/rope_freqs",
                 "projector/fc1", "llm/blocks/wq", "llm/embed"):
        assert np.abs(grads[name]).max() > 0, name


def test_remat_off_and_grouped_remat_give_the_same_gradients(setup):
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.models.gar import build_prefill_embeds
    from grasp_any_region_tpu_torch.models.llama import llama_prefill
    from grasp_any_region_tpu_torch.train.losses import chunked_cross_entropy, shift_labels

    cfg = setup["cfg_t"]
    tb, labels = setup["tb"], setup["tlabels"]

    def grads(params, remat, group=1):
        for p in params.parameters():
            p.grad = None
            p.requires_grad_(True)
        embeds = build_prefill_embeds(params, cfg, tb, mask_compat=False, remat=remat,
                                      remat_group=group, compute_dtype=F32)
        hidden, _ = llama_prefill(params.llm, cfg.text, embeds, tb.positions,
                                  segment_ids=tb.segment_ids, remat=remat, return_kv=False)
        loss = chunked_cross_entropy(params.llm, cfg.text, hidden, shift_labels(labels),
                                     valid_vocab=cfg.extended_vocab_size)
        loss.backward()
        return loss.item(), flat_grads(params)

    params = _port(setup)
    (l_on, g_on), (l_off, g_off) = grads(params, True), grads(params, False)
    np.testing.assert_allclose(l_on, l_off, rtol=1e-6)
    _assert_leaves_close(g_on, g_off, 1e-6)
    # depth 3: one checkpointed group of 2 blocks, then one block on its own
    cfg3 = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, depth=3))
    p3 = init_gar_params(cfg3, torch.Generator().manual_seed(0), device="cpu")
    cfg, keep = cfg3, cfg
    (l1, g1), (l2, g2) = grads(p3, True, 1), grads(p3, True, 2)
    cfg = keep
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    _assert_leaves_close(g2, g1, 1e-6)


def test_ce_chunk_does_not_change_loss_or_gradients(setup):
    (l64, g64), (l1k, g1k) = (_port_loss_and_grads(setup, ce_chunk=c) for c in (64, 1024))
    np.testing.assert_allclose(l64, l1k, rtol=1e-6)
    _assert_leaves_close(g64, g1k, 1e-6)


def _jax_steps(setup, opt_cfg_kw, label_sets):
    from grasp_any_region_tpu.train.optimizer import OptimizerConfig, make_optimizer

    params = setup["params"]
    tx = make_optimizer(params, OptimizerConfig(**opt_cfg_kw))
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    losses = []
    for labels in label_sets:
        loss, grads = setup["value_and_grad"](params, setup["jb"], labels)
        params, opt_state = update(params, opt_state, grads)
        losses.append(float(loss))
    return losses, flatten_params(params)


def _port_steps(setup, opt_cfg_kw, label_sets):
    from grasp_any_region_tpu_torch.train import OptimizerConfig, init_state, make_train_step

    state, tx = init_state(_port(setup, grad=False), OptimizerConfig(**opt_cfg_kw),
                           device="cpu")
    step = make_train_step(setup["cfg_t"], tx, mask_compat=False, device="cpu",
                           compute_dtype=F32)
    losses = []
    for labels in label_sets:
        state, metrics = step(state, setup["tb"], labels)
        losses.append(metrics["loss"].item())
        assert np.isfinite(metrics["grad_norm"].item())
    return losses, {n.replace(".", "/"): p.detach().numpy()
                    for n, p in state.params.named_parameters()}


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w, np.float32), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_three_adamw_steps_match_optax(setup):
    kw = dict(lr=LR, total_steps=100, warmup_ratio=0.03, weight_decay=0.01)
    labels = [setup["jlabels"]] * 3
    losses_j, params_j = _jax_steps(setup, kw, labels)
    losses_t, params_t = _port_steps(setup, kw, [setup["tlabels"]] * 3)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[2] < losses_t[0]
    _assert_params_close(params_t, params_j)


@pytest.mark.parametrize("case", ["one_update_default_betas", "three_clipped_updates"])
def test_bf16_adamw_matches_optax(setup, case):
    """bf16 parameters and moments: the port's AdamW against optax's chain
    (`make_optimizer`, under jax.jit) from the same seeded bf16 gradients,
    every element of every leaf equal. Three updates use bf16-exact betas
    (0.875, 0.9921875) and weight decay, with gradients whose global norm
    passes max_grad_norm, so clipping runs."""
    from grasp_any_region_tpu.train import optimizer as jopt
    from grasp_any_region_tpu_torch.train import OptimizerConfig, make_optimizer
    from grasp_any_region_tpu_torch.train.optimizer import global_norm

    kw = dict(lr=LR, total_steps=100, warmup_ratio=0.0)
    n, g_scale = 1, 1e-4
    if case == "three_clipped_updates":
        kw.update(betas=(0.875, 0.9921875), weight_decay=0.01)
        n, g_scale = 3, 1e-1
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), setup["params"])
    names = list(setup["flat"])
    grads = [{name: (rng.standard_normal(setup["flat"][name].shape) * g_scale).astype(np.float32)
              for name in names} for _ in range(n)]

    tx = jopt.make_optimizer(params, jopt.OptimizerConfig(**kw))
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def tree(flat):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(flat["/".join(str(k.key) for k in path)], jnp.bfloat16),
            params)

    for g in grads:
        params, opt_state = update(params, opt_state, tree(g))
    want = flatten_params(params)

    port = _port(setup, grad=False).to(torch.bfloat16)
    opt = make_optimizer(port, OptimizerConfig(**kw))
    state = opt.init(port)
    named = dict(port.named_parameters())
    norms = []
    for g in grads:
        for name, p in named.items():
            p.grad = torch.from_numpy(g[name.replace(".", "/")]).to(torch.bfloat16)
        norms.append(global_norm([p.grad for p in named.values()]).item())
        opt.apply(port, state)
    assert all(m.dtype == torch.bfloat16 for m in state.mu + state.nu)
    assert (min(norms) > 1.0) == (case == "three_clipped_updates")
    for name, p in named.items():
        got, ref = p.detach().float().numpy(), np.asarray(want[name.replace(".", "/")], np.float32)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert not np.array_equal(named["llm.blocks.wq"].detach().float().numpy(),
                              np.asarray(setup["flat"]["llm/blocks/wq"], np.float32))


def test_accumulation_applies_the_mean_every_second_step(setup):
    kw = dict(lr=LR, total_steps=10, warmup_ratio=0.0, accumulation=2)
    # two micro-batches that differ: the second supervises the answer's first half
    lab2 = np.array(setup["jlabels"])
    sup = np.nonzero(lab2[0] != -100)[0]
    lab2[0, sup[len(sup) // 2:]] = -100
    losses_j, params_j = _jax_steps(setup, kw, [setup["jlabels"], jnp.asarray(lab2)])
    losses_t, params_t = _port_steps(setup, kw, [setup["tlabels"], torch.from_numpy(lab2)])
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    _assert_params_close(params_t, params_j)
    moved = [n for n in params_t if not np.array_equal(params_t[n], setup["flat"][n])]
    assert "vision/blocks/wqkv" in moved


def test_freeze_visual_encoder_leaves_the_tower_unchanged(setup):
    from grasp_any_region_tpu_torch.train import OptimizerConfig

    kw = dict(lr=LR, total_steps=10, warmup_ratio=0.0)
    _, params = _port_steps(setup, dict(kw, freeze_visual_encoder=True), [setup["tlabels"]])
    for name, p in params.items():
        same = np.array_equal(p, setup["flat"][name])
        assert same == name.startswith("vision"), name
    assert OptimizerConfig().freeze_visual_encoder is False


def test_trainable_mask_and_schedule_match_optax(setup):
    from grasp_any_region_tpu.train import optimizer as jopt
    from grasp_any_region_tpu_torch.train import optimizer as topt

    params = _port(setup, grad=False)
    for kw in (dict(), dict(freeze_llm=True, unfreeze_vocab=False),
               dict(freeze_visual_encoder=True, freeze_connector=True, freeze_llm=True,
                    unfreeze_lm_head=False)):
        mask_j = flatten_params(jopt.trainable_mask(setup["params"], jopt.OptimizerConfig(**kw)))
        assert topt.trainable_mask(params, topt.OptimizerConfig(**kw)) == {
            n: bool(m) for n, m in mask_j.items()}
    for kw in (dict(lr=1e-4, total_steps=100), dict(lr=2e-5, total_steps=7, warmup_ratio=0.0)):
        sched_j = jopt.make_schedule(jopt.OptimizerConfig(**kw))
        sched_t = topt.make_schedule(topt.OptimizerConfig(**kw))
        counts = range(0, kw["total_steps"] + 3)
        np.testing.assert_allclose([sched_t(c) for c in counts],  # optax runs in fp32
                                   [float(sched_j(c)) for c in counts], rtol=1e-6,
                                   atol=1e-6 * kw["lr"])


def test_make_optimizer_refuses_an_int8_tree(setup):
    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights
    from grasp_any_region_tpu_torch.train import OptimizerConfig, make_optimizer

    with pytest.raises(ValueError, match="int8"):
        make_optimizer(quantize_decode_weights(_port(setup, grad=False)), OptimizerConfig())


def _docs(n_tokens, seed=0):
    """Synthetic documents of 30-120 tokens, some with a chat-template
    assistant span so the default labels supervise something."""
    from grasp_any_region_tpu_torch.core.config import (ASSISTANT_ROLE_ID, END_HEADER_ID,
                                                        EOT_TOKEN_ID, NEWLINE2_ID,
                                                        START_HEADER_ID)

    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < n_tokens:
        doc = rng.integers(10, 1000, int(rng.integers(30, 120))).astype(np.int32)
        if len(docs) % 2:
            doc[5:9] = [START_HEADER_ID, ASSISTANT_ROLE_ID, END_HEADER_ID, NEWLINE2_ID]
            doc[-3] = EOT_TOKEN_ID
        docs.append(doc)
        total += len(doc)
    return docs


@pytest.mark.parametrize("explicit_labels", [False, True])
def test_pack_text_batch_matches_jax(explicit_labels):
    from grasp_any_region_tpu.data.builders import pack_text_batch as jpack
    from grasp_any_region_tpu_torch.data.builders import pack_text_batch as tpack

    docs = _docs(3 * 256)
    labels = [d[::-1].copy() for d in docs] if explicit_labels else None
    want = jpack(docs, seq_len=256, labels=labels)
    got = tpack(docs, seq_len=256, labels=labels, device="cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.segment_ids.max() > 2 and (got.segment_ids == 0).any()


def test_packed_loss_and_gradients_match_jax(setup):
    from grasp_any_region_tpu.data.builders import pack_text_batch as jpack
    from grasp_any_region_tpu.models.llama import embed_tokens, llama_prefill
    from grasp_any_region_tpu.train.losses import chunked_cross_entropy, shift_labels
    from grasp_any_region_tpu_torch.data.builders import PackedTextBatch
    from grasp_any_region_tpu_torch.train import packed_loss_fn

    cfg_j = setup["cfg_j"]
    docs = _docs(2 * 256, seed=1)
    jp = jax.tree_util.tree_map(lambda x: x[:2], jpack(docs, seq_len=256, labels=docs))
    tp = PackedTextBatch(*(torch.from_numpy(np.array(x)) for x in jp))

    def jloss(params):
        embeds = embed_tokens(params["llm"], jp.input_ids, jnp.float32)
        hidden, _ = llama_prefill(params["llm"], cfg_j.text, embeds, jp.positions,
                                  segment_ids=jp.segment_ids, remat=True, right_padded=False)
        return chunked_cross_entropy(params["llm"], cfg_j.text, hidden, shift_labels(jp.labels),
                                     valid_vocab=cfg_j.extended_vocab_size)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(setup["params"])
    params = _port(setup)
    loss = packed_loss_fn(params, setup["cfg_t"], tp, compute_dtype=F32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    grads = flat_grads(params)
    _assert_leaves_close(grads, flatten_params(grads_j), 1e-4)
    assert np.abs(grads["vision/blocks/wqkv"]).max() == 0  # text only: no tower gradient


def test_train_entry_points_default_to_the_card(setup):
    """The factories run on the card unless asked for the CPU; without a
    card the default raises instead of falling back."""
    from grasp_any_region_tpu_torch.data.builders import pack_text_batch
    from grasp_any_region_tpu_torch.train import (OptimizerConfig, init_state,
                                                  make_packed_train_step, make_train_loop,
                                                  make_train_step, make_optimizer)

    cfg = setup["cfg_t"]
    tx = make_optimizer(_port(setup, grad=False), OptimizerConfig())
    calls = {
        "init_state": lambda: init_state(_port(setup, grad=False), OptimizerConfig())[0]
        .params.llm.embed,
        "make_train_step": lambda: make_train_step(cfg, tx),
        "make_packed_train_step": lambda: make_packed_train_step(cfg, tx),
        "make_train_loop": lambda: make_train_loop(cfg, tx, 2),
        "pack_text_batch": lambda: pack_text_batch(_docs(100), seq_len=128).input_ids,
    }
    card = torch.cuda.is_available()
    for name, call in calls.items():
        if card:
            out = call()
            assert not isinstance(out, torch.Tensor) or out.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
