"""The port's pipeline schedules (`parallel/pipeline.py`, the pipe branch of
`train/step.py`, the `Trainer` and `cli/train.py` at --pipe 2) on spawned
gloo ranks, against the JAX package at gar_tiny in fp32 (JAX's
tests/test_pipeline.py and tests/test_pipeline_1f1b.py, case for case).

JAX's references are its one-device `llama_prefill` and `value_and_grad`
of it and `chunked_cross_entropy`, which its own tests show equal to its
`pipeline_prefill` and `pipeline_train_1f1b`, and the `value_and_grad` of
its GAR loss (tower, projector, mask embed, decoder, CE) at fp32. Every
case of one world size runs in one spawn (`torch_ranks.multi_job`),
started before the references.

Bounds, JAX's: hidden atol 1e-5, fp32 loss rtol 1e-6, gradients atol 2e-5
(blocks gathered over the stages, the head and d(embeds)). The composed
fsdp = 2 x pipe = 2 GAR step, in fp32: its loss and grad_norm within rtol
1e-5 of JAX's (test_torch_train.py's loss bound: the frameworks sum the
tower in another order), every whole gradient leaf within atol 2e-5.
The packed step's schedules agree to rtol 1e-5. The `cli.train --pipe 2`
run's first loss within rtol 1e-5 of one process's (one row a step: the
same products), its logged loss equal at the log's four decimals; a run
resumed under 1F1B from the GPipe run's step-1 checkpoint ends bit-equal
to it (with one microbatch a step both schedules run the same operations
in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core.weights import flatten_params
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core.mesh import MeshSpec
from torch_ranks import (RankJob, multi_job, numpy_fields, packed_steps_job, pipe_trainer_job,
                         pipeline_job, replace_text, step_summary_job)

B, S = 4, 32
LR = 1e-3
LORA_TARGETS = ("wq", "wv")


def _cfgs(num_layers=4):
    """(JAX's, the port's) gar_tiny at num_layers (4 for the decoder cases at
    P = 4; the GAR steps take its own 2) and one tile a grid."""
    def cfg(mod):  # one tile a grid keeps the GAR steps' towers small
        return replace_text(dataclasses.replace(mod.gar_tiny(), max_num_tiles=1),
                            num_layers=num_layers)

    return cfg(jcfg), cfg(tcfg)


def _inputs(cfg, seed=7, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.text.vocab_size, (batch, seq)).astype(np.int32)
    labels[rng.random((batch, seq)) < 0.3] = -100  # ignored, as chat supervision leaves them
    return dict(embeds=rng.standard_normal((batch, seq, cfg.text.hidden_size)).astype(np.float32),
                positions=np.tile(np.arange(seq, dtype=np.int32), (batch, 1)), labels=labels)


def _left_pad_segments():
    seg = np.zeros((2, 48), np.int32)
    seg[0, :20], seg[0, 20:44], seg[1, :31] = 1, 2, 1
    return seg


def _packed(cfg):
    from grasp_any_region_tpu.data.builders import pack_text_batch

    rng = np.random.default_rng(0)
    docs = [rng.integers(5, 200, size=int(n)).astype(np.int32)
            for n in rng.integers(20, 60, size=8)]
    packed = pack_text_batch(docs, seq_len=64, labels=docs)
    return {k: np.asarray(v)[:2] for k, v in packed._asdict().items()}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's CPU work beside its six
    ranks (tests/test_torch_trainer.py's reason: the suite's workers
    share the machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One JAX-initialised tree (4 layers, one tile a grid, mask_embed
    seeded random), its LoRA form and its first 2 layers (the GAR steps'
    tree), each also in an .npz file the ranks read; the cases' inputs, a
    two-row GAR batch and an annotation file with the CLI's 2-layer config."""
    from grasp_any_region_tpu.data.synthetic import synthetic_batch
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu.train.lora import LoRAConfig, add_lora_params
    from grasp_any_region_tpu_torch.core.config import save_config
    from grasp_any_region_tpu_torch.data.synthetic import write_synthetic_annotations

    cj, ct = _cfgs()
    gar_cj, gar_ct = _cfgs(num_layers=2)
    params = jax.jit(init_gar_params, static_argnums=1)(jax.random.PRNGKey(0), cj)
    kshape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(kshape).astype(np.float32) * 0.02)
    lora = add_lora_params(jax.random.PRNGKey(1), params, cj.text,
                           LoRAConfig(rank=4, alpha=8, targets=LORA_TARGETS))
    shape = lora["llm"]["blocks"]["wq_lora_b"].shape
    lora["llm"]["blocks"]["wq_lora_b"] = jax.random.normal(jax.random.PRNGKey(2), shape) * 0.1
    gar = dict(params, llm=dict(params["llm"], blocks={
        k: v[:gar_cj.text.num_layers] for k, v in params["llm"]["blocks"].items()}))
    batch, labels, _ = synthetic_batch(cj, batch=2, grid=(1, 1), regions=1, seed=1)
    root = tmp_path_factory.mktemp("pipe")
    files = {}
    for name, tree in (("flat", params), ("flat_lora", lora), ("flat_gar", gar)):
        files[name] = str(root / f"{name}.npz")
        np.savez(files[name], **flatten_params(tree))
    ann = write_synthetic_annotations(str(root / "ann.json"), n_items=4, image_size=(96, 80),
                                      seed=3)
    save_config(gar_ct, str(root / "cfg.json"))
    cli = ["--config", str(root / "cfg.json"), "--data", ann, "--device", "cpu", "--lr", "1e-3",
           "--batch-size", "1", "--accumulation", "1", "--log-interval", "1"]
    left = _inputs(cj, seed=3, batch=2, seq=48)
    left["segment_ids"] = _left_pad_segments()
    left["labels"] = np.where(left["segment_ids"] > 0, left["labels"], -100).astype(np.int32)
    seg = _inputs(cj, batch=2, seq=16)
    seg["segment_ids"] = np.repeat(np.array([[1, 1, 2, 2], [1, 2, 2, 3]], np.int32), 4, axis=1)
    return dict(cj=cj, ct=ct, gar_cj=gar_cj, gar_ct=gar_ct, params=params, lora=lora, gar=gar,
                **files, plain=_inputs(cj), left=left, seg=seg, batch=batch,
                fields=numpy_fields(batch), labels=np.asarray(labels), packed=_packed(cj),
                cli=cli, ann=ann, root=root)


def _without_labels(inputs):
    return {k: v for k, v in inputs.items() if k != "labels"}


def _cases2(w):
    pipe2, ct = MeshSpec(pipe=2), w["ct"]
    flat, plain = w["flat"], w["plain"]
    prefill = [
        ("fwd_2_4", "prefill", pipe2, ct, flat, _without_labels(plain), dict(n_micro=4)),
        ("lora", "prefill", pipe2, ct, w["flat_lora"], _without_labels(plain), dict(n_micro=2)),
        ("segments", "prefill", pipe2, ct, flat, _without_labels(w["seg"]),
         dict(n_micro=2, right_padded=False)),
    ]
    train = [
        ("1f1b_2_4", "train", pipe2, ct, flat, plain, dict(n_micro=4, schedule="1f1b")),
        ("gpipe_2_4", "train", pipe2, ct, flat, plain, dict(n_micro=4, schedule="gpipe")),
        ("left_pad", "train", pipe2, ct, flat, w["left"],
         dict(n_micro=2, schedule="1f1b", right_padded=False)),
        ("no_remat", "train", pipe2, ct, flat, plain, dict(n_micro=2, schedule="gpipe",
                                                          remat=False)),
    ]
    trainer = (w["cli"], str(w["root"] / "ranks"))
    packed = (pipe2, ct, flat, w["packed"], LR, ("gpipe", "1f1b"), 2)
    # the trainer first: its steps take the longest, the references overlap them
    return [(pipe_trainer_job, trainer), (pipeline_job, (prefill + train,)),
            (packed_steps_job, packed)]


def _cases4(w):
    pipe4, ct, flat, plain = MeshSpec(pipe=4), w["ct"], w["flat"], w["plain"]
    cases = [
        ("fwd_4_4", "prefill", pipe4, ct, flat, _without_labels(plain), dict(n_micro=4)),
        ("fwd_4_2", "prefill", pipe4, ct, flat, _without_labels(plain), dict(n_micro=2)),
        ("gpipe_4_4", "train", pipe4, ct, flat, plain, dict(n_micro=4, schedule="gpipe")),
        ("1f1b_4_4", "train", pipe4, ct, flat, plain, dict(n_micro=4, schedule="1f1b")),
        ("1f1b_4_2", "train", pipe4, ct, flat, plain, dict(n_micro=2, schedule="1f1b")),
        ("data_2", "train", MeshSpec(data=2, pipe=2), ct, flat, plain,
         dict(n_micro=2, schedule="1f1b")),
    ]
    gar = [("fsdp_pipe", MeshSpec(fsdp=2, pipe=2), w["gar_ct"], w["flat_gar"], w["fields"],
            w["labels"], dict(pipe_schedule="1f1b"))]
    return [(pipeline_job, (cases,)), (step_summary_job, (gar, LR, (), ("fsdp_pipe",)))]


@pytest.fixture(scope="module")
def jobs(world):
    """Both spawns, started before the references so that they overlap."""
    return RankJob(2, multi_job, _cases2(world)), RankJob(4, multi_job, _cases4(world))


def _jax_gar_value_and_grad(world):
    """JAX's fp32 GAR loss (its train step's pieces, as tests/test_torch_train.py
    composes them, mask read as binary) and its whole gradients, on the
    2-layer tree and the two-row batch: (loss, {leaf: gradient}, norm)."""
    from grasp_any_region_tpu.models.gar import build_prefill_embeds
    from grasp_any_region_tpu.models.llama import llama_prefill
    from grasp_any_region_tpu.train.losses import chunked_cross_entropy, shift_labels

    cfg = world["gar_cj"]

    def loss(params, batch, labels):
        embeds = build_prefill_embeds(params, cfg, batch, mask_compat=False, remat=True,
                                      compute_dtype=jnp.float32)
        hidden, _ = llama_prefill(params["llm"], cfg.text, embeds, batch.positions,
                                  segment_ids=batch.segment_ids, remat=True, use_flash=False)
        return chunked_cross_entropy(params["llm"], cfg.text, hidden, shift_labels(labels),
                                     valid_vocab=cfg.extended_vocab_size)

    value, grads = jax.jit(jax.value_and_grad(loss))(world["gar"], world["batch"],
                                                      jnp.asarray(world["labels"]))
    grads = {k: np.asarray(v) for k, v in flatten_params(grads).items()}
    norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values())))
    return float(value), grads, norm


@pytest.fixture(scope="module")
def jax_refs(world, jobs):
    """JAX's one-device hidden states and (loss, gradients of the llm tree
    and of the embeds) on each case's inputs."""
    from grasp_any_region_tpu.models.llama import llama_prefill
    from grasp_any_region_tpu.train.losses import chunked_cross_entropy, shift_labels

    cfg = world["cj"].text

    def hidden(llm, e, pos, seg, right_padded):
        return llama_prefill(llm, cfg, e, pos, segment_ids=seg, right_padded=right_padded,
                             use_flash=False)[0]

    def loss(llm, e, pos, lab, seg, right_padded):
        return chunked_cross_entropy(llm, cfg, hidden(llm, e, pos, seg, right_padded),
                                     shift_labels(lab))

    fwd = jax.jit(hidden, static_argnums=4)
    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)), static_argnums=5)

    def args(inputs):
        seg = inputs.get("segment_ids")
        return (inputs["embeds"], inputs["positions"]), None if seg is None else jnp.asarray(seg)

    out = {"gar": _jax_gar_value_and_grad(world)}
    llm, lora_llm = world["params"]["llm"], world["lora"]["llm"]
    for name, tree, key, rp in (("plain", llm, "plain", True), ("lora", lora_llm, "plain", True),
                                ("segments", llm, "seg", False)):
        (e, pos), seg = args(world[key])
        out[f"hidden_{name}"] = np.asarray(fwd(tree, e, pos, seg, rp))
    out["hidden_lora_base"] = np.asarray(fwd(llm, *args(world["plain"])[0], None, True))
    out["hidden_segments_unmasked"] = np.asarray(fwd(llm, *args(world["seg"])[0], None, False))
    for name, key, rp in (("plain", "plain", True), ("left_pad", "left", False)):
        (e, pos), seg = args(world[key])
        value, (g_llm, g_e) = vg(llm, e, pos, world[key]["labels"], seg, rp)
        out[f"train_{name}"] = (float(value), flatten_params(g_llm), np.asarray(g_e))
    return out


@pytest.fixture(scope="module")
def one_process(world, jobs):
    """The port's one-process references: the fp32 packed step, and the
    loss of `cli.train`'s first step (taken before any update): one
    process's `loss_fn` on the first batch a one-process Trainer of the
    same file and flags builds, from the CLI's parameters."""
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.dataset import DatasetConfig, GraspAnyRegionDataset
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.train import OptimizerConfig
    from grasp_any_region_tpu_torch.train.step import loss_fn
    from grasp_any_region_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = world["gar_ct"]
    packed = packed_steps_job(0, MeshSpec(), world["ct"], world["flat"], world["packed"], LR,
                              ("gpipe",), 2)["gpipe"]
    dataset = GraspAnyRegionDataset(cfg, GARTokenizer.synthetic(cfg.prompt_numbers),
                                    DatasetConfig(annotation_paths=[world["ann"]]))
    params = init_gar_params(cfg, torch.Generator(device="cpu").manual_seed(0), device="cpu",
                             dtype=torch.float32)
    tr = Trainer(cfg, params, dataset, OptimizerConfig(total_steps=1), TrainerConfig(
        work_dir=str(world["root"] / "one"), max_steps=1, device="cpu", resume=False))
    batch, _, labels = tr.collate([dataset[i] for i in tr.step_indices(0, 1)])
    with torch.no_grad():
        loss = loss_fn(tr.state.params, cfg, batch, labels).item()
    return dict(packed=packed, first_loss=loss)


@pytest.fixture(scope="module")
def ranks(jobs, jax_refs, one_process):
    two, four = jobs
    return two.results(), four.results()


def _pipe(ranks, world_size, name):
    """[each rank's result of pipeline_job case `name`]."""
    return [r[1 if world_size == 2 else 0][name] for r in ranks[0 if world_size == 2 else 1]]


@pytest.mark.parametrize("name,world_size,ref", [
    ("fwd_2_4", 2, "hidden_plain"), ("fwd_4_4", 4, "hidden_plain"),
    ("fwd_4_2", 4, "hidden_plain")])
def test_forward_matches_one_device(ranks, jax_refs, name, world_size, ref):
    for hidden in _pipe(ranks, world_size, name):  # every stage gets the whole hidden
        np.testing.assert_allclose(hidden, jax_refs[ref], atol=1e-5)


def test_schedule_without_remat_matches_value_and_grad(ranks, jax_refs):
    """The schedules checkpoint each layer by default (JAX's remat); without
    it a stage keeps its layers' graphs whole, with the same result. The
    forward (`pipeline_prefill`) keeps no graph, so it takes no remat."""
    _assert_train_matches(_pipe(ranks, 2, "no_remat"), jax_refs["train_plain"], "no_remat")


def test_lora_terms_run_in_the_stages(ranks, jax_refs):
    assert not np.allclose(jax_refs["hidden_lora"], jax_refs["hidden_lora_base"])
    for hidden in _pipe(ranks, 2, "lora"):
        np.testing.assert_allclose(hidden, jax_refs["hidden_lora"], atol=1e-5)


def test_segment_ids_keep_the_block_diagonal_mask(ranks, jax_refs):
    assert not np.allclose(jax_refs["hidden_segments"], jax_refs["hidden_segments_unmasked"])
    for hidden in _pipe(ranks, 2, "segments"):
        np.testing.assert_allclose(hidden, jax_refs["hidden_segments"], atol=1e-5)


def _assert_train_matches(results, ref, name):
    loss, grads, d_embeds = ref
    for r in results:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-6, err_msg=name)
    got = results[0]["grads"]  # gathered whole on rank 0
    assert set(got) == set(grads), name
    for k, g in grads.items():  # blocks gathered over the stages, head summed over them
        np.testing.assert_allclose(got[k], g, atol=2e-5, err_msg=f"{name} {k}")
    got = np.zeros_like(d_embeds)
    groups = [r for r in results if r["d_embeds"] is not None]  # stage 0 of each row group
    per = d_embeds.shape[0] // len(groups)
    for r in groups:
        got[r["row_group"] * per:(r["row_group"] + 1) * per] = r["d_embeds"]
    np.testing.assert_allclose(got, d_embeds, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("name,world_size", [("1f1b_2_4", 2), ("1f1b_4_4", 4), ("1f1b_4_2", 4)])
def test_1f1b_matches_value_and_grad(ranks, jax_refs, name, world_size):
    _assert_train_matches(_pipe(ranks, world_size, name), jax_refs["train_plain"], name)


@pytest.mark.parametrize("name,world_size", [("gpipe_2_4", 2), ("gpipe_4_4", 4)])
def test_gpipe_backward_matches_value_and_grad(ranks, jax_refs, name, world_size):
    _assert_train_matches(_pipe(ranks, world_size, name), jax_refs["train_plain"], name)


def test_1f1b_packed_segments_left_pad(ranks, jax_refs):
    _assert_train_matches(_pipe(ranks, 2, "left_pad"), jax_refs["train_left_pad"], "left_pad")


def test_1f1b_composes_with_data_parallel(ranks, jax_refs):
    results = _pipe(ranks, 4, "data_2")
    assert sorted(r["row_group"] for r in results) == [0, 0, 1, 1]
    _assert_train_matches(results, jax_refs["train_plain"], "data_2")


@pytest.mark.parametrize("name,world_size", [("1f1b_2_4", 2), ("gpipe_2_4", 2),
                                             ("1f1b_4_4", 4), ("gpipe_4_4", 4)])
def test_only_the_last_stage_holds_head_gradients(ranks, name, world_size):
    head = ["embed", "final_norm"]
    for stage, r in enumerate(_pipe(ranks, world_size, name)):
        blocks = sorted(k for k in r["d_llm"] if k.startswith("blocks/"))
        assert len(blocks) == 9, r["d_llm"]
        on_head = sorted(k for k in r["held"] if not k.startswith("blocks."))
        assert on_head == (head if stage == world_size - 1 else []), (stage, r["held"])
        assert sorted(set(r["d_llm"]) - set(blocks)) == on_head


def test_factorizations_and_axes_are_checked():
    from grasp_any_region_tpu_torch.parallel.pipeline import _pipe_layout

    _, ct = _cfgs(num_layers=3)
    with pytest.raises(ValueError, match="num_layers"):
        _pipe_layout(MeshSpec(pipe=2), ct.text, 4, None)
    _, ct = _cfgs()
    with pytest.raises(ValueError, match="n_micro"):
        _pipe_layout(MeshSpec(pipe=2), ct.text, 4, 3)
    with pytest.raises(ValueError, match="must divide over data"):
        _pipe_layout(MeshSpec(data=2, pipe=2), ct.text, 4, 4)
    assert _pipe_layout(MeshSpec(data=2, pipe=2), ct.text, 4, None) == (2, 2, 2, 2)
    for axis in ("tensor", "seq"):
        with pytest.raises(ValueError, match=f"mesh axis '{axis}' has size 2"):
            _pipe_layout(MeshSpec(pipe=2, **{axis: 2}), ct.text, 4, None)


def test_bubble_fraction():
    from grasp_any_region_tpu_torch.parallel.pipeline import pipeline_bubble_fraction

    assert pipeline_bubble_fraction(1, 8) == 0.0
    assert pipeline_bubble_fraction(4, 12) == pytest.approx(3 / 15)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedule_tables_pass_each_message_one_tick_on(schedule):
    """Every microbatch runs forward then backward once on each stage; a
    stage's forward is the next stage's one tick later, its backward the
    previous stage's; 1F1B keeps at most P - s microbatches on stage s,
    GPipe all M."""
    from grasp_any_region_tpu_torch.parallel.pipeline import SCHEDULES

    for n_stages, n_micro in ((2, 4), (4, 4), (4, 2), (3, 8)):
        op, n_ticks = SCHEDULES[schedule](n_stages, n_micro)
        for s in range(n_stages):
            entries = [(t, op(s, t)) for t in range(n_ticks) if op(s, t) is not None]
            ticks = {e: t for t, e in entries}
            assert len(ticks) == len(entries) == 2 * n_micro
            live, peak = 0, 0
            for _, (kind, m) in entries:
                live += 1 if kind == "F" else -1
                peak = max(peak, live)
            assert peak == (min(n_stages - s, n_micro) if schedule == "1f1b" else n_micro)
            for m in range(n_micro):
                assert ticks[("F", m)] < ticks[("B", m)]
                if s + 1 < n_stages:
                    assert op(s + 1, ticks[("F", m)] + 1) == ("F", m)
                if s > 0:
                    assert op(s - 1, ticks[("B", m)] + 1) == ("B", m)


def test_composed_fsdp_pipe_train_step_matches_one_device(ranks, jax_refs):
    """cli/train --pipe 2 --fsdp 2's step (fp32, 1F1B) against JAX's one
    device: the loss on every rank, the norm of the gradients it clips and
    applies; the decoder's layers over the stages alone (JAX's rule: whole
    layers a stage, not sharded over fsdp)."""
    loss, _, norm = jax_refs["gar"]
    for r in ranks[1]:
        got = r[1]["fsdp_pipe"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-5)
        assert got["specs"]["llm.blocks.wq"] == ("pipe",)
        assert got["specs"]["projector.fc1"] == ("fsdp", "tensor")  # the front over fsdp
    assert len({r[1]["fsdp_pipe"]["loss"] for r in ranks[1]}) == 1


def test_composed_fsdp_pipe_gradients_match_jax(ranks, jax_refs):
    """The same step's whole gradients against JAX's one-device
    value_and_grad: the front's leaves fsdp-sharded on stage 0, the tied
    head gathered over fsdp on the last stage, every leaf outside the
    blocks summed over the stages and the rows."""
    _, grads, _ = jax_refs["gar"]
    got = ranks[1][0][1]["fsdp_pipe"]["grads"]  # gathered whole on rank 0
    assert set(got) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(got[name], g, atol=2e-5, rtol=0, err_msg=name)
    for name in ("mask_embed/kernel", "projector/fc1", "vision/blocks/wqkv", "llm/embed",
                 "llm/blocks/wq", "llm/final_norm"):  # each part of the tree has a gradient
        assert np.abs(grads[name]).max() > 1e-4, name


def test_packed_train_step_1f1b_matches_gpipe(ranks, one_process):
    for r in ranks[0]:
        np.testing.assert_allclose(r[2]["1f1b"], r[2]["gpipe"], rtol=1e-5)
        np.testing.assert_allclose(r[2]["gpipe"], one_process["packed"], rtol=1e-5)
        # packed_loss_fn's pipe branch: pipeline_prefill's hidden, broadcast, through the CE
        np.testing.assert_allclose(r[2]["value"], r[2]["gpipe"][0], rtol=1e-6)


def _logged(printed: str) -> list:
    return [float(line.split(" loss ")[1].split()[0]) for line in printed.splitlines()
            if line.startswith("[trainer] step")]


def test_pipe_trainer_matches_one_process_and_resumes_bit_equal(ranks, one_process):
    """cli.train --pipe 2 under each schedule: rank 0 alone prints, the
    loss (the last stage's) reaches it; a run resumed from the first run's
    step-1 checkpoint ends where that run does, on each stage."""
    r0, r1 = (r[0] for r in ranks[0])
    assert _logged(r1["whole"]["printed"]) == _logged(r1["resumed"]["printed"]) == []
    logged = _logged(r0["whole"]["printed"])
    assert len(logged) == 2 and logged[0] == round(one_process["first_loss"], 4)
    assert "[trainer] resumed from step 1" in r0["resumed"]["printed"]
    assert len(_logged(r0["resumed"]["printed"])) == 1
    np.testing.assert_allclose(r0["whole"]["losses"][0], one_process["first_loss"], rtol=1e-5)
    assert r0["whole"]["losses"] == r1["whole"]["losses"]
    assert r0["resumed"]["losses"] == r0["whole"]["losses"][1:]
    for r in (r0, r1):
        whole, resumed = r["whole"], r["resumed"]
        assert whole["step"] == resumed["step"] == 2
        assert whole["params"].keys() == resumed["params"].keys()
        assert whole["params"] == resumed["params"]  # sha256 of each leaf's bytes
        assert whole["moments"] == resumed["moments"]
    assert r0["whole"]["params"]["llm.blocks.wq"] != r1["whole"]["params"]["llm.blocks.wq"]


def test_ceiling_probe_on_the_cpu(capsys):
    from grasp_any_region_tpu_torch.utils.ceiling import main

    out = main(["--dim", "64", "--steps", "2", "--iters", "1", "--copy-mib", "1",
                "--device", "cpu"])
    assert out["matmul"]["tflops"] > 0 and out["copy"]["gbps"] > 0
    assert out["matmul"]["device"] == out["copy"]["device"] == "cpu"
    assert "[ceiling] cpu:" in capsys.readouterr().out


def test_ceiling_probe_needs_a_card_unless_asked_for_the_cpu():
    from grasp_any_region_tpu_torch.utils.ceiling import copy_rate, main, matmul_rate

    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs on it")
    for call in (lambda: main(["--dim", "64"]), lambda: matmul_rate(64),
                 lambda: copy_rate(1)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
