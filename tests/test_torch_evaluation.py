"""The PyTorch port's evaluation package against the JAX package's: every
case of tests/test_evaluation.py on both sides' functions with the same
inputs; the four benchmark loaders (GAR-Bench in its three modes, DLC,
Ferret, MDVP) on synthetic files at gar_tiny fp32, output JSON equal to
JAX's key for key and text for text, and the generated tokens equal;
`BatchedCaptioner`'s padding; each `judge-*` subcommand of `cli.eval` on a
stub judge, records equal to JAX's; `JudgeClient` against a stub judge
service on the loopback.

The loaders' checkpoint and fp32 runtime are tests/test_torch_runtime.py's
(`ckpt`, `_fp32_runtime`): JAX's generate runs jitted at fp32 and both
sides resize in numpy.
"""

import base64
import functools
import io
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from grasp_any_region_tpu.cli import eval as jeval
from grasp_any_region_tpu.data.rle import encode_rle as j_encode_rle
from grasp_any_region_tpu.evaluation import coco as jcoco
from grasp_any_region_tpu.evaluation import dlc as jdlc
from grasp_any_region_tpu.evaluation import engine as jengine
from grasp_any_region_tpu.evaluation import ferret as jferret
from grasp_any_region_tpu.evaluation import garbench as jgb
from grasp_any_region_tpu.evaluation import mdvp as jmdvp
from grasp_any_region_tpu.evaluation.judges import client as jclient
from grasp_any_region_tpu.evaluation.judges import dlc_judge as jdj
from grasp_any_region_tpu.evaluation.judges import garbench_judge as jgj
from grasp_any_region_tpu.evaluation.judges import paint as jpaint
from grasp_any_region_tpu.evaluation.judges import pairwise_judge as jpj
from grasp_any_region_tpu_torch.cli import eval as teval
from grasp_any_region_tpu_torch.data.rle import encode_rle, polygon_to_mask, segmentation_to_mask
from grasp_any_region_tpu_torch.evaluation import coco as tcoco
from grasp_any_region_tpu_torch.evaluation import dlc as tdlc
from grasp_any_region_tpu_torch.evaluation import engine as tengine
from grasp_any_region_tpu_torch.evaluation import ferret as tferret
from grasp_any_region_tpu_torch.evaluation import garbench as tgb
from grasp_any_region_tpu_torch.evaluation import mdvp as tmdvp
from grasp_any_region_tpu_torch.evaluation.judges import client as tclient
from grasp_any_region_tpu_torch.evaluation.judges import dlc_judge as tdj
from grasp_any_region_tpu_torch.evaluation.judges import garbench_judge as tgj
from grasp_any_region_tpu_torch.evaluation.judges import paint as tpaint
from grasp_any_region_tpu_torch.evaluation.judges import pairwise_judge as tpj
from grasp_any_region_tpu_torch.evaluation.synthetic import write_benchmark_files
from tests.test_torch_runtime import _fp32_runtime, ckpt, port_numpy_resize  # noqa: F401

SIDES = {"jax": dict(gb=jgb, dj=jdj, pj=jpj, coco=jcoco, paint=jpaint, mdvp=jmdvp,
                     ferret=jferret, gj=jgj),
         "torch": dict(gb=tgb, dj=tdj, pj=tpj, coco=tcoco, paint=tpaint, mdvp=tmdvp,
                       ferret=tferret, gj=tgj)}


# ---------------------------------------------------------------------------
# tests/test_evaluation.py's cases, on both sides
# ---------------------------------------------------------------------------

def test_score_vqa_exact_match():
    items = [
        {"type": "color", "answer": "A", "model_output": "a"},
        {"type": "color", "answer": "B", "model_output": "C"},
        {"type": "shape", "answer": "D", "model_output": "D"},
    ]
    s = tgb.score_vqa(items)
    assert s["color"] == 50.0 and s["shape"] == 100.0 and s["overall"] == 66.7
    assert s == jgb.score_vqa(items)


@pytest.mark.parametrize("mode", ["vqa", "simple", "detailed"])
def test_build_question(mode):
    item = {"question": "Which is red?", "choices": ["A. <Prompt0>", "B. <Prompt1>"]}
    q = tgb.build_question(item, mode)
    assert q == jgb.build_question(item, mode)
    if mode == "vqa":
        assert q.startswith("Question: Which is red?\nOptions:\nA. <Prompt0>\nB. <Prompt1>")
        assert q.endswith("Answer with the correct option's letter directly.")
    with pytest.raises(ValueError):
        tgb.build_question(item, "other")


def test_parse_pred_variants():
    choices = ["The color is red.", "The color is blue.", "Not mentioned."]
    cases = {"B": 1, "b. the color is blue.": 1, "The color is red.": 0,
             "I think the answer is: not mentioned.": 2, "A\nbecause...": 0,
             "totally unrelated": None, "": None, "c.": 2, "color is": 1}
    for pred, want in cases.items():
        got = tdj.parse_pred(pred, choices)
        assert got == jdj.parse_pred(pred, choices), pred
        if pred not in ("c.", "color is"):
            assert got == want, pred


class FakeClient:
    def __init__(self, answers):
        self.answers = list(answers)
        self.messages = []

    def chat(self, messages):
        self.messages.append(messages)
        return self.answers.pop(0)


QS = [
    {"question": "recog?", "choices": [["correct", "correct"], ["incorrect", "incorrect"]],
     "type": "recognition"},
    {"question": "q1", "choices": [["good", 1.0], ["bad", -1.0]], "type": "positive"},
    {"question": "q2", "choices": [["mentioned wrongly", -1.0], ["not mentioned", 1.0]],
     "type": "negative"},
]


@pytest.mark.parametrize("answers", [["A", "A", "B"], ["B", "A", "B"], ["A", "B", "A"]])
def test_evaluate_one_scoring_and_recognition_gate(answers):
    got = tdj.evaluate_one(FakeClient(answers), QS, "caption", images=[])
    assert got == jdj.evaluate_one(FakeClient(answers), QS, "caption", images=[])
    if answers[0] == "A" and answers[1] == "A":
        assert got["recognition_result"] is True
        assert got["score_pos"] == 1.0 and got["score_neg"] == 1.0
    if answers[0] == "B":  # failed recognition clamps positive scores to <= 0
        assert got["recognition_result"] is False and got["score_pos"] == 0.0


def test_evaluate_one_sends_jaxs_messages_and_honours_overrides():
    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    tc, jc = FakeClient(["A", "B"]), FakeClient(["A", "B"])
    got = tdj.evaluate_one(tc, QS, "cap", [img], response_override=[None, "A", None])
    want = jdj.evaluate_one(jc, QS, "cap", [img], response_override=[None, "A", None])
    assert got == want and len(tc.messages) == 2
    for tm, jm in zip(tc.messages, jc.messages):
        _assert_same_messages(tm, jm)


def test_pairwise_scores_and_summary():
    for text in ("8 6\nexplanation", "garbage", "7, 9\nok", "", "10\n"):
        assert tpj.parse_scores(text) == jpj.parse_scores(text)
    assert tpj.parse_scores("8 6\nexplanation") == [8.0, 6.0]
    assert tpj.parse_scores("garbage") is None
    recs = [
        {"scores": [8.0, 6.0], "dataset_name": "natural"},
        {"scores": [5.0, 5.0], "dataset_name": "natural"},
        {"scores": [4.0, 6.0], "dataset_name": "ocr"},
        {"scores": None},
    ]
    s = tpj.summarize(recs)
    assert s == jpj.summarize(recs)
    assert tpj.summarize(recs[:2] + recs[3:])["overall"] == round((5.5 / 6.5) * 100, 1)


def test_polygon_to_mask_rectangle():
    poly = [[2, 3, 10, 3, 10, 8, 2, 8]]
    m = polygon_to_mask(poly, 12, 14)
    assert m[5, 5] == 1 and m[3, 2] == 1
    assert m[2, 5] == 0 and m[9, 5] == 0 and m[5, 11] == 0
    assert m.sum() == (10 - 2) * (8 - 3)


def test_polygon_triangle_and_rle_seg():
    tri = [[0, 0, 8, 0, 0, 8]]
    m = polygon_to_mask(tri, 8, 8)
    assert m[0, 0] == 1 and m[7, 7] == 0
    assert 20 <= m.sum() <= 36
    rle = encode_rle(m)
    np.testing.assert_array_equal(segmentation_to_mask(rle, 8, 8), m)


def _coco_file(tmp_path):
    m = np.zeros((10, 12), np.uint8)
    m[2:6, 3:9] = 1
    rle = j_encode_rle(m)
    rle["counts"] = rle["counts"].decode()
    d = {
        "images": [{"id": 1, "height": 10, "width": 12, "file_name": "x.jpg"}],
        "annotations": [
            {"id": 7, "image_id": 1, "area": 24.0, "segmentation": rle, "category_id": 1},
            {"id": 8, "image_id": 1, "area": 999.0, "segmentation": rle, "category_id": 1},
            {"id": 9, "image_id": 1, "area": 30.0, "category_id": 1,
             "segmentation": [[1, 1, 9, 1, 9, 7, 1, 7]]},
        ],
        "categories": [{"id": 1, "name": "thing"}],
    }
    p = tmp_path / "coco.json"
    p.write_text(json.dumps(d))
    return str(p), m


def test_coco_reader(tmp_path):
    path, m = _coco_file(tmp_path)
    coco, want = tcoco.COCO(path), jcoco.COCO(path)
    assert coco.get_img_ids() == [1] == want.get_img_ids()
    assert coco.get_cat_ids() == want.get_cat_ids()
    assert coco.get_ann_ids(1) == [7, 8, 9] == want.get_ann_ids(1)
    assert coco.get_ann_ids(1, area_max=100) == [7, 9] == want.get_ann_ids(1, area_max=100)
    assert coco.get_ann_ids(1, area_min=25) == want.get_ann_ids(1, area_min=25)
    np.testing.assert_array_equal(coco.ann_to_mask(7), m)
    for a in (7, 9):
        np.testing.assert_array_equal(coco.ann_to_mask(a), want.ann_to_mask(a))


@pytest.mark.parametrize("kind", ["box", "point", "none"])
def test_paint_geometry(kind):
    """Numbered-box and dot markup (MDVP paint_util.py semantics), pixel
    for pixel JAX's."""
    img = np.full((100, 120, 3), 200, np.uint8)
    if kind == "box":
        out = tpaint.paint_text_box(img, [(30, 40, 50, 30), (2, 2, 20, 10)])
        np.testing.assert_array_equal(
            out, jpaint.paint_text_box(img, [(30, 40, 50, 30), (2, 2, 20, 10)]))
        assert abs(int(out[5, 50, 0]) - 160) <= 1
        assert tuple(out[40, 60]) == (0, 255, 0) and tuple(out[70, 60]) == (0, 255, 0)
        patch = out[40:62, 30:60]
        assert (patch == 255).all(axis=-1).any() and (patch == 0).all(axis=-1).any()
    elif kind == "point":
        out = tpaint.paint_text_point(img, [(60, 50), (115, 5)])
        np.testing.assert_array_equal(out, jpaint.paint_text_point(img, [(60, 50), (115, 5)]))
        assert tuple(out[50, 60]) == (0, 255, 0)
        assert abs(int(out[30, 5, 0]) - 140) <= 1
    else:
        assert np.array_equal(tpaint.paint_annotation(img, {}), img)
        ann = {"bbox": [(10, 10, 20, 20)]}
        np.testing.assert_array_equal(tpaint.paint_annotation(img, ann),
                                      jpaint.paint_annotation(img, ann))
        ann = {"points": [(10, 10)]}
        np.testing.assert_array_equal(tpaint.paint_annotation(img, ann),
                                      jpaint.paint_annotation(img, ann))


def test_mdvp_transfer_carries_annotation_and_context():
    results = [
        {"image_path": "a.jpg", "dataset_name": "mdvp_natural", "caption": "pred",
         "gt": "ref", "annotation": {"bbox": [[1, 2, 3, 4]]}},
        {"image_path": "b.jpg", "dataset_name": None, "caption": "p", "gt": "r"},
    ]
    tri = tmdvp.transfer(results)
    assert tri == jmdvp.transfer(results)
    assert tri[0]["annotation"] == {"bbox": [[1, 2, 3, 4]]}
    assert tri[0]["context"] == "The image is a natural image."
    for name in ("ocr_chart", None, "web_page", "Android_x", "unknown"):
        assert tmdvp.context_for(name) == jmdvp.context_for(name)
    assert tmdvp.context_for("ocr_chart") is not None and tmdvp.context_for(None) is None


def _mdvp_phase_dir(tmp_path):
    phase = tmp_path / "natural_detailed_caption_box"
    phase.mkdir()
    (phase / "question.json").write_text(json.dumps([
        {"image": "img0.png", "text": "Describe region 1.", "category": "natural",
         "annotation": {"bbox": [[4, 5, 20, 12]]}},
        {"image": "img1.png", "text": "Describe region 1.",
         "annotation": {"points": [[30, 20]]}}]))
    (phase / "answer.json").write_text(json.dumps([{"text": "gt one"}, {"text": "gt two"}]))
    (phase / "prediction.json").write_text(json.dumps([{"text": "p one"}, {"text": "p two"}]))
    return str(phase)


def test_mdvp_gpt4v_eval_dir_loads_reference_format(tmp_path):
    phase = _mdvp_phase_dir(tmp_path)
    tri = tmdvp.load_gpt4v_eval_dir(phase)
    assert tri == jmdvp.load_gpt4v_eval_dir(phase)
    assert len(tri) == 2 and tri[0]["context"] == "The image is a natural image."
    assert tri[1]["dataset_name"] == "natural_detailed_caption_box"


@pytest.mark.parametrize("category", ["refer_desc", "refer_reason", "ground_conv", "other"])
def test_ferret_postprocess_answer(category):
    answer = ("A cat [12, 40, 300, 500] sits on a mat [1,2,3] near [a, b, c, d] "
              "the door [0.5, 7, 999, 1000].")
    got = tferret.postprocess_answer(answer, category)
    assert got == jferret.postprocess_answer(answer, category)
    if category == "refer_desc":
        assert "[" not in got


def _ferret_bundle(tmp_path, n=3):
    root = tmp_path / "ferret_gpt4_data"
    phase = root / "refer_desc"
    phase.mkdir(parents=True)

    def jsonl(name, rows):
        (phase / name).write_text("".join(json.dumps(r) + "\n" for r in rows))

    jsonl("question.jsonl", [{"image": f"img{i % 2}.png", "text": f"What is region {i}?",
                              "category": "refer_desc"} for i in range(n)])
    jsonl("answer.jsonl", [{"text": f"GPT-4 answer {i}"} for i in range(n)])
    jsonl("context.jsonl", [{"image": f"img{i}.png", "text": f"context {i}"} for i in range(2)])
    (root / "rule.json").write_text(json.dumps({"refer_desc": {
        "role": "Assistant", "prompt": "We would like to request your feedback on two AI "
        "assistants."}}))
    return str(root)


def test_ferret_load_gpt4_data(tmp_path):
    root = _ferret_bundle(tmp_path)
    preds = [{"question_id": 0, "image": "img0.png", "category": "refer_desc",
              "text": "a cat [1, 2, 3, 4] here"},
             {"image_path": "img1.png", "caption": "a dog"},
             {"question_id": 2, "image": "img0.png", "text": "plain"}]
    got = tferret.load_gpt4_data(root, preds)
    assert got == jferret.load_gpt4_data(root, preds)
    assert got[0][0]["prediction"] == "a cat here" and got[1]["role"] == "Assistant"


def test_region_evidence_and_image_content():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (90, 140, 3), dtype=np.uint8)
    mask = np.zeros((90, 140), np.uint8)
    mask[30:50, 60:75] = 1
    assert tgj.mask_to_box(mask) == jgj.mask_to_box(mask)
    for (tc, tm), (jc, jm) in [(tgj.region_evidence(img, mask), jgj.region_evidence(img, mask))]:
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tm, jm)
    for arr in (img, mask * 255, img.astype(np.float32) * 1.5):
        got, want = tclient.image_content(arr), jclient.image_content(arr)
        assert got["type"] == want["type"] == "image_url"
        np.testing.assert_array_equal(_image_of(got), _image_of(want))


# ---------------------------------------------------------------------------
# the loaders at gar_tiny fp32 against JAX's
# ---------------------------------------------------------------------------

TASKS = ["garbench-vqa", "garbench-simple", "garbench-detailed", "dlc", "ferret", "mdvp"]
NEW = 6
BATCH = 2


def _run_task(side, task, cap, files, out):
    mods = dict(jax=(jgb, jdlc, jferret, jmdvp), torch=(tgb, tdlc, tferret, tmdvp))[side]
    gb, dlc, ferret, mdvp = mods
    if task.startswith("garbench-"):
        mode = task.split("-", 1)[1]
        anno = files["garbench_vqa" if mode == "vqa" else "garbench_detailed"]
        return gb.run_garbench(cap, anno, files["images"], mode, out, limit=3)
    if task == "dlc":
        return dlc.run_dlc(cap, files["dlc"], files["dlc_root"], out, limit=3)
    if task == "ferret":
        return ferret.run_ferret(cap, files["ferret"], files["images"], out, limit=3)
    return mdvp.run_mdvp(cap, files["mdvp"], files["images"], out, limit=3)


@pytest.fixture(scope="module")
def loader_runs(ckpt, tmp_path_factory):  # noqa: F811
    """Each loader once on each side over the same synthetic files: the
    output JSON files, the returned results and the tokens of every
    generate call."""
    from grasp_any_region_tpu.cli import runtime as jrt
    from grasp_any_region_tpu.models import gar as jg
    from grasp_any_region_tpu_torch.cli import runtime as trt

    root = tmp_path_factory.mktemp("bench")
    files = write_benchmark_files(str(root / "files"), seed=5,
                                  image_sizes=((150, 110), (120, 120)), n_vqa=3, n_detailed=3,
                                  n_dlc=3, n_ferret=3, n_mdvp=3)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("grasp_any_region_tpu.core.cache.enable_compilation_cache",
                   lambda *a, **k: None)
        mp.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                   lambda *a, **k: None)
        mp.setattr("grasp_any_region_tpu_torch.data.native.resize_bicubic_native",
                   port_numpy_resize)
        jmod = sys.modules["grasp_any_region_tpu.models.generate"]
        toks = {"jax": [], "torch": []}
        mp.setattr(jmod, "gar_prefill",
                   functools.partial(jg.gar_prefill, compute_dtype=jnp.float32))
        mp.setattr(jmod, "gar_decode_step",
                   functools.partial(jg.gar_decode_step, compute_dtype=jnp.float32))
        jgen = jax.jit(jmod.generate.__wrapped__,
                       static_argnames=("cfg", "max_new_tokens", "eot_id", "temperature"))

        def jax_generate(*a, **k):
            out = jgen(*a, **k)
            toks["jax"].append(np.asarray(out.tokens))
            return out

        real = trt.generate

        def port_generate(*a, **k):
            out = real(*a, **k)
            toks["torch"].append(out.tokens.numpy())
            return out

        mp.setattr(jmod, "generate", jax_generate)
        mp.setattr(trt, "generate", port_generate)
        rts = {"jax": jrt.GARRuntime.load(ckpt), "torch": _fp32_runtime(ckpt)}
        engines = {"jax": jengine, "torch": tengine}
        for task in TASKS:
            for side in ("jax", "torch"):
                cap = engines[side].BatchedCaptioner(rts[side], batch_size=BATCH,
                                                     max_new_tokens=NEW)
                n0 = len(toks[side])
                out = str(root / side / f"{task}.json")
                res = _run_task(side, task, cap, files, out)
                with open(out) as f:
                    runs[(side, task)] = dict(json=json.load(f), result=res,
                                              tokens=toks[side][n0:], cap=cap)
    return runs


@pytest.mark.parametrize("task", TASKS)
def test_loader_output_equals_jax(loader_runs, task):
    j, t = loader_runs[("jax", task)], loader_runs[("torch", task)]
    assert t["json"] == j["json"]
    assert json.dumps(t["result"], sort_keys=True) == json.dumps(j["result"], sort_keys=True)
    assert len(t["tokens"]) == len(j["tokens"]) == 2  # 3 items in batches of 2: one padded
    for a, b in zip(t["tokens"], j["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert any(len(set(a[0].tolist())) > 1 for a in t["tokens"])
    cap = t["cap"]
    assert [b["items"] for b in cap.batches] == [2, 1] and [b["pad"] for b in cap.batches] == [0, 1]
    assert cap.timer.summary()["answer"]["count"] == 2
    records = t["json"] if isinstance(t["json"], list) else list(t["json"].values())
    assert len(records) == 3


def test_vqa_output_scores_as_jax(loader_runs):
    items = loader_runs[("torch", "garbench-vqa")]["json"]
    assert {"model_output", "answer", "type", "mask_rles"} <= set(items[0])
    assert tgb.score_vqa(items) == jgb.score_vqa(loader_runs[("jax", "garbench-vqa")]["json"])


# ---------------------------------------------------------------------------
# BatchedCaptioner's padding
# ---------------------------------------------------------------------------

class _Res:
    steps = 3


class _PortRT:
    """`GARRuntime.batch` / `answer` stand-ins: a batch is its chunk."""

    def __init__(self):
        self.chunks = []

    def batch(self, chunk):
        return chunk, [0] * len(chunk)

    def answer(self, batch, plens, max_new_tokens):
        self.chunks.append(list(batch))
        return [f"t{x}<|eot_id|>" for x in batch], _Res()


class _JaxRT:
    def __init__(self):
        self.chunks = []

    def caption(self, chunk, max_new_tokens):
        self.chunks.append(list(chunk))
        return [f"t{x}<|eot_id|>" for x in chunk]


@pytest.mark.parametrize("n,bs", [(3, 8), (8, 8), (9, 8), (17, 8), (5, 2), (1, 1)])
def test_batched_captioner_pads_as_jax(n, bs):
    items = list(range(n))
    prt, jrt = _PortRT(), _JaxRT()
    got = tengine.BatchedCaptioner(prt, batch_size=bs, max_new_tokens=4).run(items)
    want = jengine.BatchedCaptioner(jrt, batch_size=bs, max_new_tokens=4).run(items)
    assert got == want == [f"t{i}<|eot_id|>" for i in items]
    assert prt.chunks == jrt.chunks
    assert all(len(c) == min(bs, n) for c in prt.chunks)


def test_write_outputs_and_load_cache(tmp_path):
    items = [{"a": "é", "b": [1, 2]}]
    tengine.write_outputs(str(tmp_path / "t" / "x.json"), items)
    jengine.write_outputs(str(tmp_path / "j" / "x.json"), items)
    assert (tmp_path / "t" / "x.json").read_bytes() == (tmp_path / "j" / "x.json").read_bytes()
    assert tengine.load_cache(str(tmp_path / "t" / "x.json")) == items
    assert tengine.load_cache(str(tmp_path / "none.json")) is None


# ---------------------------------------------------------------------------
# the judge subcommands on a stub judge
# ---------------------------------------------------------------------------

def _image_of(part) -> np.ndarray:
    url = part["image_url"]["url"]
    assert url.startswith("data:image/jpeg;base64,")
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1]))))


def _assert_same_messages(got, want):
    """The same roles and texts; image parts decode to the same pixels (the
    PNG bytes differ: the port writes them without PIL)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["role"] == w["role"]
        gc, wc = g["content"], w["content"]
        assert [p["type"] for p in gc] == [p["type"] for p in wc]
        for gp, wp in zip(gc, wc):
            if gp["type"] == "text":
                assert gp["text"] == wp["text"]
            else:
                np.testing.assert_array_equal(_image_of(gp), _image_of(wp))


class StubClient:
    """JudgeClient's stand-in: a verdict drawn from the prompt, and every
    message kept."""

    log = []

    def __init__(self, cfg):
        self.cfg = cfg

    def chat(self, messages):
        StubClient.log.append(messages)
        text = messages[0]["content"][-1]["text"]
        if "[System]" in text:
            return f"{7 + len(text) % 3}, {5 + len(text) % 4}\nreview"
        if "True" in text:
            return "True" if len(text) % 2 else "False"
        return "AB"[len(text) % 2]


def _judge_inputs(tmp_path, loader_runs):
    """The judges' input files in the layout each subcommand reads, from
    the port's loader outputs and the synthetic benchmark files."""
    files = write_benchmark_files(str(tmp_path / "files"), seed=5,
                                  image_sizes=((150, 110), (120, 120)), n_vqa=3, n_detailed=3,
                                  n_dlc=3, n_ferret=3, n_mdvp=3)
    ins = {"files": files}
    for task, name in (("garbench-simple", "simple"), ("garbench-detailed", "detailed"),
                       ("mdvp", "mdvp"), ("ferret", "ferret"), ("dlc", "dlc")):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(loader_runs[("torch", task)]["json"]))
        ins[name] = str(p)
    preds = json.loads(open(ins["dlc"]).read())
    qa = {k: [{"question": f"Is it {k}?", "type": "positive",
               "choices": [["yes", 1.0], ["no", -1.0]]},
              {"question": "Is it red?", "type": "negative",
               "choices": [["says red", -1.0], ["does not say", 1.0]]}] for k in preds}
    (tmp_path / "qa.json").write_text(json.dumps(qa))
    (tmp_path / "class_names.json").write_text(json.dumps({k: "patch" for k in preds}))
    ins["qa"], ins["class_names"] = str(tmp_path / "qa.json"), str(tmp_path / "class_names.json")
    ins["ferret_gpt4"] = _ferret_bundle(tmp_path)
    ins["mdvp_phase"] = _mdvp_phase_dir(tmp_path)
    return ins


JUDGE_TASKS = ["judge-simple", "judge-detailed", "judge-dlc", "judge-dlc-text",
               "judge-ferret", "judge-mdvp", "judge-mdvp-phase"]


@pytest.mark.parametrize("task", JUDGE_TASKS)
def test_judge_subcommand_records_equal_jax(tmp_path, loader_runs, monkeypatch, task):
    """Each judge subcommand of `cli.eval` on the stub judge writes JAX's
    records and sends JAX's messages; a second run resumes from the cache
    and sends none."""
    ins = _judge_inputs(tmp_path, loader_runs)
    for mod in (jgj, jdj, jpj, tgj, tdj, tpj):
        monkeypatch.setattr(mod, "JudgeClient", StubClient)
    outs, logs = {}, {}
    for side, main in (("jax", jeval.main), ("torch", teval.main)):
        d = tmp_path / side
        d.mkdir()
        StubClient.log = []
        if task in ("judge-simple", "judge-detailed"):
            pred = d / "pred.json"
            pred.write_text(open(ins[task.split("-")[1]]).read())
            argv = [task, "--pred", str(pred), "--images", ins["files"]["images"]]
            out = str(pred).replace(".json", "_eval.json")
        elif task.startswith("judge-dlc"):
            pred = d / "pred.json"
            pred.write_text(open(ins["dlc"]).read())
            argv = ["judge-dlc", "--pred", str(pred), "--anno", ins["files"]["dlc"],
                    "--qa", ins["qa"], "--class-names", ins["class_names"],
                    "--images", ins["files"]["dlc_root"]]
            if task == "judge-dlc-text":
                argv.append("--text-only-judge")
            out = str(pred).replace(".json", "_eval.json")
        elif task == "judge-ferret":
            out = str(d / "review.jsonl")
            argv = [task, "--pred", ins["ferret"], "--anno", ins["ferret_gpt4"], "--out", out]
        else:
            out = str(d / "review.jsonl")
            src = ["--pred", ins["mdvp"]] if task == "judge-mdvp" else ["--anno", ins["mdvp_phase"]]
            argv = ["judge-mdvp", *src, "--images", ins["files"]["images"], "--out", out]
        main(argv)
        logs[side] = StubClient.log
        with open(out) as f:
            outs[side] = f.read() if out.endswith(".jsonl") else json.load(f)
        StubClient.log = []
        main(argv)  # resumes: every item is in the cache
        assert StubClient.log == [], side
    if isinstance(outs["torch"], str):
        assert [json.loads(x) for x in outs["torch"].splitlines()] == \
            [json.loads(x) for x in outs["jax"].splitlines()]
    else:
        assert outs["torch"] == outs["jax"]
    assert len(logs["torch"]) == len(logs["jax"]) > 0
    for got, want in zip(logs["torch"], logs["jax"]):
        _assert_same_messages(got, want)


# ---------------------------------------------------------------------------
# JudgeClient against a stub judge service on the loopback
# ---------------------------------------------------------------------------

class _Judge(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802
        srv = self.server
        body = self.rfile.read(int(self.headers["Content-Length"]))
        srv.requests.append({"path": self.path, "body": body,
                             "headers": {k.lower(): v for k, v in self.headers.items()}})
        if srv.fail_next > 0:
            srv.fail_next -= 1
            self.send_response(500)
            self.end_headers()
            return
        out = json.dumps({"choices": [{"message": {"content": f"reply {len(srv.requests)}"}}]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(out.encode())

    def log_message(self, *a):
        pass


@pytest.fixture
def judge_service():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Judge)
    srv.requests, srv.fail_next = [], 0
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


MESSAGES = [{"role": "user", "content": [{"type": "text", "text": "Is it red? é"},
                                         {"type": "image_url",
                                          "image_url": {"url": "data:image/jpeg;base64,AAAA"}}]}]


def test_judge_client_request_equals_jax(judge_service, monkeypatch):
    url = f"http://127.0.0.1:{judge_service.server_address[1]}/v1/chat/completions"
    for side, mod in (("jax", jclient), ("torch", tclient)):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        c = mod.JudgeClient(mod.JudgeConfig(endpoint=url, api_key="k1", max_tokens=77))
        assert c.chat(MESSAGES).startswith("reply") and c.calls == 1
    jr, tr = judge_service.requests
    assert tr["body"] == jr["body"] and tr["path"] == jr["path"] == "/v1/chat/completions"
    for h in ("content-type", "api-key", "authorization"):
        assert tr["headers"][h] == jr["headers"][h]
    assert json.loads(tr["body"])["max_tokens"] == 77


@pytest.mark.parametrize("fails,retries", [(2, 4), (3, 3)])
def test_judge_client_retries_and_budget_stop_where_jax_does(judge_service, monkeypatch,
                                                             fails, retries):
    url = f"http://127.0.0.1:{judge_service.server_address[1]}/chat/completions"
    seen = {}
    for side, mod in (("jax", jclient), ("torch", tclient)):
        sleeps = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        judge_service.requests.clear()
        judge_service.fail_next = fails
        c = mod.JudgeClient(mod.JudgeConfig(endpoint=url, max_retries=retries, call_budget=2))
        try:
            first = c.chat(MESSAGES)
        except RuntimeError as e:
            first = f"error: {str(e).split(':')[0]}"
        tail = []
        for _ in range(2):
            try:
                tail.append(c.chat(MESSAGES))
            except RuntimeError as e:
                tail.append(f"error: {e}")
        seen[side] = (first, tail, len(judge_service.requests), sleeps, c.calls)
    assert seen["torch"] == seen["jax"]
    first, tail, n, sleeps, calls = seen["torch"]
    if fails < retries:
        assert first.startswith("reply") and sleeps == [1, 2][:fails]
        assert tail[-1] == "error: judge call budget 2 exhausted" and calls == 2
    else:
        assert first.startswith("error: judge request failed") and n == retries + 2


def test_judge_config_resolve_equals_jax(monkeypatch):
    for var in ("AZURE_OPENAI_ENDPOINT", "AZURE_OPENAI_KEY", "OPENAI_BASE_URL", "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no judge endpoint"):
        tclient.JudgeConfig().resolve()
    monkeypatch.setenv("OPENAI_BASE_URL", "http://127.0.0.1:9/v1/")
    assert tclient.JudgeConfig().resolve().__dict__ == jclient.JudgeConfig().resolve().__dict__
    monkeypatch.setenv("AZURE_OPENAI_ENDPOINT", "https://x.example/")
    monkeypatch.setenv("AZURE_OPENAI_KEY", "secret")
    got = tclient.JudgeConfig(model="m").resolve()
    assert got.__dict__ == jclient.JudgeConfig(model="m").resolve().__dict__
    assert got.endpoint.endswith("/openai/deployments/m/chat/completions?api-version="
                                 "2024-03-01-preview") and got.api_key == "secret"
