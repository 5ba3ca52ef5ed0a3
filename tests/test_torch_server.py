"""The PyTorch port's HTTP demo server (`serve/server.py`) over real HTTP
on a free localhost port, on the CPU, case for case JAX's
tests/test_server.py, and the engine CLI (`cli/gar_serve.py`) as JAX's
tests/test_serving_cli.py runs it.

The runtime is gar_tiny (bf16, random init, the decoder's projections
scaled by 10 so greedy decoding does not repeat one token). One server has
no SAM weights (the geometric stand-in, as JAX's fixture), one the small
SAM of tests/test_torch_sam.py. Every caption is held to
`GARRuntime.caption` on the same sample.
"""

import base64
import io
import json
import re
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
from grasp_any_region_tpu_torch.data.builders import RegionSample
from grasp_any_region_tpu_torch.sam import model as tm
from grasp_any_region_tpu_torch.sam.pipeline import SamPredictor
from grasp_any_region_tpu_torch.serve.server import GARServer

SAM_CFG = tm.SAMConfig(img_size=256, patch_size=16, embed_dim=64, depth=2, num_heads=2,
                       window_size=14, global_attn_indexes=(1,), out_chans=64,
                       decoder_mlp_dim=128)
NEW = 4


def runtime():
    rt = GARRuntime.load(None, "gar_tiny", random_init=True, device="cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(rt.params.llm.blocks, name).mul_(10.0)
    return rt


def start(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served():
    srv = GARServer(runtime(), SamPredictor(), max_new_tokens=NEW)
    httpd, url = start(srv)
    yield srv, url
    httpd.shutdown()


@pytest.fixture(scope="module")
def served_sam():
    params = tm.init_sam_params(SAM_CFG, torch.Generator().manual_seed(0), device="cpu")
    srv = GARServer(runtime(), SamPredictor(params=params, cfg=SAM_CFG), max_new_tokens=NEW)
    httpd, url = start(srv)
    yield srv, url
    httpd.shutdown()


def post(url, payload, raw=None):
    req = urllib.request.Request(url, raw if raw is not None else json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def png(array) -> str:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def image(seed=0, h=120, w=160):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def caption(srv, img, mask, question="Describe this masked region in detail."):
    return srv.rt.caption([RegionSample(img, {1: mask}, instruction=question)],
                          max_new_tokens=NEW)[0]


def test_healthz_and_index(served):
    _, url = served
    code, _, body = get(url + "/healthz")
    health = json.loads(body)
    assert code == 200 and health == {"status": "ok", "model": "GARConfig", "text_layers": 2,
                                      "sam": False}
    code, headers, page = get(url + "/")
    assert code == 200 and headers["Content-Type"] == "text/html"
    assert "Grasp Any Region" in page.decode() and "/describe" in page.decode()


def test_index_page_wires_client_side_decode(served):
    from grasp_any_region_tpu.serve.server import INDEX_HTML

    _, url = served
    page = get(url + "/index.html")[2].decode()
    assert page == INDEX_HTML
    for needle in ("/sam_decoder.onnx", "image_to_sam_embedding", "onnxruntime-web",
                   "InferenceSession", "onmousemove"):
        assert needle in page


@pytest.mark.parametrize("prompt", ["points", "box"])
def test_describe_with_a_prompt(served, prompt):
    srv, url = served
    img = image(1)
    req = {"points": [[80, 60]]} if prompt == "points" else {"box": [30, 20, 120, 100]}
    code, out = post(url + "/describe", {"image": png(img), "max_new_tokens": NEW, **req})
    assert code == 200, out
    mask = srv.sam.predict(img, points=[(80, 60)], point_labels=[1]) if prompt == "points" \
        else srv.sam.predict(img, box=(30, 20, 120, 100))
    assert out == {"text": caption(srv, img, mask)}


def test_describe_with_mask(served):
    srv, url = served
    img = image(2)
    mask = np.zeros((120, 160), np.uint8)
    mask[30:90, 40:120] = 255
    code, out = post(url + "/describe", {"image": png(img), "mask": png(mask),
                                         "question": "What is it?", "max_new_tokens": NEW})
    assert code == 200, out
    assert out["text"] == caption(srv, img, (mask > 127).astype(np.uint8), "What is it?")
    # describe's body on arrays, with no image decode
    assert srv.describe_array(img, {"question": "What is it?"},
                              (mask > 127).astype(np.uint8)) == out


def test_describe_streaming(served):
    srv, url = served
    img = image(3)
    req = urllib.request.Request(
        url + "/describe",
        json.dumps({"image": png(img), "points": [[80, 60]], "max_new_tokens": NEW,
                    "stream": True}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        assert r.headers["Transfer-Encoding"] == "chunked"
        text = r.read().decode()
    assert text == caption(srv, img, srv.sam.predict(img, points=[(80, 60)], point_labels=[1]))


@pytest.mark.parametrize("case", ["missing_field", "bad_json", "empty_mask", "unknown_post",
                                  "unknown_get", "embedding_without_sam"])
def test_error_paths(served, case):
    _, url = served
    if case == "missing_field":
        code, out = post(url + "/describe", {"points": [[1, 2]]})
        assert code == 400 and "image" in out["error"]
    elif case == "bad_json":
        code, out = post(url + "/describe", None, raw=b"{bad")
        assert code == 400 and out == {"error": "invalid json"}
    elif case == "empty_mask":
        code, out = post(url + "/describe", {"image": png(image(4)),
                                             "mask": png(np.zeros((120, 160), np.uint8))})
        assert code == 422 and out == {"error": "empty mask from prompt"}
    elif case == "unknown_post":
        code, out = post(url + "/nope", {})
        assert code == 404 and out == {"error": "not found"}
    elif case == "unknown_get":
        code, _, body = get(url + "/nope")
        assert code == 404 and json.loads(body) == {"error": "not found"}
    else:
        code, out = post(url + "/image_to_sam_embedding", {"image": png(image(5))})
        assert code == 422 and "SAM" in out["error"]


def test_point_to_mask_overlay(served):
    _, url = served
    code, out = post(url + "/point_to_mask", {"image": png(image(6)), "points": [[80, 60]]})
    assert code == 200, out
    assert out["area"] > 0
    overlay = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["overlay"]))))
    assert overlay.shape == (120, 160, 4)
    assert overlay[..., 3].max() == 255 and overlay[..., 3].min() == 0
    mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["mask"]))))
    assert mask.shape == (120, 160) and set(np.unique(mask)) <= {0, 255}
    assert mask[60, 80] == 255 and mask[0, 0] == 0  # the stand-in's disk around the click
    assert out["area"] == int((mask > 0).sum())


def test_sam_decoder_onnx_without_weights(served):
    _, url = served
    code, _, body = get(url + "/sam_decoder.onnx")
    assert code == 503 and "SAM" in json.loads(body)["error"]


def test_sam_decoder_onnx_served_with_model(served_sam):
    srv, url = served_sam
    code, headers, data = get(url + "/sam_decoder.onnx")
    assert code == 200 and headers["Content-Type"] == "application/octet-stream"
    assert len(data) > 10_000
    for name in (b"image_embeddings", b"point_coords", b"point_labels", b"mask_input",
                 b"has_mask_input", b"orig_im_size"):
        assert name in data
    assert srv.decoder_onnx() is srv.decoder_onnx()  # built once
    assert json.loads(get(url + "/healthz")[2])["sam"] is True


def test_sam_embedding_with_model(served_sam):
    from grasp_any_region_tpu_torch.sam.pipeline import preprocess_sam

    srv, url = served_sam
    img = image(7, 100, 180)
    code, out = post(url + "/image_to_sam_embedding", {"image": png(img)})
    assert code == 200 and out["shape"] == [1, 64, 16, 16] and out["dtype"] == "float32"
    emb = np.frombuffer(base64.b64decode(out["embedding"]), np.float32).reshape(out["shape"])
    pix, _, _ = preprocess_sam(img, 256)
    want = tm.encode_image(srv.sam.params, SAM_CFG, torch.from_numpy(pix)).numpy()
    np.testing.assert_array_equal(emb, want)


@pytest.mark.parametrize("prompt", ["points", "box"])
def test_sam_model_masks_through_the_server(served_sam, prompt):
    srv, url = served_sam
    img = image(8)
    req = {"points": [[70, 50], [90, 70]]} if prompt == "points" else {"box": [20, 10, 130, 100]}
    kw = dict(points=[(70, 50), (90, 70)], point_labels=[1, 1]) if prompt == "points" \
        else dict(box=(20, 10, 130, 100))
    want = srv.sam.predict(img, **kw)
    code, out = post(url + "/point_to_mask", {"image": png(img), **req})
    if want.sum() == 0:
        assert code == 422
    else:
        mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["mask"]))))
        np.testing.assert_array_equal(mask, want * 255)
    code, out = post(url + "/describe", {"image": png(img), "max_new_tokens": NEW, **req})
    if want.sum() == 0:
        assert code == 422 and out == {"error": "empty mask from prompt"}
    else:
        assert code == 200 and out["text"] == caption(srv, img, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_server_main_flags(monkeypatch, int8):
    """`main` loads the runtime on --device (int8-serving: no bf16 decoder
    matmuls left in the tree) and the predictor before the HTTP loop."""
    from grasp_any_region_tpu_torch.serve import server as srv

    captured = {}

    class FakeServer:
        def __init__(self, rt, sam):
            captured["rt"], captured["sam"] = rt, sam

        def serve(self, host, port):
            captured["served"] = (host, port)

    monkeypatch.setattr(srv, "GARServer", FakeServer)
    srv.main(["--preset", "gar_tiny", "--random-init", "--port", "0", "--device", "cpu"]
             + (["--int8-serving"] if int8 else []))
    names = {n for n, _ in captured["rt"].params.named_parameters()}
    assert ("llm.blocks.wq_q8" in names and "llm.blocks.wq" not in names) if int8 else \
        ("llm.blocks.wq" in names)
    assert captured["rt"].device == torch.device("cpu")
    assert not captured["sam"].has_model and captured["served"] == ("0.0.0.0", 0)


# ---------------------------------------------------------------------------
# the engine CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def image_and_mask(tmp_path):
    img = image(9, 96, 128)
    mask = np.zeros((96, 128), np.uint8)
    mask[20:70, 30:90] = 255
    ip, mp = tmp_path / "img.png", tmp_path / "mask.png"
    Image.fromarray(img).save(ip)
    Image.fromarray(mask).save(mp)
    return str(ip), str(mp)


@pytest.mark.parametrize("int8,page_size", [(False, 64), (True, 64), (False, 16)],
                         ids=["bf16", "int8_16_slots", "bf16_page_16"])
def test_gar_serve_cli(image_and_mask, capsys, int8, page_size):
    """bf16: 3 requests on 2 slots, each caption the runtime's. int8 (JAX's
    case): 18 requests on 16 slots, so an admission waits for a retire.
    Page size 16: the slots' pages are sized by the padded prompt (1664
    tokens here, past the true one), which the prefill writes."""
    from grasp_any_region_tpu_torch.cli import gar_serve
    from grasp_any_region_tpu_torch.cli.runtime import load_image, load_mask

    ip, mp = image_and_mask
    n, slots = (18, 16) if int8 else (3, 2)
    gar_serve.main(["--preset", "gar_tiny", "--random-init", "--device", "cpu",
                    "--image", ip, "--mask", mp, "--repeat", str(n), "--slots", str(slots),
                    "--max-new-tokens", "4", "--decode-chunk", "2", "--page-size", str(page_size)]
                   + (["--int8-serving"] if int8 else []))
    out = capsys.readouterr()
    assert out.out.count(" tok, t+") == n, out.out
    assert f"{n} caption(s)" in out.err and "requests/s" in out.err
    assert ("int8 serving-only weights" in out.err) == int8
    if not int8:
        rt = GARRuntime.load(None, "gar_tiny", True, device="cpu")
        text = rt.caption([RegionSample(load_image(ip), {1: load_mask(mp)})],
                          max_new_tokens=4)[0]
        parts = re.split(r"^=== .* \(request \d+, 4 tok, t\+[0-9.]+s\) ===\n", out.out,
                         flags=re.M)
        assert parts == [""] + [text + "\n"] * n


def test_gar_serve_cli_counts_its_inputs(image_and_mask, capsys):
    from grasp_any_region_tpu_torch.cli import gar_serve

    ip, mp = image_and_mask
    with pytest.raises(SystemExit) as info:
        gar_serve.main(["--device", "cpu", "--image", ip, "--image", ip, "--mask", mp])
    assert info.value.code == 2 and "--image given 2 times but --mask 1" in \
        capsys.readouterr().err
