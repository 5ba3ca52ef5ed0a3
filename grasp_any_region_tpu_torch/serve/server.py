"""HTTP serving with the PyTorch package (`grasp_any_region_tpu/serve/server.py`):
the reference's gradio demo without gradio or FastAPI.

Endpoints (JAX's, with its status codes and JSON shapes):
  GET  /                        - the in-browser demo page (click points or
                                  drag a box on the image -> mask ->
                                  caption)
  POST /describe                - {image: b64 png/jpg, mask?: b64, points?:
                                  [[x,y],...], box?: [x1,y1,x2,y2],
                                  question?: str, max_new_tokens?: int,
                                  stream?: bool} -> {text}; stream=true sends
                                  the text in HTTP chunks
  POST /point_to_mask           - {image, points?, box?} -> {overlay: b64
                                  RGBA png, mask: b64 png, area}
  POST /image_to_sam_embedding  - {image: b64} -> {embedding: b64 fp32
                                  bytes, shape, dtype} for client-side
                                  decoding
  GET  /sam_decoder.onnx        - the server's SAM mask decoder in the
                                  official ONNX interface (sam/onnx_export.py),
                                  which the demo page runs with
                                  onnxruntime-web
  GET  /healthz                 - liveness and model info

Requests reach the card one at a time: `describe`, `point_to_mask` and
`sam_embedding` hold one lock around each model call (JAX's lock, which
`describe` here also holds around SAM; batching across clients is the
serving engine's job, serve/engine.py). The base64 -> image
decode (PIL) is `decode_image`, apart from `describe_array`, the body of
`describe` on arrays, which needs no PIL.

Run: python -m grasp_any_region_tpu_torch.serve.server --preset gar_1b --random-init
  [--sam-path /path/to/hf-sam] [--port 8000] [--device cpu]
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

INDEX_HTML = """<!doctype html>
<html><head><title>Grasp Any Region (TPU)</title>
<script src="https://cdn.jsdelivr.net/npm/onnxruntime-web@1.19.2/dist/ort.min.js"
        onerror="this.remove()"></script>
<style>body{font-family:sans-serif;max-width:900px;margin:2em auto}
#stage{position:relative;display:inline-block}
#stage img{max-width:100%;display:block}
#img{cursor:crosshair;border:1px solid #999}
#overlay{position:absolute;left:0;top:0;pointer-events:none;opacity:.85}
#out{white-space:pre-wrap;background:#f4f4f4;padding:1em;min-height:3em}
#status{color:#777;font-size:.9em}</style>
</head><body>
<h2>Grasp Any Region — TPU demo</h2>
<p>Upload an image, hover/click the object (mask preview appears), press
Describe — the caption streams in below. Shift-click adds refinement
points; <b>drag to draw a box prompt</b> (reference Stage.tsx parity).
When onnxruntime-web loads, masks decode <b>in the browser</b>
against the server's SAM embedding (reference frontend parity); otherwise
each click round-trips to the server.</p>
<input type="file" id="file" accept="image/*">
<button onclick="describe()">Describe</button>
<button onclick="clearPts()">Clear points</button>
<span id="status"></span>
<div id="stage"><img id="img" style="display:none">
<canvas id="overlay" style="display:none"></canvas></div>
<div id="out"></div>
<script>
let pts = [], box = null, b64 = null, sess = null, emb = null,
    maskCanvas = null, dragStart = null, dragging = false;
const img = document.getElementById('img');
img.draggable = false;
const overlay = document.getElementById('overlay');
const status = document.getElementById('status');
// ---- client-side ONNX decoding (demo/gradio/frontend parity) ----
async function initOnnx(){
  if (!window.ort) return;
  try { sess = await ort.InferenceSession.create('/sam_decoder.onnx'); }
  catch(e){ sess = null; }
}
initOnnx();
function b64f32(s){
  const bin = atob(s), u8 = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) u8[i] = bin.charCodeAt(i);
  return new Float32Array(u8.buffer);
}
async function fetchEmbedding(){
  emb = null;
  if (!sess) return;
  status.textContent = 'encoding image...';
  const r = await fetch('/image_to_sam_embedding', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({image: b64})});
  const j = await r.json();
  if (j.embedding) { emb = {data: b64f32(j.embedding), shape: j.shape};
                     status.textContent = 'in-browser decoding ready'; }
  else status.textContent = j.error || 'embedding failed';
}
let decoding = false;
async function decodeLocal(ptsList, boxArg){
  if (decoding) return null;          // drop hover events while busy
  decoding = true;
  try {
    const n = ptsList.length;
    const scale = 1024 / Math.max(img.naturalWidth, img.naturalHeight);
    // official feed layout (onnxModelAPI.tsx): clicks are label 1, a box
    // contributes its corners as labels 2 (TL) / 3 (BR), and the -1 pad
    // point is appended only when there is no box
    const total = n + (boxArg ? 2 : 1);
    const coords = new Float32Array(2 * total);
    const labels = new Float32Array(total);
    ptsList.forEach((p, i) => { coords[2*i] = p[0] * scale;
      coords[2*i+1] = p[1] * scale; labels[i] = 1; });
    if (boxArg) {
      coords[2*n] = boxArg[0] * scale; coords[2*n+1] = boxArg[1] * scale;
      coords[2*n+2] = boxArg[2] * scale; coords[2*n+3] = boxArg[3] * scale;
      labels[n] = 2; labels[n+1] = 3;
    } else { labels[n] = -1; }        // pad point
    const out = await sess.run({
      image_embeddings: new ort.Tensor('float32', emb.data, emb.shape),
      point_coords: new ort.Tensor('float32', coords, [1, total, 2]),
      point_labels: new ort.Tensor('float32', labels, [1, total]),
      mask_input: new ort.Tensor('float32', new Float32Array(256*256),
                                 [1, 1, 256, 256]),
      has_mask_input: new ort.Tensor('float32', new Float32Array(1), [1]),
      orig_im_size: new ort.Tensor('float32', Float32Array.from(
        [img.naturalHeight, img.naturalWidth]), [2]),
    });
    return out.masks;                 // (1, 1, H, W) logits
  } finally { decoding = false; }
}
function paintMask(masks){
  const h = masks.dims[2], w = masks.dims[3], d = masks.data;
  overlay.width = w; overlay.height = h;
  overlay.style.display = 'block';
  overlay.style.width = img.clientWidth + 'px';
  overlay.style.height = img.clientHeight + 'px';
  const ctx = overlay.getContext('2d');
  const id = ctx.createImageData(w, h);
  maskCanvas = document.createElement('canvas');
  maskCanvas.width = w; maskCanvas.height = h;
  const mctx = maskCanvas.getContext('2d');
  const mid = mctx.createImageData(w, h);
  let area = 0;
  for (let i = 0; i < w * h; i++) {
    if (d[i] > 0) { area++;
      id.data[4*i] = 255; id.data[4*i+3] = 110;
      mid.data[4*i] = mid.data[4*i+1] = mid.data[4*i+2] = 255;
      mid.data[4*i+3] = 255;
    } else { mid.data[4*i+3] = 255; }
  }
  ctx.putImageData(id, 0, 0);
  mctx.putImageData(mid, 0, 0);
  return area;
}
// ---- UI ----
document.getElementById('file').onchange = e => {
  const r = new FileReader();
  r.onload = () => { b64 = r.result.split(',')[1]; img.src = r.result;
                     img.style.display = 'block'; clearPts();
                     fetchEmbedding(); };
  r.readAsDataURL(e.target.files[0]);
};
function clearPts(){ pts = []; box = null; dragStart = null;
                     dragging = false; maskCanvas = null;
                     overlay.style.display = 'none';
                     status.textContent = ''; }
function imgXY(e){
  const rect = img.getBoundingClientRect();
  return [(e.clientX - rect.left) * img.naturalWidth / rect.width,
          (e.clientY - rect.top) * img.naturalHeight / rect.height];
}
function drawBoxOutline(){
  if (!box) return;
  if (overlay.style.display === 'none') {
    overlay.width = img.naturalWidth; overlay.height = img.naturalHeight;
    overlay.style.display = 'block';
    overlay.style.width = img.clientWidth + 'px';
    overlay.style.height = img.clientHeight + 'px';
  }
  const ctx = overlay.getContext('2d');
  ctx.strokeStyle = '#1e90ff'; ctx.lineWidth = 3;
  ctx.strokeRect(box[0], box[1], box[2] - box[0], box[3] - box[1]);
}
async function refreshMask(){
  if (sess && emb) {
    const m = await decodeLocal(pts, box);
    if (m) { status.textContent = 'mask: ' + paintMask(m) + ' px (browser)';
             drawBoxOutline(); }
    return;
  }
  status.textContent = 'decoding mask...';
  const req = {image: b64};
  if (pts.length) req.points = pts;
  if (box) req.box = box;
  const resp = await fetch('/point_to_mask', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(req)});
  const j = await resp.json();
  if (j.overlay) {
    const im = new Image();
    im.onload = () => { overlay.width = im.width; overlay.height = im.height;
      overlay.getContext('2d').drawImage(im, 0, 0);
      overlay.style.display = 'block';
      overlay.style.width = img.clientWidth + 'px';
      overlay.style.height = img.clientHeight + 'px';
      drawBoxOutline(); };
    im.src = 'data:image/png;base64,' + j.overlay;
    status.textContent = 'mask: ' + j.area + ' px';
  } else { status.textContent = j.error || 'no mask'; }
}
img.onmousedown = e => { dragStart = imgXY(e); dragging = false;
                         e.preventDefault(); };
window.addEventListener('mouseup', e => {
  // releasing outside the image cancels the drag (img.onmouseup never
  // fires there; without this, later motion is misread as an in-progress
  // drag and draws a ghost rubber-band)
  if (dragStart && e.target !== img) { dragStart = null; dragging = false; }
});
img.onmousemove = async e => {
  if (dragStart) {                   // drag = box prompt (Stage.tsx parity)
    const xy = imgXY(e);
    if (Math.abs(xy[0] - dragStart[0]) + Math.abs(xy[1] - dragStart[1]) > 8)
      dragging = true;
    if (dragging) {                  // live rectangle preview
      if (overlay.style.display === 'none' || !maskCanvas) {
        overlay.width = img.naturalWidth; overlay.height = img.naturalHeight;
        overlay.style.display = 'block';
        overlay.style.width = img.clientWidth + 'px';
        overlay.style.height = img.clientHeight + 'px';
      }
      const ctx = overlay.getContext('2d');
      ctx.clearRect(0, 0, overlay.width, overlay.height);
      ctx.strokeStyle = '#1e90ff'; ctx.lineWidth = 3;
      ctx.strokeRect(Math.min(dragStart[0], xy[0]), Math.min(dragStart[1], xy[1]),
                     Math.abs(xy[0] - dragStart[0]), Math.abs(xy[1] - dragStart[1]));
    }
    return;
  }
  if (!sess || !emb || pts.length || box) return;  // hover preview
  const m = await decodeLocal([imgXY(e)], null);
  if (m) paintMask(m);
};
img.onmouseup = async e => {
  const xy = imgXY(e);
  if (dragging) {                    // finish box
    box = [Math.min(dragStart[0], xy[0]), Math.min(dragStart[1], xy[1]),
           Math.max(dragStart[0], xy[0]), Math.max(dragStart[1], xy[1])];
    if (!e.shiftKey) pts = [];       // plain drag replaces the prompt set
    dragStart = null; dragging = false;
    await refreshMask();
    return;
  }
  dragStart = null;
  if (!e.shiftKey) { pts = []; box = null; }
  pts.push(xy);
  await refreshMask();
};
async function describe(){
  if (!b64 || (!pts.length && !box)) {
    alert('image + a point or box prompt'); return; }
  const out = document.getElementById('out');
  out.textContent = '';
  const req = {image: b64, stream: true};
  if (maskCanvas) req.mask = maskCanvas.toDataURL('image/png').split(',')[1];
  else { if (pts.length) req.points = pts; if (box) req.box = box; }
  const resp = await fetch('/describe', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(req)});
  if (!resp.ok) { out.textContent = await resp.text(); return; }
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    out.textContent += dec.decode(value);
  }
}
</script></body></html>"""

def decode_image(b64: str, mode: str = "RGB") -> np.ndarray:
    """A base64 PNG / JPEG as an (H, W, 3) uint8 array ("L": (H, W)); PIL."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert(mode))


def decode_mask(b64: str) -> np.ndarray:
    """A base64 mask image as a binary (H, W) uint8 mask (> 127)."""
    return (decode_image(b64, "L") > 127).astype(np.uint8)


def png_b64(arr: np.ndarray, mode: str) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class GARServer:
    def __init__(self, runtime, sam_predictor, max_new_tokens: int = 1024):
        self.rt = runtime
        self.sam = sam_predictor
        self.max_new_tokens = max_new_tokens
        self.lock = threading.Lock()
        self._decoder_onnx: Optional[bytes] = None

    def decoder_onnx(self) -> Optional[bytes]:
        """The SAM mask decoder in the official ONNX interface, exported
        once (on the CPU) from the server's own SAM weights, so the browser
        decodes masks against /image_to_sam_embedding embeddings (under the
        request lock, so requests that arrive together export once); None
        without SAM weights."""
        if not self.sam.has_model:
            return None
        with self.lock:
            if self._decoder_onnx is None:
                from ..sam.onnx_export import mask_decoder_onnx_bytes

                self._decoder_onnx = mask_decoder_onnx_bytes(self.sam.params, self.sam.cfg)
        return self._decoder_onnx

    # ---- handlers -----------------------------------------------------------

    def describe(self, req: dict) -> dict:
        img = decode_image(req["image"])
        mask = decode_mask(req["mask"]) if req.get("mask") else None
        return self.describe_array(img, req, mask)

    def describe_array(self, img: np.ndarray, req: dict,
                       mask: Optional[np.ndarray] = None) -> dict:
        """`describe` on an (H, W, 3) uint8 image: the given binary mask, or
        SAM's from req's points / box; then the region's caption."""
        from ..data.builders import RegionSample

        if mask is None:
            points = req.get("points")
            box = req.get("box")
            with self.lock:
                mask = self.sam.predict(
                    img,
                    points=[tuple(p) for p in points] if points else None,
                    point_labels=[1] * len(points) if points else None,
                    box=tuple(box) if box else None,
                )
        if mask.sum() == 0:
            return {"error": "empty mask from prompt"}
        sample = RegionSample(
            image=img, masks={1: mask},
            instruction=req.get("question", "Describe this masked region in detail."),
        )
        with self.lock:
            text = self.rt.caption(
                [sample], max_new_tokens=int(req.get("max_new_tokens", self.max_new_tokens))
            )[0]
        return {"text": text}

    def point_to_mask(self, req: dict) -> dict:
        """Interactive mask preview: {image, points?, box?} -> an RGBA
        overlay PNG and the mask PNG. The SAM image embedding is cached
        (`SamPredictor._embedding`), so more clicks on the same image skip
        the encoder."""
        from ..sam.pipeline import mask_contours

        img = decode_image(req["image"])
        points = req.get("points")
        box = req.get("box")
        with self.lock:
            mask = self.sam.predict(
                img,
                points=[tuple(p) for p in points] if points else None,
                point_labels=[1] * len(points) if points else None,
                box=tuple(box) if box else None,
            )
        area = int(mask.sum())
        if area == 0:
            return {"error": "empty mask from prompt"}
        h, w = mask.shape
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., 0] = 255  # red fill
        rgba[..., 3] = mask * 110  # transparent off-mask
        edge = mask_contours(mask).astype(bool)
        rgba[edge] = (255, 40, 40, 255)
        return {
            "overlay": png_b64(rgba, "RGBA"),
            "mask": png_b64(mask * 255, "L"),
            "area": area,
        }

    def sam_embedding(self, req: dict) -> dict:
        if not self.sam.has_model:
            return {"error": "SAM weights not loaded on this server"}
        from ..sam.model import encode_image
        from ..sam.pipeline import preprocess_sam

        img = decode_image(req["image"])
        pix, _, _ = preprocess_sam(img, self.sam.cfg.img_size)
        with self.lock, torch.inference_mode():
            pixels = torch.from_numpy(pix).to(self.sam.device)
            emb = encode_image(self.sam.params, self.sam.cfg, pixels).float().cpu().numpy()
        return {
            "embedding": base64.b64encode(emb.tobytes()).decode(),
            "shape": list(emb.shape),
            "dtype": "float32",
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "model": type(self.rt.cfg).__name__,
            "text_layers": self.rt.cfg.text.num_layers,
            "sam": self.sam.has_model,
        }

    # ---- plumbing -----------------------------------------------------------

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, server_self.health())
                elif self.path in ("/", "/index.html"):
                    body = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/sam_decoder.onnx":
                    try:
                        data = server_self.decoder_onnx()
                    except Exception as e:  # noqa: BLE001
                        self._json(500, {"error": str(e)})
                        return
                    if data is None:
                        self._json(503, {"error": "SAM weights not loaded"})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json(404, {"error": "not found"})

            def _stream_text(self, text: str, chunk: int = 24):
                """Chunked pseudo-streaming (the reference's char loop,
                demo/gradio/app.py:108-156, over HTTP chunked encoding)."""
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                data = text.encode()
                for i in range(0, len(data), chunk):
                    piece = data[i : i + chunk]
                    self.wfile.write(f"{len(piece):x}\r\n".encode())
                    self.wfile.write(piece + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid json"})
                    return
                try:
                    if self.path == "/describe":
                        out = server_self.describe(req)
                        if req.get("stream") and "text" in out:
                            self._stream_text(out["text"])
                            return
                    elif self.path == "/point_to_mask":
                        out = server_self.point_to_mask(req)
                    elif self.path == "/image_to_sam_embedding":
                        out = server_self.sam_embedding(req)
                    else:
                        self._json(404, {"error": "not found"})
                        return
                except KeyError as e:
                    self._json(400, {"error": f"missing field {e}"})
                    return
                except Exception as e:  # noqa: BLE001
                    self._json(500, {"error": str(e)})
                    return
                self._json(200 if "error" not in out else 422, out)

            def log_message(self, fmt, *args):  # quiet
                pass

        return Handler

    def serve(self, host: str = "0.0.0.0", port: int = 8000):
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"[serve] listening on http://{host}:{port}")
        httpd.serve_forever()


def main(argv=None):
    import argparse

    from ..cli.runtime import GARRuntime
    from ..sam.pipeline import SamPredictor

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default=None)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--sam-path", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--int8-serving", action="store_true",
                   help="serving-only int8 decoder weights (no resident bf16 copies); "
                        "quality against bf16 unvalidated on real checkpoints")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init,
                         int8_serving=args.int8_serving, device=args.device)
    sam = SamPredictor.load(args.sam_path, device=args.device)
    GARServer(rt, sam).serve(args.host, args.port)


if __name__ == "__main__":
    main()
