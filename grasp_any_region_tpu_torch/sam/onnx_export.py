"""ONNX export of the SAM mask decoder (`grasp_any_region_tpu/sam/onnx_export.py`),
for decoding masks in the browser.

The reference's gradio frontend decodes masks client-side with
onnxruntime-web: per click it feeds `image_embeddings`, `point_coords`
(SAM-1024 space), `point_labels`, `orig_im_size`, `mask_input` and
`has_mask_input`, and renders the returned mask with no server round trip.
This module exports the port's mask decoder (sam/model.py `encode_points`
and `decode_masks`) to that interface (the official SamOnnxModel with
`return_single_mask=True`), so the same frontend runs against the port's
weights (`serve/server.py` serves it at `/sam_decoder.onnx`).

`build_torch_decoder` wraps the model's own `encode_points` and
`decode_masks` in an `nn.Module` that holds CPU fp32 copies of the "prompt"
and "decoder" parameters and adds only the interface (pixel coordinates,
the `has_mask_input` term, the single-mask choice, the crop and resize to
the original size). `_export_onnx_bytes` serializes it with torch's
TorchScript exporter on the CPU. That exporter imports the `onnx` package
for one pass only, `_add_onnxscript_fn`, which splices onnxscript custom
functions into the proto; the decoder registers none, so the pass is
patched to identity under a lock (it is a module global of torch) and no
`onnx` package is needed. Where neither that pass nor the package can be
found, the export raises, and bytes that do not carry the interface raise
too: no broken file is written.
"""

from __future__ import annotations

import copy
import importlib
import io
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .model import decode_masks, encode_points

INPUT_NAMES = ["image_embeddings", "point_coords", "point_labels", "mask_input",
               "has_mask_input", "orig_im_size"]
OUTPUT_NAMES = ["masks", "iou_predictions", "low_res_masks"]
# where torch keeps the TorchScript exporter's proto helpers: torch >= 2.9,
# then the older layout
_PROTO_UTILS = ("torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
                "torch.onnx._internal.onnx_proto_utils")
# held around the patch of `_add_onnxscript_fn` and its restore
_EXPORT_LOCK = threading.Lock()


def _cpu_fp32(tree: nn.Module) -> nn.Module:
    """A CPU fp32 copy of a subtree of the port's SAM parameters."""
    return copy.deepcopy(tree).to("cpu", torch.float32)


class SamDecoderOnnx(nn.Module):
    """`encode_points` and `decode_masks` behind the official decoder
    interface. The module holds CPU fp32 copies of the "prompt" and
    "decoder" subtrees and is itself the parameter tree that sam/model.py's
    functions read, so the export runs the model's own arithmetic; what is
    added here belongs to the interface alone."""

    def __init__(self, params, cfg, return_single_mask: bool = True):
        super().__init__()
        self.cfg = cfg
        self.return_single_mask = return_single_mask
        self.prompt = _cpu_fp32(params["prompt"])
        self.decoder = _cpu_fp32(params["decoder"])

    def __getitem__(self, key: str):
        return getattr(self, key)

    def forward(self, image_embeddings, point_coords, point_labels,
                mask_input, has_mask_input, orig_im_size):
        # coords in SAM-1024 pixel space (the frontend sends click * samScale)
        sparse = encode_points(self, point_coords / self.cfg.img_size, point_labels)
        # dense prompt: the GAR demo always sends has_mask_input=0
        # (onnxModelAPI.tsx:54-60); a real mask prompt would need the
        # mask_downscaling convnet, which sam/model.py does not model.
        # has_mask_input scales a zeros-mean term so both inputs stay
        # live in the exported graph and the official feed dict works.
        image_embeddings = image_embeddings + has_mask_input.sum() * mask_input.mean() * 0.0
        low_res, iou = decode_masks(self, self.cfg, image_embeddings, sparse)
        if self.return_single_mask:
            # the best multimask output, skipping index 0, as predict_mask
            best = torch.argmax(iou[:, 1:], dim=-1) + 1
            bidx = torch.arange(low_res.shape[0])
            low_res = low_res[bidx, best].unsqueeze(1)
            iou = iou[bidx, best].unsqueeze(1)
        return self._postprocess(low_res, orig_im_size), iou, low_res

    def _postprocess(self, masks, orig_im_size):
        img_size = self.cfg.img_size
        masks = F.interpolate(masks, size=(img_size, img_size), mode="bilinear",
                              align_corners=False)
        # crop away the pad of the aspect-preserving resize
        # (frontend samScale = 1024 / max(h, w))
        scale = img_size / torch.max(orig_im_size)
        resized = torch.floor(orig_im_size * scale + 0.5).to(torch.int64)
        masks = masks[..., : resized[0], : resized[1]]
        hw = orig_im_size.to(torch.int64)
        return F.interpolate(masks, size=(hw[0], hw[1]), mode="bilinear", align_corners=False)


def build_torch_decoder(params, cfg, return_single_mask: bool = True) -> SamDecoderOnnx:
    """The traceable decoder module on the port's SAM parameters (`params`:
    a `ParamTree`; only its "prompt" and "decoder" subtrees are read)."""
    return SamDecoderOnnx(params, cfg, return_single_mask).eval()


def _proto_utils():
    """The exporter's proto-helper module holding `_add_onnxscript_fn`, or None."""
    for name in _PROTO_UTILS:
        try:
            module = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(module, "_add_onnxscript_fn"):
            return module
    return None


def _check_model_bytes(data: bytes, input_names, output_names) -> bytes:
    """Raise unless `data` is a serialized ONNX ModelProto (field 1, the
    ir_version varint, first) carrying every input and output name."""
    missing = [n for n in (*input_names, *output_names) if n.encode() not in data]
    if len(data) < 64 or data[0] != 0x08 or missing:
        raise RuntimeError(f"the ONNX export gave {len(data)} bytes that are not a model with "
                           f"the decoder's interface (missing names: {missing})")
    return data


def _export_onnx_bytes(module, example_inputs, input_names, output_names,
                       dynamic_axes) -> bytes:
    """torch.onnx (TorchScript exporter, opset 17) without the `onnx`
    package: its one pass that imports it, `_add_onnxscript_fn`, is patched
    to identity for the call (the decoder holds no onnxscript function),
    under `_EXPORT_LOCK`, so concurrent exports never leave it patched.
    Raises where torch keeps that pass elsewhere and `onnx` is missing."""
    utils = _proto_utils()
    if utils is None:
        try:
            import onnx  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"cannot export ONNX with torch {torch.__version__}: its TorchScript exporter "
                f"keeps no `_add_onnxscript_fn` in {' or '.join(_PROTO_UTILS)}, and the `onnx` "
                "package it would need instead is not installed") from e
    buf = io.BytesIO()
    with _EXPORT_LOCK:
        orig = utils._add_onnxscript_fn if utils is not None else None
        if utils is not None:
            utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
        try:
            torch.onnx.export(
                module, example_inputs, buf,
                input_names=input_names, output_names=output_names,
                dynamic_axes=dynamic_axes, dynamo=False, opset_version=17,
            )
        finally:
            if utils is not None:
                utils._add_onnxscript_fn = orig
    return _check_model_bytes(buf.getvalue(), input_names, output_names)


def mask_decoder_onnx_bytes(params, cfg, return_single_mask: bool = True) -> bytes:
    """The mask decoder as a serialized ONNX model with the official SAM
    decoder interface (image_embeddings, point_coords, point_labels,
    mask_input, has_mask_input, orig_im_size) -> (masks, iou_predictions,
    low_res_masks). Runs on the CPU whatever the parameters' device."""
    module = build_torch_decoder(params, cfg, return_single_mask)
    g = cfg.grid
    example = (
        torch.randn(1, cfg.out_chans, g, g),
        torch.tensor([[[64.0, 64.0], [0.0, 0.0]]]),
        torch.tensor([[1.0, -1.0]]),
        torch.zeros(1, 1, 4 * g, 4 * g),
        torch.zeros(1),
        torch.tensor([768.0, 1024.0]),
    )
    return _export_onnx_bytes(
        module, example, input_names=INPUT_NAMES, output_names=OUTPUT_NAMES,
        dynamic_axes={"point_coords": {1: "num_points"}, "point_labels": {1: "num_points"}},
    )


def export_mask_decoder_onnx(params, cfg, path: str,
                             return_single_mask: bool = True) -> Optional[str]:
    """Write `path` as an ONNX mask decoder (`mask_decoder_onnx_bytes`);
    nothing is written if the export fails. Returns the path."""
    data = mask_decoder_onnx_bytes(params, cfg, return_single_mask)
    with open(path, "wb") as f:
        f.write(data)
    return path
