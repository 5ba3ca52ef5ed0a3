"""Kernels H, I and J: the layer-indexed matmuls of the fused decode step.

The JAX package's fused decode step (`grasp_any_region_tpu/models/llama.py:
llama_decode_step_fused`) reads each layer's weights straight out of the
stacked (L, Din, Dout) arrays with three Pallas kernels
(`grasp_any_region_tpu/ops/layer_matmul.py`):

  H  layer_matmul  x @ w_all[l]                          -> (B, Dout)
  I  layer_swiglu  silu(x @ wg[l]) * (x @ wu[l])         -> (B, M)
  J  layer_qkv     x @ wq[l], x @ wk[l], x @ wv[l]       -> (B, Hq), (B, Hk), (B, Hk)

Every sum is fp32 and each output is rounded once to x's dtype: I takes
SiLU and the product in fp32 from the fp32 sums (the XLA form rounds gate,
up and the product separately), J rounds q, k and v. The layer is a Python
int, as kernel C takes it.

The CUDA kernels (csrc/layer_matmul.cu) stream the weights from HBM, which
bounds them: split K over a thread-block cluster so the grid fills the
card, reduce the partials through distributed shared memory in the same
launch, tensor cores for B up to 32 rows. Din and Dout need only be
multiples of 8; the TPU kernels' Dout % block_n rule does not apply.

On a CPU tensor each wrapper runs its plain version (below, same rounding
points in torch); on a CUDA tensor it launches the kernel or raises. The
decode step calls them 64 times a step at GAR-1B, so their checks are
attribute reads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = dict(H=0, I=0, J=0)  # kernel launches since the last reset (chip_smoke.py reads it)

MAX_ROWS = 32  # batch rows the kernels take (two 16-row tensor-core tiles)


def layer_matmul_plain(x: torch.Tensor, w_all: torch.Tensor, layer: int) -> torch.Tensor:
    return (x.float() @ w_all[layer].float()).to(x.dtype)


def layer_swiglu_plain(x: torch.Tensor, wg_all: torch.Tensor, wu_all: torch.Tensor,
                       layer: int) -> torch.Tensor:
    xf = x.float()
    return (F.silu(xf @ wg_all[layer].float()) * (xf @ wu_all[layer].float())).to(x.dtype)


def layer_qkv_plain(x: torch.Tensor, wq_all: torch.Tensor, wk_all: torch.Tensor,
                    wv_all: torch.Tensor, layer: int) -> Tuple[torch.Tensor, ...]:
    xf = x.float()
    return tuple((xf @ w[layer].float()).to(x.dtype) for w in (wq_all, wk_all, wv_all))


def _check(x: torch.Tensor, layer: int, *weights: torch.Tensor) -> None:
    """Raise unless the kernels take these operands: x a contiguous bf16
    (B <= 32, Din) matrix, each weight a contiguous bf16 (L, Din, N) stack
    on x's device, Din and N multiples of 8, all 16-byte aligned (the
    kernels load 16-byte chunks), and 0 <= layer < L. A host-bound decode
    step pays this 64 times, so it reads attributes and nothing more."""
    shape = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: the kernel takes bfloat16, got {x.dtype}")
    if (len(shape) != 2 or not 1 <= shape[0] <= MAX_ROWS or shape[1] % 8
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"x must be a contiguous, 16-byte aligned (B <= {MAX_ROWS}, Din) "
                         f"matrix, Din a multiple of 8; got shape {tuple(shape)}, "
                         f"strides {x.stride()}")
    device = x.get_device()
    for w in weights:
        if w.dtype != torch.bfloat16:
            raise TypeError(f"weights: the kernel takes bfloat16, got {w.dtype}")
        w_shape = w.shape
        if (len(w_shape) != 3 or w_shape[1] != shape[1] or w_shape[2] % 8
                or not w.is_contiguous() or w.data_ptr() % 16 or w.get_device() != device):
            raise ValueError(f"weight {tuple(w_shape)} on {w.device} does not fit x "
                             f"{tuple(shape)} on {x.device}")
        if not 0 <= layer < w_shape[0]:
            raise IndexError(f"layer {layer} out of range for {w_shape[0]} layers")


def layer_matmul(x: torch.Tensor, w_all: torch.Tensor, layer: int) -> torch.Tensor:
    """Kernel H: x (B, Din) @ w_all[layer] (w_all (L, Din, Dout)) -> (B, Dout)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_matmul_plain(x, w_all, layer)
    _check(x, layer, w_all)
    b, din = x.shape
    dout = w_all.shape[2]
    out = torch.empty((b, dout), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_matmul(
        x.data_ptr(), w_all.data_ptr(), out.data_ptr(), layer, b, din, dout,
        _build.stream_handle(dev))
    _build.check(err, "gar_layer_matmul")
    launches["H"] += 1
    return out


def layer_swiglu(x: torch.Tensor, wg_all: torch.Tensor, wu_all: torch.Tensor,
                 layer: int) -> torch.Tensor:
    """Kernel I: silu(x @ wg_all[layer]) * (x @ wu_all[layer]) -> (B, M)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_swiglu_plain(x, wg_all, wu_all, layer)
    _check(x, layer, wg_all, wu_all)
    if wu_all.shape != wg_all.shape:
        raise ValueError(f"gate {tuple(wg_all.shape)} and up {tuple(wu_all.shape)} differ")
    b, din = x.shape
    m = wg_all.shape[2]
    out = torch.empty((b, m), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_swiglu(
        x.data_ptr(), wg_all.data_ptr(), wu_all.data_ptr(), out.data_ptr(), layer, b, din, m,
        _build.stream_handle(dev))
    _build.check(err, "gar_layer_swiglu")
    launches["I"] += 1
    return out


def layer_qkv(x: torch.Tensor, wq_all: torch.Tensor, wk_all: torch.Tensor,
              wv_all: torch.Tensor, layer: int) -> Tuple[torch.Tensor, ...]:
    """Kernel J: (x @ wq[layer], x @ wk[layer], x @ wv[layer]), one read of x,
    one launch; (B, Hq), (B, Hk), (B, Hk)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_qkv_plain(x, wq_all, wk_all, wv_all, layer)
    _check(x, layer, wq_all, wk_all, wv_all)
    if wv_all.shape != wk_all.shape:
        raise ValueError(f"wk {tuple(wk_all.shape)} and wv {tuple(wv_all.shape)} differ")
    b, d = x.shape
    hq, hk = wq_all.shape[2], wk_all.shape[2]
    q = torch.empty((b, hq), dtype=x.dtype, device=dev)
    k = torch.empty((b, hk), dtype=x.dtype, device=dev)
    v = torch.empty((b, hk), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_qkv(
        x.data_ptr(), wq_all.data_ptr(), wk_all.data_ptr(), wv_all.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), layer, b, d, hq, hk, _build.stream_handle(dev))
    _build.check(err, "gar_layer_qkv")
    launches["J"] += 1
    return q, k, v
