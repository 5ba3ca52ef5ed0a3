"""Kernels H, I and J and their int8 forms H8, I8 and J8: the
layer-indexed matmuls of the fused decode step.

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

The CUDA kernels stream the weights from HBM, which bounds them: split K
over a thread-block cluster so the grid fills the card, reduce the partials
through distributed shared memory in the same launch, tensor cores for B
up to 32 rows. Din and Dout need only be multiples of 8; the TPU kernels'
Dout % block_n rule does not apply. All six run on one body
(csrc/layer_matmul_sm90.cu): the weights, and x beside them, come in by
TMA through a ring fed by one producer thread (I and I8 the gate and up
boxes side by side in a stage), and each launches as a programmatic
dependent of the kernel before it, so its weight loads may start before
that kernel ends; a tile is one 128-byte row of the weight (`stream_n`: 64
bf16, 128 int8 columns), `stream_splits` picks the cluster size,
`stream_plan` says which (column tile, K range) each CTA takes, and
`layer_matmul_stream_plain`, `layer_matmul_q8_stream_plain`,
`layer_swiglu_stream_plain` and `layer_swiglu_q8_stream_plain` sum in the
kernel's order. The stream's grid runs over a table of up to three
segments (`segment_plan`): J and J8 take three, q, k and v (`qkv_tiles`,
cluster size `qkv_stream_splits`; mirrors `layer_qkv_stream_plain`,
`layer_qkv_q8_stream_plain`), as do the mega step's 19 and 20
(ops/decode_megakernel.py), which add an RMSNorm prologue and rope in the
finishers (`finisher_cols`).

H8, I8 and J8 (`layer_matmul_q8`, `layer_swiglu_q8`, `layer_qkv_q8`,
`grasp_any_region_tpu/ops/layer_matmul.py:165, 207, 253`, Pallas bodies
`_mm_q8_kernel`, `_swiglu_q8_kernel`, `_qkv_q8_kernel`) take W8A16
weights: int8 (L, Din, Dout) with one fp32 scale per output column,
(L, 1, Dout), from models/quantize.py. The Pallas kernels scale the
widened weight before the sum; the CUDA kernels and the plain versions
scale the fp32 sum after it (the scale is constant along the sum), which
differs only by fp32 rounding. They stream half the bytes of H-J, each
with int8 weights widened to bf16 on chip. The int8 weights' Dout must be
a multiple of 16 (16-byte rows).

On a CPU tensor each wrapper runs its plain version (below, same rounding
points in torch); on a CUDA tensor it launches the kernel or raises. The
decode step calls them 64 times a step at GAR-1B, so their checks are
attribute reads.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import _build

# kernel launches since the last reset (chip_smoke.py reads them)
launches = dict(H=0, I=0, J=0, H8=0, I8=0, J8=0)

MAX_ROWS = 32  # batch rows the kernels take (two 16-row tensor-core tiles)

# The stream's work plan (csrc/layer_matmul_sm90.cu): tiles of STREAM_N
# bf16 output columns (one 128-byte row; `stream_n` by type), STREAM_BK
# weight rows a stage, and clusters of at most STREAM_MAX_SPLITS CTAs
# splitting K while the grid stays within STREAM_CTAS_PER_SM CTAs an SM
# (H, H8, I), or within one CTA an SM (I8, STREAM_CTAS_PER_SM_Q8: two I8
# CTAs an SM measured slower). Measured against the alternatives
# (ab_kernels.py on an H100 at 700 W, one call / 16 layers back to back,
# ms, in one run, x then fed by 1D bulk copies): H8 at 8 CTAs a tile (GAR-1B's 16 tiles of 128 int8
# columns), not 16: at B = 1 16 took 0.0197 / 0.0146-0.0147 at w_down and
# 0.0116 / 0.0072-0.0073 at wo against 8's 0.0204-0.0206 / 0.0151 and
# 0.0117-0.0119 / 0.0073, at B = 24 0.0297-0.0301 / 0.0236 and
# 0.0179-0.0181 / 0.0132-0.0133 against 0.0261-0.0263 / 0.0206 and
# 0.0143-0.0144 / 0.0097. I at two CTAs an SM (2 a tile, 256 CTAs, two
# stages at B = 24), not one (1 a tile, no reduction, three stages): at
# B = 1 0.0377-0.0380 / 0.0262-0.0263 against 0.0376-0.0381 / 0.0267, at
# B = 24 0.0462-0.0464 / 0.0379-0.0381 against 0.0464 / 0.0355-0.0356.
STREAM_N, STREAM_MAX_SPLITS, STREAM_CTAS_PER_SM = 64, 8, 2
STREAM_CTAS_PER_SM_Q8 = 1
STREAM_BK = 128
ROPE_HEAD = 64  # a roped segment's heads: rotate-half pairs (c, c + 32)


def stream_n(dtype: torch.dtype) -> int:
    """The stream's tile width for weights of `dtype`: one 128-byte row,
    64 bf16 (H, I) or 128 int8 (H8, I8) columns."""
    return STREAM_N * 2 // dtype.itemsize


def stream_splits(tiles: int, din: int, *, sms: int = 132,
                  ctas_per_sm: int = STREAM_CTAS_PER_SM) -> int:
    """The stream's CTAs a column tile (the cluster size): doubled while the
    grid stays within `ctas_per_sm` CTAs an SM, the cluster within
    STREAM_MAX_SPLITS, and a CTA keeps at least one stage of rows. GAR-1B:
    8 for H (32 tiles, two CTAs an SM) and H8 (16 tiles of 128), 2 for I
    (128 tiles) and I8 (64 tiles of 128, one CTA an SM)."""
    s = 1
    while (s < STREAM_MAX_SPLITS and tiles * s * 2 <= ctas_per_sm * sms
           and din >= 2 * s * STREAM_BK):
        s *= 2
    return s


def qkv_tiles(hq: int, hk: int, itemsize: int) -> int:
    """The column tiles of a q, k, v segment table (J, J8, 19, 20): q's,
    then k's and v's, of one 128-byte row each (64 bf16, 128 int8)."""
    n = STREAM_N * 2 // itemsize
    return -(-hq // n) + 2 * -(-hk // n)


def qkv_stream_splits(hq: int, hk: int, d: int, itemsize: int, *, sms: int = 132) -> int:
    """J and J8's CTAs a column tile (the cluster size): `stream_splits`
    over the three segments' tiles, two CTAs an SM. GAR-1B: 4 for J (48
    tiles), 8 for J8 (24 tiles of 128). No rope, so no cap on the finishers'
    pairs (19 and 20 keep theirs: `decode_megakernel.qkv_splits`)."""
    return stream_splits(qkv_tiles(hq, hk, itemsize), d, sms=sms)


def stream_plan(din: int, dout: int, splits: int,
                n: int = STREAM_N) -> List[Tuple[int, int, int, int]]:
    """(column tile, rank, k0, k1) of each CTA of the stream's grid (tiles
    of n = `stream_n` columns): tile t owns columns [n t, n (t + 1)) (cut
    at dout), and CTA `rank` of its cluster the weight rows [k0, k1),
    k_split = ceil(din / splits) rounded up to a whole stage; the last
    ranks may get none (k0 == k1)."""
    k_split = -(-(-(-din // splits)) // STREAM_BK) * STREAM_BK
    return [(t, r, min(din, r * k_split), min(din, (r + 1) * k_split))
            for t in range(-(-dout // n)) for r in range(splits)]


def segment_plan(douts, din: int, splits: int,
                 n: int = STREAM_N) -> List[Tuple[int, int, int, int, int]]:
    """(segment, tile, rank, k0, k1) of each CTA of the stream's grid over a
    segment table of widths `douts`: the segments' column tiles of n columns
    follow each other along the grid's y (a CTA finds its segment by the
    tiles' prefix sums), each split over `splits` CTAs as `stream_plan`
    splits one weight (one k_split for all)."""
    return [(s, t, r, k0, k1) for s, dout in enumerate(douts)
            for t, r, k0, k1 in stream_plan(din, dout, splits, n)]


def finisher_cols(n: int, splits: int, rope: bool = False) -> List[List[int]]:
    """The tile columns each CTA of a cluster finishes (sums over the ranks,
    scales, rounds), in the order it holds them (csrc/layer_matmul_sm90.cu:
    ws_col): rank q the q-th contiguous n / splits; under rope (n / splits
    >= 8) its share of the tile's first halves (the columns c with c % 64 <
    32, in order), then their partners 32 columns on, so that its i-th and
    (i + n / 2 splits)-th columns are a rotate-half pair."""
    cols = n // splits
    if not rope:
        return [list(range(q * cols, (q + 1) * cols)) for q in range(splits)]
    half, pair = cols // 2, ROPE_HEAD // 2

    def col(q: int, i: int) -> int:
        f = q * half + i % half
        return f // pair * ROPE_HEAD + f % pair + (0 if i < half else pair)

    return [[col(q, i) for i in range(cols)] for q in range(splits)]


def _stream_sums(x: torch.Tensor, weights: Tuple[torch.Tensor, ...], layer: int,
                 splits: int) -> List[torch.Tensor]:
    """Each weight's fp32 (B, Dout) sums in the stream's order: per CTA
    (`stream_plan` at the kernel's tile width: 128 columns for int8
    weights, else 64) the sum over its stages in order (a consumer warp owns
    a column over every row of a stage), then the CTAs of a tile in rank
    order."""
    xf, ws = x.float(), [w[layer].float() for w in weights]
    din, dout = ws[0].shape
    n = stream_n(torch.int8) if weights[0].dtype == torch.int8 else STREAM_N
    sums = [torch.zeros((x.shape[0], dout), dtype=torch.float32, device=x.device) for _ in ws]
    for t, _, k0, k1 in stream_plan(din, dout, splits, n):
        cols = slice(t * n, min(dout, (t + 1) * n))
        for total, w in zip(sums, ws):
            cta = torch.zeros_like(total[:, cols])
            for b0 in range(k0, k1, STREAM_BK):
                rows = slice(b0, min(k1, b0 + STREAM_BK))
                cta += xf[:, rows] @ w[rows, cols]
            total[:, cols] += cta
    return sums


def layer_matmul_stream_plain(x: torch.Tensor, w_all: torch.Tensor, layer: int,
                              splits: int) -> torch.Tensor:
    """Kernel H in its order of summation (`_stream_sums`), in fp32,
    rounded once to x's dtype. A mirror for the tests, not a path."""
    (out,) = _stream_sums(x, (w_all,), layer, splits)
    return out.to(x.dtype)


def layer_matmul_q8_stream_plain(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor,
                                 layer: int, splits: int) -> torch.Tensor:
    """Kernel H8 in its order of summation (`_stream_sums` at 128-column
    tiles), each column's scale on the summed column, rounded once to x's
    dtype. A mirror for the tests, not a path."""
    (out,) = _stream_sums(x, (w_q8,), layer, splits)
    return (out * scale[layer].float()).to(x.dtype)


def layer_swiglu_stream_plain(x: torch.Tensor, wg_all: torch.Tensor, wu_all: torch.Tensor,
                              layer: int, splits: int) -> torch.Tensor:
    """Kernel I in its order of summation (`_stream_sums`): silu(gate) * up
    from the fp32 sums, rounded once to x's dtype. A mirror for the tests,
    not a path."""
    gate, up = _stream_sums(x, (wg_all, wu_all), layer, splits)
    return (F.silu(gate) * up).to(x.dtype)


def layer_swiglu_q8_stream_plain(x: torch.Tensor, wg_q8: torch.Tensor, sg: torch.Tensor,
                                 wu_q8: torch.Tensor, su: torch.Tensor, layer: int,
                                 splits: int) -> torch.Tensor:
    """Kernel I8 in its order of summation (`_stream_sums` at 128-column
    tiles): each column's scales on the summed gate and up, silu(gate) *
    up, rounded once to x's dtype. A mirror for the tests, not a path."""
    gate, up = _stream_sums(x, (wg_q8, wu_q8), layer, splits)
    return (F.silu(gate * sg[layer].float()) * (up * su[layer].float())).to(x.dtype)


def layer_qkv_stream_plain(x: torch.Tensor, wq_all: torch.Tensor, wk_all: torch.Tensor,
                           wv_all: torch.Tensor, layer: int,
                           splits: int) -> Tuple[torch.Tensor, ...]:
    """Kernel J in its partition and order: each segment (q, k, v)
    `_stream_sums` (its tiles, each CTA's stages in order, the ranks in
    order), rounded once to x's dtype. A mirror for the tests, not a
    path."""
    return tuple(_stream_sums(x, (w,), layer, splits)[0].to(x.dtype)
                 for w in (wq_all, wk_all, wv_all))


def layer_qkv_q8_stream_plain(x: torch.Tensor, wq_q8: torch.Tensor, sq: torch.Tensor,
                              wk_q8: torch.Tensor, sk: torch.Tensor, wv_q8: torch.Tensor,
                              sv: torch.Tensor, layer: int,
                              splits: int) -> Tuple[torch.Tensor, ...]:
    """Kernel J8 in its partition and order (`_stream_sums` per segment at
    128-column tiles), each column's scale on the summed column, rounded
    once to x's dtype. A mirror for the tests, not a path."""
    return tuple((_stream_sums(x, (w,), layer, splits)[0] * s[layer].float()).to(x.dtype)
                 for w, s in ((wq_q8, sq), (wk_q8, sk), (wv_q8, sv)))


@functools.lru_cache(maxsize=None)
def _card_splits(dout: int, din: int, index: int, n: int = STREAM_N,
                 per_sm: int = STREAM_CTAS_PER_SM) -> int:
    return stream_splits(-(-dout // n), din, sms=_build.sm_count(index), ctas_per_sm=per_sm)


@functools.lru_cache(maxsize=None)
def _card_qkv_stream_splits(hq: int, hk: int, d: int, itemsize: int, index: int) -> int:
    return qkv_stream_splits(hq, hk, d, itemsize, sms=_build.sm_count(index))


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


def layer_matmul_q8_plain(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor,
                          layer: int) -> torch.Tensor:
    return ((x.float() @ w_q8[layer].float()) * scale[layer]).to(x.dtype)


def layer_swiglu_q8_plain(x: torch.Tensor, wg_q8: torch.Tensor, sg: torch.Tensor,
                          wu_q8: torch.Tensor, su: torch.Tensor, layer: int) -> torch.Tensor:
    xf = x.float()
    gate = (xf @ wg_q8[layer].float()) * sg[layer]
    return (F.silu(gate) * ((xf @ wu_q8[layer].float()) * su[layer])).to(x.dtype)


def layer_qkv_q8_plain(x: torch.Tensor, wq_q8: torch.Tensor, sq: torch.Tensor,
                       wk_q8: torch.Tensor, sk: torch.Tensor, wv_q8: torch.Tensor,
                       sv: torch.Tensor, layer: int) -> Tuple[torch.Tensor, ...]:
    xf = x.float()
    return tuple(((xf @ w[layer].float()) * s[layer]).to(x.dtype)
                 for w, s in ((wq_q8, sq), (wk_q8, sk), (wv_q8, sv)))


def _check(x: torch.Tensor, layer: int, *weights: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless the kernels take these operands: x a contiguous bf16
    (B <= 32, Din) matrix, each weight a contiguous (L, Din, N) stack of
    `dtype` on x's device, Din a multiple of 8, rows of whole 16-byte
    chunks (N a multiple of 8 in bf16, of 16 in int8), all 16-byte aligned
    (the kernels load 16-byte chunks), and 0 <= layer < L. A host-bound
    decode step pays this 64 times, so it reads attributes and nothing
    more."""
    shape = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: the kernel takes bfloat16, got {x.dtype}")
    if (len(shape) != 2 or not 1 <= shape[0] <= MAX_ROWS or shape[1] % 8
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"x must be a contiguous, 16-byte aligned (B <= {MAX_ROWS}, Din) "
                         f"matrix, Din a multiple of 8; got shape {tuple(shape)}, "
                         f"strides {x.stride()}")
    device = x.get_device()
    row_chunk = 16 if dtype == torch.int8 else 8  # elements in 16 bytes
    for w in weights:
        if w.dtype != dtype:
            raise TypeError(f"weights: the kernel takes {dtype}, got {w.dtype}")
        w_shape = w.shape
        if (len(w_shape) != 3 or w_shape[1] != shape[1] or w_shape[2] % row_chunk
                or not w.is_contiguous() or w.data_ptr() % 16 or w.get_device() != device):
            raise ValueError(f"weight {tuple(w_shape)} on {w.device} does not fit x "
                             f"{tuple(shape)} on {x.device} (Dout a multiple of {row_chunk})")
        if not 0 <= layer < w_shape[0]:
            raise IndexError(f"layer {layer} out of range for {w_shape[0]} layers")


def _check_q8(x: torch.Tensor, layer: int, *pairs: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """`_check` for int8 weights, and each weight's scale a contiguous fp32
    (L, 1, N) stack on x's device."""
    _check(x, layer, *(w for w, _ in pairs), dtype=torch.int8)
    device = x.get_device()
    for w, s in pairs:
        w_shape = w.shape
        if s.dtype != torch.float32:
            raise TypeError(f"scales: the kernel takes float32, got {s.dtype}")
        if (s.shape != (w_shape[0], 1, w_shape[2]) or not s.is_contiguous()
                or s.get_device() != device):
            raise ValueError(f"scale {tuple(s.shape)} on {s.device} does not fit weight "
                             f"{tuple(w_shape)} on {w.device}")


def layer_matmul(x: torch.Tensor, w_all: torch.Tensor, layer: int) -> torch.Tensor:
    """Kernel H: x (B, Din) @ w_all[layer] (w_all (L, Din, Dout)) -> (B, Dout)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_matmul_plain(x, w_all, layer)
    _check(x, layer, w_all)
    b, din = x.shape
    n_layers, _, dout = w_all.shape
    out = torch.empty((b, dout), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_matmul(
        x.data_ptr(), w_all.data_ptr(), out.data_ptr(), layer, n_layers, b, din, dout,
        _card_splits(dout, din, dev.index), _build.stream_handle(dev))
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
    n_layers, _, m = wg_all.shape
    out = torch.empty((b, m), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_swiglu(
        x.data_ptr(), wg_all.data_ptr(), wu_all.data_ptr(), out.data_ptr(), layer, n_layers, b,
        din, m, _card_splits(m, din, dev.index),
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
    if wv_all.shape != wk_all.shape or wq_all.shape[0] != wk_all.shape[0]:
        raise ValueError(f"wq {tuple(wq_all.shape)}, wk {tuple(wk_all.shape)} and wv "
                         f"{tuple(wv_all.shape)}: wk and wv differ, or the layer counts do")
    b, d = x.shape
    hq, hk = wq_all.shape[2], wk_all.shape[2]
    q = torch.empty((b, hq), dtype=x.dtype, device=dev)
    k = torch.empty((b, hk), dtype=x.dtype, device=dev)
    v = torch.empty((b, hk), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_qkv(
        x.data_ptr(), wq_all.data_ptr(), wk_all.data_ptr(), wv_all.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), layer, wq_all.shape[0], b, d, hq, hk,
        _card_qkv_stream_splits(hq, hk, d, 2, dev.index), _build.stream_handle(dev))
    _build.check(err, "gar_layer_qkv")
    launches["J"] += 1
    return q, k, v


def layer_matmul_q8(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor,
                    layer: int) -> torch.Tensor:
    """Kernel H8: (x @ w_q8[layer]) * scale[layer] -> (B, Dout), w_q8 int8
    (L, Din, Dout), scale fp32 (L, 1, Dout)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_matmul_q8_plain(x, w_q8, scale, layer)
    _check_q8(x, layer, (w_q8, scale))
    b, din = x.shape
    n_layers, _, dout = w_q8.shape
    out = torch.empty((b, dout), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_matmul_q8(
        x.data_ptr(), w_q8.data_ptr(), scale.data_ptr(), out.data_ptr(), layer, n_layers, b, din,
        dout, _card_splits(dout, din, dev.index, stream_n(torch.int8)), _build.stream_handle(dev))
    _build.check(err, "gar_layer_matmul_q8")
    launches["H8"] += 1
    return out


def layer_swiglu_q8(x: torch.Tensor, wg_q8: torch.Tensor, sg: torch.Tensor,
                    wu_q8: torch.Tensor, su: torch.Tensor, layer: int) -> torch.Tensor:
    """Kernel I8: silu((x @ wg_q8[layer]) * sg[layer]) * ((x @ wu_q8[layer])
    * su[layer]) -> (B, M), SiLU and the product in fp32, one rounding."""
    dev = x.device
    if dev.type == "cpu":
        return layer_swiglu_q8_plain(x, wg_q8, sg, wu_q8, su, layer)
    _check_q8(x, layer, (wg_q8, sg), (wu_q8, su))
    if wu_q8.shape != wg_q8.shape:
        raise ValueError(f"gate {tuple(wg_q8.shape)} and up {tuple(wu_q8.shape)} differ")
    b, din = x.shape
    n_layers, _, m = wg_q8.shape
    out = torch.empty((b, m), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_swiglu_q8(
        x.data_ptr(), wg_q8.data_ptr(), sg.data_ptr(), wu_q8.data_ptr(), su.data_ptr(),
        out.data_ptr(), layer, n_layers, b, din, m,
        _card_splits(m, din, dev.index, stream_n(torch.int8), STREAM_CTAS_PER_SM_Q8),
        _build.stream_handle(dev))
    _build.check(err, "gar_layer_swiglu_q8")
    launches["I8"] += 1
    return out


def layer_qkv_q8(x: torch.Tensor, wq_q8: torch.Tensor, sq: torch.Tensor,
                 wk_q8: torch.Tensor, sk: torch.Tensor, wv_q8: torch.Tensor,
                 sv: torch.Tensor, layer: int) -> Tuple[torch.Tensor, ...]:
    """Kernel J8: the int8 q, k and v products of one x in one launch;
    (B, Hq), (B, Hk), (B, Hk)."""
    dev = x.device
    if dev.type == "cpu":
        return layer_qkv_q8_plain(x, wq_q8, sq, wk_q8, sk, wv_q8, sv, layer)
    _check_q8(x, layer, (wq_q8, sq), (wk_q8, sk), (wv_q8, sv))
    if wv_q8.shape != wk_q8.shape or wq_q8.shape[0] != wk_q8.shape[0]:
        raise ValueError(f"wq {tuple(wq_q8.shape)}, wk {tuple(wk_q8.shape)} and wv "
                         f"{tuple(wv_q8.shape)}: wk and wv differ, or the layer counts do")
    b, d = x.shape
    hq, hk = wq_q8.shape[2], wk_q8.shape[2]
    q = torch.empty((b, hq), dtype=x.dtype, device=dev)
    k = torch.empty((b, hk), dtype=x.dtype, device=dev)
    v = torch.empty((b, hk), dtype=x.dtype, device=dev)
    err = _build.library().gar_layer_qkv_q8(
        x.data_ptr(), wq_q8.data_ptr(), sq.data_ptr(), wk_q8.data_ptr(), sk.data_ptr(),
        wv_q8.data_ptr(), sv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), layer,
        wq_q8.shape[0], b, d, hq, hk, _card_qkv_stream_splits(hq, hk, d, 1, dev.index),
        _build.stream_handle(dev))
    _build.check(err, "gar_layer_qkv_q8")
    launches["J8"] += 1
    return q, k, v
