"""Kernels 19-23: the mega decode step, one token of a decoder layer in three
launches (`grasp_any_region_tpu/ops/decode_megakernel.py`).

  19  layer_qkv_norm_rope      RMSNorm(x), x @ wq/wk/wv[l], rope on q and k
  20  layer_qkv_norm_rope_q8   19 over int8 weights with per-column scales
  22  decode_attention_wo      KV append + attention + @ wo[l] + residual
  23  layer_mlp_residual       x + SwiGLU(RMSNorm(x)) @ w_down[l]
  21  layer_mlp_residual_q8    23 over int8 weights

The wrappers keep JAX's names and argument order. Each plain version keeps
its TPU kernel's rounding points, which differ from kernel to kernel and
from the fused step's:

  19  xn = RMSNorm(x) in fp32, rounded to x's dtype; q, k, v fp32 sums; rope
      in fp32 on the sums; one rounding each.
  20  xn stays fp32 (JAX contracts it with the fp32 `w * scale`).
  23  xn rounded; act = SiLU(gate) * up rounded to x's dtype before w_down;
      x + the fp32 sum over M, rounded once.
  21  xn rounded; act stays fp32; w_down's column scale on the fp32 sum.
  22  p rounded to the cache dtype before PV, the current token folded in
      fp32, a rounded to x's dtype before wo; the K kv-head partials summed
      in head order in fp32, then x + that sum, rounded once.

The rope tables may be JAX's tiled (B, H * head_dim) tables or (B,
head_dim) rows; the kernel and the plain versions read column c of a
table of width w at c mod w, so both give the same function. The port's
step passes the (B, head_dim) rows.

The CUDA kernels stream the weights as H does. 19 and 20 run on H's
TMA-fed weight stream (csrc/layer_matmul_sm90.cu) over a table of three
segments, q, k and v (`layer_matmul.segment_plan`), in clusters of
`qkv_card_splits` CTAs a column tile. Each CTA normalises x once into
shared memory over its K range (the RMSNorm prologue it shares with 21 /
23, csrc/rms_prologue.cuh); 20 keeps JAX's fp32 xn on the tensor cores as a
bf16 high and low half (two products with one weight fragment), as 21 does
its activation. The finisher of a q or k column also sums its rotate-half
partner (`layer_matmul.finisher_cols`) and applies rope before the one
rounding. `layer_qkv_norm_rope_stream_plain` and
`layer_qkv_norm_rope_q8_stream_plain` follow that partition and order on
any device, as mirrors for the tests. 23 and 21 (csrc/decode_mlp_sm90.cu)
are one TMA-fed weight stream over every SM: a cluster of `mlp_splits`
CTAs per 128 MLP columns splits gate
and up over K, meets over distributed shared memory, and streams the
tile's w_down rows for its share of the output columns (`mlp_plan`). 22
(csrc/decode_attn_wo_sm90.cu) is kernel C's split-KV cluster body with wo
tiled across the splits (`attention_wo_plan`); it updates the cache in
place, as C does, and returns only the new residual. The three sum across
clusters (M tiles, kv heads) without a grid barrier: each CTA writes its
fp32 partial to a workspace slot and the last to arrive at a slice's
counter sums the slots in order (`ordered_sum_plain`), adds x and rounds
once; the counters (`_counters`, one zeroed int32 tensor a device) are 0
again after every launch, so a launch can be replayed. The split plain
versions (`layer_mlp_residual_split_plain`,
`decode_attention_wo_split_plain`) follow the kernels' partition and order
on any device, as mirrors for the tests.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The mega step calls them 48 times a step at
GAR-1B, so their checks read attributes and nothing more. The kernels take
bf16 activations, B <= 32 rows and head_dim 64.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from . import decode_attention as dec
from . import layer_matmul as lm
from .attention import NEG_INF
from .norms import rms_norm
from .rope import rotate_half

# kernel launches since the last reset (chip_smoke.py reads them)
launches = {"19": 0, "20": 0, "21": 0, "22": 0, "23": 0}

MAX_ROWS = 32  # batch rows the kernels take
HEAD_DIM = 64  # the only head_dim the kernels are built for
_COUNTERS = {}  # device index -> the arrival counters: [0, 3072) 21 and 23, [3072, 4096) 22
COUNTERS_22 = 3072

# Kernels 21 / 23's work plan (csrc/decode_mlp_sm90.cu): tiles of MLP_TILE
# MLP columns, 16 KB stages (a gate / up stage MLP_STAGE_BYTES / (2 MLP_TILE
# itemsize) K rows, a w_down box 128 rows x 128 bytes of columns), clusters
# of at most MLP_MAX_SPLITS CTAs splitting K while the grid stays within
# MLP_CTAS_PER_SM CTAs an SM.
MLP_TILE, MLP_STAGE_BYTES, MLP_MAX_SPLITS, MLP_CTAS_PER_SM = 128, 16384, 16, 2
MLP_SLOT_PAD = 64  # floats past each (B, D) workspace slot (csrc/decode_mlp_sm90.cu)
SUM_GROUP = 8  # slots the ordered sum adds in order before the groups (ordered_sum.cuh)


def _rope_flat(z: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               head_dim: int) -> torch.Tensor:
    """Rotate-half rope on fp32 (B, H * head_dim) sums; cos / sin (B, w),
    w = head_dim or H * head_dim, read at column mod w."""
    b, n = z.shape
    reps = n // cos.shape[-1]
    cos, sin = cos.float().repeat(1, reps), sin.float().repeat(1, reps)
    rh = rotate_half(z.view(b, n // head_dim, head_dim)).reshape(b, n)
    return z * cos + rh * sin


def layer_qkv_norm_rope_plain(x, norm_all, wq_all, wk_all, wv_all, cosq, sinq, cosk, sink,
                              layer: int, *, eps: float, head_dim: int):
    xn = rms_norm(x, norm_all[layer], eps).float()
    q, k, v = (xn @ w[layer].float() for w in (wq_all, wk_all, wv_all))
    return (_rope_flat(q, cosq, sinq, head_dim).to(x.dtype),
            _rope_flat(k, cosk, sink, head_dim).to(x.dtype), v.to(x.dtype))


def layer_qkv_norm_rope_q8_plain(x, norm_all, wq_q8, sq, wk_q8, sk, wv_q8, sv, cosq, sinq, cosk,
                                 sink, layer: int, *, eps: float, head_dim: int):
    xn = rms_norm(x.float(), norm_all[layer], eps)  # fp32, not rounded
    q, k, v = ((xn @ w[layer].float()) * s[layer] for w, s in ((wq_q8, sq), (wk_q8, sk),
                                                               (wv_q8, sv)))
    return (_rope_flat(q, cosq, sinq, head_dim).to(x.dtype),
            _rope_flat(k, cosk, sink, head_dim).to(x.dtype), v.to(x.dtype))


def _rope_pairs(z: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n: int,
                splits: int) -> torch.Tensor:
    """Rope on fp32 (B, N) sums as 19 / 20's finishers apply it to tiles of
    n columns split `splits` ways: each column with the partner its
    finisher holds beside it (`layer_matmul.finisher_cols`), v cos +
    (second half ? pv : -pv) sin; the (B, w) tables read at column mod w."""
    width = z.shape[1]
    partner, sign = list(range(n)), [0.0] * n
    for cols in lm.finisher_cols(n, splits, rope=True):
        half = len(cols) // 2
        for i, c in enumerate(cols):
            partner[c], sign[c] = (cols[i + half], -1.0) if i < half else (cols[i - half], 1.0)
    tile = torch.arange(width, device=z.device)
    base = tile - tile % n
    idx = base + torch.tensor(partner, device=z.device)[tile % n]
    sgn = torch.tensor(sign, device=z.device)[tile % n]
    reps = width // cos.shape[-1]
    cos, sin = cos.float().repeat(1, reps), sin.float().repeat(1, reps)
    return z * cos + sgn * z[:, idx] * sin


def _qkv_stream(xn, weights, scales, tables, layer: int, splits: int, dtype):
    """19 / 20 in the stream's partition and order (xn fp32): per segment
    (q, k, v) `layer_matmul._stream_sums` (the tiles, each CTA's stages in
    order, the ranks in order), each column's int8 scale, then rope on q and
    k through the finishers' pairs; one rounding each."""
    outs = []
    for i, w in enumerate(weights):
        (z,) = lm._stream_sums(xn, (w,), layer, splits)
        if scales is not None:
            z = z * scales[i][layer].float()
        if i < 2:
            n = lm.stream_n(torch.int8) if w.dtype == torch.int8 else lm.STREAM_N
            z = _rope_pairs(z, tables[2 * i], tables[2 * i + 1], n, splits)
        outs.append(z.to(dtype))
    return tuple(outs)


def layer_qkv_norm_rope_stream_plain(x, norm_all, wq_all, wk_all, wv_all, cosq, sinq, cosk,
                                     sink, layer: int, *, eps: float, head_dim: int,
                                     splits: int):
    """Kernel 19 in its partition and order (`_qkv_stream`), xn rounded to
    x's dtype. A mirror for the tests, not a path."""
    if head_dim != HEAD_DIM:
        raise ValueError(f"kernel 19's rope pairs are built for head_dim {HEAD_DIM}")
    xn = rms_norm(x, norm_all[layer], eps).float()
    return _qkv_stream(xn, (wq_all, wk_all, wv_all), None, (cosq, sinq, cosk, sink), layer,
                       splits, x.dtype)


def layer_qkv_norm_rope_q8_stream_plain(x, norm_all, wq_q8, sq, wk_q8, sk, wv_q8, sv, cosq, sinq,
                                        cosk, sink, layer: int, *, eps: float, head_dim: int,
                                        splits: int):
    """Kernel 20 in its partition and order (`_qkv_stream` at 128-column
    tiles), xn fp32 (the kernel carries it as two bf16 halves). A mirror for
    the tests, not a path."""
    if head_dim != HEAD_DIM:
        raise ValueError(f"kernel 20's rope pairs are built for head_dim {HEAD_DIM}")
    xn = rms_norm(x.float(), norm_all[layer], eps)
    return _qkv_stream(xn, (wq_q8, wk_q8, wv_q8), (sq, sk, sv), (cosq, sinq, cosk, sink), layer,
                       splits, x.dtype)


def layer_mlp_residual_plain(x, norm_all, wg_all, wu_all, wd_all, layer: int, *, eps: float):
    xn = rms_norm(x, norm_all[layer], eps).float()
    act = (F.silu(xn @ wg_all[layer].float()) * (xn @ wu_all[layer].float())).to(x.dtype)
    return (x.float() + act.float() @ wd_all[layer].float()).to(x.dtype)


def layer_mlp_residual_q8_plain(x, norm_all, wg_q8, sg, wu_q8, su, wd_q8, sd, layer: int, *,
                                eps: float):
    xn = rms_norm(x, norm_all[layer], eps).float()
    act = F.silu((xn @ wg_q8[layer].float()) * sg[layer]) * ((xn @ wu_q8[layer].float())
                                                             * su[layer])
    return (x.float() + (act @ wd_q8[layer].float()) * sd[layer]).to(x.dtype)


def decode_attention_wo_plain(q, k_all, v_all, k_new, v_new, wo_all, x, layer: int, *,
                              prompt_lens, write_pos, prompt_pad: int,
                              wo_scale: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The new K/V written at column write_pos of the layer slab in place
    (`index_copy_`, no host sync); the history [0, prompt_len) and
    [prompt_pad, write_pos) attended with p = exp(s - the history's max)
    rounded to the cache dtype before PV; the current token folded in from
    k_new / v_new in fp32; then x + sum over kv heads of a @ wo rows."""
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    idx = write_pos.reshape(1).long()
    k_all[layer].index_copy_(2, idx, k_new.to(k_all.dtype)[:, :, None, :])
    v_all[layer].index_copy_(2, idx, v_new.to(v_all.dtype)[:, :, None, :])
    qf = q.float().reshape(b, kh, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, k_all[layer].float()) * scale
    ids = torch.arange(s, device=q.device)[None, :]
    valid = (ids < prompt_lens[:, None]) | ((ids >= prompt_pad) & (ids < write_pos))
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m_hist = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m_hist)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(v_all.dtype).float(), v_all[layer].float())
    s_cur = (qf * k_new.float()[:, :, None, :]).sum(-1, keepdim=True) * scale
    m = torch.maximum(m_hist, s_cur)
    alpha, p_cur = torch.exp(m_hist - m), torch.exp(s_cur - m)
    denom = p.sum(-1, keepdim=True) * alpha + p_cur
    a = (acc * alpha + p_cur * v_new.float()[:, :, None, :]) / torch.clamp(denom, min=1e-30)
    a = a.to(x.dtype).float().reshape(b, kh, g * d)
    w = wo_all[layer].float().reshape(kh, g * d, -1)
    partial = torch.einsum("bkr,krn->bkn", a, w)
    if wo_scale is not None:
        partial = partial * wo_scale[layer]
    total = partial[:, 0]
    for i in range(1, kh):  # the kv heads' partials in head order, as the TPU grid adds them
        total = total + partial[:, i]
    return (x.float() + total).to(x.dtype)


# ---------------------------------------------------------------- the kernels' plans


def box_cols(itemsize: int) -> int:
    """Columns of a 128-byte TMA box row: 64 bf16, 128 int8."""
    return 128 // itemsize


def mlp_stage_rows(itemsize: int) -> int:
    """K rows of a gate / up stage of kernels 21 / 23: 64 int8, 32 bf16."""
    return MLP_STAGE_BYTES // (2 * MLP_TILE * itemsize)


def qkv_splits(tiles: int, d: int, itemsize: int, *, sms: int = 132) -> int:
    """Kernels 19 / 20's CTAs a column tile (the cluster size):
    `layer_matmul.stream_splits` over the three segments' tiles (two CTAs
    an SM), within the rope finishers' limit of 4 pairs at the least
    (box_cols(itemsize) / 8: 8 bf16, 16 int8). GAR-1B: 4 for 19 (48 tiles;
    8, four CTAs an SM, measured slower at B = 24: ab_kernels.py q_*,
    PERF.md), 8 for 20 (24 tiles)."""
    return min(lm.stream_splits(tiles, d, sms=sms), box_cols(itemsize) // 8)


@functools.lru_cache(maxsize=None)
def _card_qkv_splits(tiles: int, d: int, itemsize: int, index: int) -> int:
    return qkv_splits(tiles, d, itemsize, sms=_build.sm_count(index))


def qkv_card_splits(hq: int, hk: int, d: int, q8: bool, device: torch.device) -> int:
    """`qkv_splits` on the card (its SM count)."""
    itemsize = 1 if q8 else 2
    return _card_qkv_splits(lm.qkv_tiles(hq, hk, itemsize), d, itemsize, device.index)


def mlp_splits(tiles: int, d: int, itemsize: int, *, sms: int = 132,
               fits: Optional[Callable[[int], bool]] = None) -> int:
    """Kernels 21 / 23's CTAs a tile (the cluster size): doubled while the
    grid stays within MLP_CTAS_PER_SM CTAs an SM, the cluster within
    MLP_MAX_SPLITS, a CTA keeps at least one stage of K rows, and (on the
    card, `fits(s)`) all `tiles` clusters of s CTAs are resident at once.
    GAR-1B (m = 8192: 64 tiles): 4 on 132 SMs."""
    s = 1
    while (s < MLP_MAX_SPLITS and tiles * s * 2 <= MLP_CTAS_PER_SM * sms
           and d >= 2 * s * mlp_stage_rows(itemsize) and (fits is None or fits(2 * s))):
        s *= 2
    return s


def mlp_plan(d: int, m: int, splits: int, itemsize: int) -> List[Tuple[int, int, int, int,
                                                                       List[int]]]:
    """(tile, rank, k0, k1, blocks) of each CTA of kernels 21 / 23: tile t
    owns MLP columns [MLP_TILE t, MLP_TILE (t + 1)); CTA `rank` of its
    cluster the gate / up rows [k0, k1) (k_split = ceil(d / splits) rounded
    up to a stage; the last ranks may get none), and the w_down column
    blocks (box_cols(itemsize) columns each) c with (c + t) % splits ==
    rank, in order (so the CTAs that finish a block's ordered sum differ
    from block to block)."""
    rows = mlp_stage_rows(itemsize)
    k_split = -(-(-(-d // splits)) // rows) * rows
    n_blocks = d // box_cols(itemsize)
    return [(t, r, min(d, r * k_split), min(d, (r + 1) * k_split),
             list(range((r - t) % splits, n_blocks, splits)))
            for t in range(m // MLP_TILE) for r in range(splits)]


def attention_wo_plan(dm: int, splits: int, itemsize: int) -> List[Tuple[int, int, int]]:
    """(rank, c0, c1) of each CTA of a kernel-22 cluster: the wo columns
    [c0, c1) it multiplies, whole 128-byte chunks, ceil(chunks / splits) of
    them (the last ranks may get fewer or none)."""
    cpb = box_cols(itemsize)
    chunks = -(-dm // cpb)
    per = -(-chunks // splits)
    return [(r, min(dm, min(chunks, r * per) * cpb), min(dm, min(chunks, (r + 1) * per) * cpb))
            for r in range(splits)]


def ordered_sum_plain(parts: torch.Tensor) -> torch.Tensor:
    """Kernels 21-23's sum over the slots (dim 0) in their order: groups of
    SUM_GROUP slots, each added in slot order, then the groups in order."""
    total = None
    for r0 in range(0, parts.shape[0], SUM_GROUP):
        run = parts[r0]
        for s in range(r0 + 1, min(parts.shape[0], r0 + SUM_GROUP)):
            run = run + parts[s]
        total = run if total is None else total + run
    return total


def layer_mlp_residual_split_plain(x, norm_all, wg_all, wu_all, wd_all, layer: int, *,
                                   eps: float, splits: int, scales=None) -> torch.Tensor:
    """Kernels 23 (scales None) and 21 (scales (sg, su, sd), int8 weights)
    in their partition and order, in fp32: per tile and rank (`mlp_plan`)
    the gate and up sums over the rank's K rows stage by stage; the ranks
    in rank order; the int8 scales, SiLU(gate) * up (23: rounded to x's
    dtype; 21: kept fp32); each tile's partial of every w_down column block
    (21: times the column scale); the tiles summed by `ordered_sum_plain`;
    x added and one rounding. xn is rounded to x's dtype, as both TPU
    kernels round it. A mirror for the tests, not a path."""
    itemsize = wg_all.element_size()
    q8 = scales is not None
    xn = rms_norm(x, norm_all[layer], eps).float()
    wg, wu, wd = (w[layer].float() for w in (wg_all, wu_all, wd_all))
    d, m = wg.shape
    rows, cpb = mlp_stage_rows(itemsize), box_cols(itemsize)
    plan = mlp_plan(d, m, splits, itemsize)
    parts = []
    for t in range(m // MLP_TILE):
        n0, n1 = t * MLP_TILE, (t + 1) * MLP_TILE
        gate = up = 0.0
        for _, _, k0, k1, _ in plan[t * splits:(t + 1) * splits]:  # the ranks in order
            gs = us = torch.zeros((x.shape[0], MLP_TILE), dtype=torch.float32, device=x.device)
            for b0 in range(k0, k1, rows):
                b1 = min(k1, b0 + rows)
                gs = gs + xn[:, b0:b1] @ wg[b0:b1, n0:n1]
                us = us + xn[:, b0:b1] @ wu[b0:b1, n0:n1]
            gate, up = gate + gs, up + us
        if q8:
            gate, up = gate * scales[0][layer, :, n0:n1], up * scales[1][layer, :, n0:n1]
        act = F.silu(gate) * up
        if not q8:
            act = act.to(x.dtype).float()
        part = torch.empty((x.shape[0], d), dtype=torch.float32, device=x.device)
        for _, _, _, _, blocks in plan[t * splits:(t + 1) * splits]:
            for blk in blocks:
                c0, c1 = blk * cpb, (blk + 1) * cpb
                part[:, c0:c1] = act @ wd[n0:n1, c0:c1]
        parts.append(part * scales[2][layer] if q8 else part)
    return (x.float() + ordered_sum_plain(torch.stack(parts))).to(x.dtype)


def decode_attention_wo_split_plain(q, k_all, v_all, k_new, v_new, wo_all, x, layer: int, *,
                                    prompt_lens, write_pos, prompt_pad: int, splits: int,
                                    wo_scale: Optional[torch.Tensor] = None,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Kernel 22 in its partition and order, in fp32: kernel C's chunked
    attention and merge (`decode_attention_fused_split_plain`: the new row
    written at write_pos in place, `splits` chunks of the valid columns, the
    current token folded in), a rounded to x's dtype, each rank's wo column
    slice (`attention_wo_plan`) of every kv head's partial (int8: times the
    column scale), the kv heads summed by `ordered_sum_plain` in head order,
    x added and one rounding. Reads write_pos and prompt_lens on the host: a
    mirror for the tests, not a path."""
    b, h, d = q.shape
    kh = k_all.shape[2]
    a = dec.decode_attention_fused_split_plain(
        q, k_all, v_all, k_new, v_new, layer, prompt_lens=prompt_lens, write_pos=write_pos,
        prompt_pad=prompt_pad, splits=splits, scale=scale)
    a = a.to(x.dtype).float().reshape(b, kh, h // kh * d)
    w = wo_all[layer].float().reshape(kh, h // kh * d, -1)
    dm = w.shape[-1]
    partial = torch.empty((kh, b, dm), dtype=torch.float32, device=x.device)
    for _, c0, c1 in attention_wo_plan(dm, splits, wo_all.element_size()):
        for k in range(kh):
            partial[k, :, c0:c1] = a[:, k] @ w[k, :, c0:c1]
    if wo_scale is not None:
        partial = partial * wo_scale[layer]
    return (x.float() + ordered_sum_plain(partial)).to(x.dtype)


# ---------------------------------------------------------------- checks


def _operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device: int) -> None:
    """Raise unless t is a contiguous, 16-byte aligned `shape` tensor of
    `dtype` on device index `device`."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if (t.shape != shape or not t.is_contiguous() or t.data_ptr() % 16
            or t.get_device() != device):
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {tuple(shape)} tensor "
                         f"on device {device}, got {tuple(t.shape)} on {t.device}")


def _check_x(x: torch.Tensor, multiple: int) -> Tuple[int, int]:
    """x a contiguous bf16 (B <= 32, D) matrix, D a multiple of `multiple`."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: the kernel takes bfloat16, got {x.dtype}")
    shape = x.shape
    if (len(shape) != 2 or not 1 <= shape[0] <= MAX_ROWS or shape[1] % multiple
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"x must be a contiguous, 16-byte aligned (B <= {MAX_ROWS}, D) matrix, "
                         f"D a multiple of {multiple}; got {tuple(shape)}")
    return shape[0], shape[1]


def _check_layer(layer: int, n_layers: int) -> None:
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range for {n_layers} layers")


def check_qkv_norm_rope(x, norm_all, weights, scales, tables, layer: int,
                        head_dim: int) -> None:
    """The operands of kernels 19 (scales None) and 20: x (B, D) bf16; the
    norm (L, D) bf16; wq (L, D, Hq), wk and wv (L, D, Hk), bf16 or int8 with
    fp32 (L, 1, N) scales; Hq and Hk multiples of head_dim = 64; fp32 rope
    tables (B, 64) or (B, N) (cosq, sinq, cosk, sink)."""
    if head_dim != HEAD_DIM:
        raise ValueError(f"kernels 19 and 20 are built for head_dim {HEAD_DIM}, got {head_dim}")
    b, d = _check_x(x, 8)
    dev = x.get_device()
    n_layers = norm_all.shape[0]
    _check_layer(layer, n_layers)
    _operand(norm_all, "norm", torch.bfloat16, (n_layers, d), dev)
    wdtype = torch.bfloat16 if scales is None else torch.int8
    for i, w in enumerate(weights):
        n = w.shape[-1]
        if n % HEAD_DIM:
            raise ValueError(f"weight {i}: {n} columns are not whole heads of {HEAD_DIM}")
        _operand(w, f"weight {i}", wdtype, (n_layers, d, n), dev)
        if scales is not None:
            _operand(scales[i], f"scale {i}", torch.float32, (n_layers, 1, n), dev)
        for t, name in zip(tables[2 * i: 2 * i + 2] if i < 2 else (), ("cos", "sin")):
            width = t.shape[-1]
            _operand(t, f"rope {name} {i}", torch.float32,
                     (b, HEAD_DIM if width == HEAD_DIM else n), dev)
    if weights[1].shape != weights[2].shape:
        raise ValueError(f"wk {tuple(weights[1].shape)} and wv {tuple(weights[2].shape)} differ")


def check_mlp_residual(x, norm_all, wg, wu, wd, scales, layer: int) -> None:
    """The operands of kernels 23 (scales None) and 21: x (B, D) bf16, D a
    multiple of 128; the norm (L, D) bf16; gate and up (L, D, M), down (L,
    M, D), M a multiple of 128, bf16 or int8 with fp32 scales (L, 1, M),
    (L, 1, M), (L, 1, D)."""
    b, d = _check_x(x, 128)
    dev = x.get_device()
    n_layers, m = wg.shape[0], wg.shape[-1]
    _check_layer(layer, n_layers)
    if m % 128:
        raise ValueError(f"the MLP width {m} is not a multiple of 128")
    _operand(norm_all, "norm", torch.bfloat16, (n_layers, d), dev)
    wdtype = torch.bfloat16 if scales is None else torch.int8
    shapes = ((n_layers, d, m), (n_layers, d, m), (n_layers, m, d))
    for w, shape, name in zip((wg, wu, wd), shapes, ("gate", "up", "down")):
        _operand(w, name, wdtype, shape, dev)
    if scales is not None:
        for s, shape, name in zip(scales, shapes, ("gate", "up", "down")):
            _operand(s, f"{name} scale", torch.float32, (n_layers, 1, shape[2]), dev)


def check_attention_wo(q, k_all, v_all, k_new, v_new, wo_all, x, layer: int, prompt_lens,
                       write_pos, wo_scale) -> None:
    """The operands of kernel 22: q (B, H, 64), k_new and v_new (B, K, 64),
    a (L, B, K, S, 64) bf16 cache, H / K in (1, 2, 4, 8), K <= 8; wo (L, H *
    64, Dm) bf16, or int8 with fp32 wo_scale (L, 1, Dm); x (B, Dm) bf16, Dm a
    multiple of 16, at most 4096; int32 prompt_lens (B,) and write_pos ()."""
    b, dm = _check_x(x, 16)
    if dm > 4096:
        raise ValueError(f"kernel 22 takes a residual width up to 4096, got {dm}")
    dev = x.get_device()
    if q.dim() != 3 or k_all.dim() != 5:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, D), the cache (L, B, K, S, D)")
    h, d = q.shape[1], q.shape[2]
    n_layers, kh, s = k_all.shape[0], k_all.shape[2], k_all.shape[3]
    if d != HEAD_DIM or h % kh or h // kh not in (1, 2, 4, 8) or kh > 8:
        raise ValueError(f"kernel 22 is built for head_dim {HEAD_DIM}, 1, 2, 4 or 8 query "
                         f"heads per kv head and at most 8 kv heads; got {d}, {h} / {kh}")
    _check_layer(layer, n_layers)
    _operand(q, "q", torch.bfloat16, (b, h, d), dev)
    for t, name in ((k_all, "k_all"), (v_all, "v_all")):
        _operand(t, name, torch.bfloat16, (n_layers, b, kh, s, d), dev)
    for t, name in ((k_new, "k_new"), (v_new, "v_new")):
        _operand(t, name, torch.bfloat16, (b, kh, d), dev)
    _operand(wo_all, "wo", torch.bfloat16 if wo_scale is None else torch.int8,
             (n_layers, h * d, dm), dev)
    if wo_scale is not None:
        _operand(wo_scale, "wo_scale", torch.float32, (n_layers, 1, dm), dev)
    for t, name, shape in ((prompt_lens, "prompt_lens", (b,)), (write_pos, "write_pos", ())):
        if t.dtype != torch.int32 or t.shape != shape or t.get_device() != dev:
            raise ValueError(f"{name} must be an int32 tensor of shape {shape} on {x.device}")


# ---------------------------------------------------------------- wrappers


def _qkv_launch(key, fn, x, norm_all, weights, scales, cosq, sinq, cosk, sink, layer, eps,
                head_dim):
    tables = (cosq, sinq, cosk, sink)
    check_qkv_norm_rope(x, norm_all, weights, scales, tables, layer, head_dim)
    b, d = x.shape
    n_layers, hq, hk = norm_all.shape[0], weights[0].shape[-1], weights[1].shape[-1]
    q, k, v = (torch.empty((b, n), dtype=x.dtype, device=x.device) for n in (hq, hk, hk))
    mats = [t for i, w in enumerate(weights) for t in ((w,) if scales is None else (w, scales[i]))]
    splits = qkv_card_splits(hq, hk, d, scales is not None, x.device)
    err = fn(x.data_ptr(), norm_all.data_ptr(), *(t.data_ptr() for t in mats),
             *(t.data_ptr() for t in tables), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             layer, n_layers, b, d, hq, hk, cosq.shape[-1], cosk.shape[-1], splits, eps,
             _build.stream_handle(x.device))
    _build.check(err, fn.__name__)
    launches[key] += 1
    return q, k, v


def layer_qkv_norm_rope(x, norm_all, wq_all, wk_all, wv_all, cosq, sinq, cosk, sink,
                        layer: int, *, eps: float, head_dim: int):
    """Kernel 19: RMSNorm(x) (rounded) @ wq/wk/wv[layer], rope on q and k;
    returns flat (B, Hq), (B, Hk), (B, Hk)."""
    if x.device.type == "cpu":
        return layer_qkv_norm_rope_plain(x, norm_all, wq_all, wk_all, wv_all, cosq, sinq, cosk,
                                         sink, layer, eps=eps, head_dim=head_dim)
    return _qkv_launch("19", _build.library().gar_qkv_norm_rope, x, norm_all,
                       (wq_all, wk_all, wv_all), None, cosq, sinq, cosk, sink, layer, eps,
                       head_dim)


def layer_qkv_norm_rope_q8(x, norm_all, wq_q8, sq, wk_q8, sk, wv_q8, sv, cosq, sinq, cosk, sink,
                           layer: int, *, eps: float, head_dim: int):
    """Kernel 20: kernel 19 over int8 (L, D, N) weights with fp32 (L, 1, N)
    column scales; xn stays fp32."""
    if x.device.type == "cpu":
        return layer_qkv_norm_rope_q8_plain(x, norm_all, wq_q8, sq, wk_q8, sk, wv_q8, sv, cosq,
                                            sinq, cosk, sink, layer, eps=eps, head_dim=head_dim)
    return _qkv_launch("20", _build.library().gar_qkv_norm_rope_q8, x, norm_all,
                       (wq_q8, wk_q8, wv_q8), (sq, sk, sv), cosq, sinq, cosk, sink, layer, eps,
                       head_dim)


def _counters(device: torch.device) -> torch.Tensor:
    """The device's arrival counters, zeroed once; every launch leaves them
    at 0."""
    counters = _COUNTERS.get(device.index)
    if counters is None:
        counters = _COUNTERS[device.index] = torch.zeros(COUNTERS_22 + 1024, dtype=torch.int32,
                                                         device=device)
    return counters


@functools.lru_cache(maxsize=None)
def _card_mlp_splits(tiles: int, d: int, rows: int, q8: bool, index: int) -> int:
    lib = _build.library()

    def fits(s: int) -> bool:  # every cluster resident at once, as the card counts them
        with torch.cuda.device(index):
            n = lib.gar_mlp_max_clusters(int(q8), rows, d, s)
        if n < 0:
            _build.check(-n, "gar_mlp_max_clusters")
        return n >= tiles

    return mlp_splits(tiles, d, 1 if q8 else 2, sms=_build.sm_count(index), fits=fits)


def mlp_card_splits(m: int, d: int, rows: int, q8: bool, device: torch.device) -> int:
    """`mlp_splits` on the card: its SM count, and clusters that fit in one
    wave for 16 or 32 rows (the kernel's two row tiles)."""
    return _card_mlp_splits(m // MLP_TILE, d, 16 if rows <= 16 else 32, q8, device.index)


def attention_wo_splits(batch: int, kv_heads: int, device: torch.device) -> int:
    """Kernel 22's CTAs a (kv head, row): kernel C's `card_splits`."""
    return dec.card_splits(batch, kv_heads, device)


def _mlp_launch(key, fn, x, norm_all, mats, layer, eps, q8):
    b, d = x.shape
    n_layers, m = mats[0].shape[0], mats[0].shape[-1]
    out = torch.empty_like(x)
    tiles = m // MLP_TILE  # a tile's slot, then a group's sum
    ws = torch.empty((tiles + -(-tiles // SUM_GROUP), b * d + MLP_SLOT_PAD), dtype=torch.float32,
                     device=x.device)
    counters = _counters(x.device)
    splits = mlp_card_splits(m, d, b, q8, x.device)
    err = fn(x.data_ptr(), norm_all.data_ptr(), *(t.data_ptr() for t in mats), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), layer, n_layers, b, d, m, splits, eps,
             _build.stream_handle(x.device))
    _build.check(err, fn.__name__)
    launches[key] += 1
    return out


def layer_mlp_residual(x, norm_all, wg_all, wu_all, wd_all, layer: int, *, eps: float):
    """Kernel 23: x + (SiLU(xn @ wg[layer]) * (xn @ wu[layer])) @ wd[layer],
    xn = RMSNorm(x) and act rounded to x's dtype; one launch."""
    if x.device.type == "cpu":
        return layer_mlp_residual_plain(x, norm_all, wg_all, wu_all, wd_all, layer, eps=eps)
    check_mlp_residual(x, norm_all, wg_all, wu_all, wd_all, None, layer)
    return _mlp_launch("23", _build.library().gar_mlp_residual, x, norm_all,
                       (wg_all, wu_all, wd_all), layer, eps, False)


def layer_mlp_residual_q8(x, norm_all, wg_q8, sg, wu_q8, su, wd_q8, sd, layer: int, *,
                          eps: float):
    """Kernel 21: kernel 23 over int8 weights with fp32 column scales; act
    stays fp32."""
    if x.device.type == "cpu":
        return layer_mlp_residual_q8_plain(x, norm_all, wg_q8, sg, wu_q8, su, wd_q8, sd, layer,
                                           eps=eps)
    check_mlp_residual(x, norm_all, wg_q8, wu_q8, wd_q8, (sg, su, sd), layer)
    return _mlp_launch("21", _build.library().gar_mlp_residual_q8, x, norm_all,
                       (wg_q8, sg, wu_q8, su, wd_q8, sd), layer, eps, True)


def decode_attention_wo(q, k_all, v_all, k_new, v_new, wo_all, x, layer: int, *,
                        prompt_lens, write_pos, prompt_pad: int,
                        wo_scale: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Kernel 22: writes k_new / v_new (B, K, D) at column write_pos of
    layer `layer` of the (L, B, K, S, D) cache in place, attends q (B, H, D)
    over [0, prompt_len) and [prompt_pad, write_pos] and returns x (B, Dm)
    + the attention output @ wo_all[layer] (int8 with wo_scale: the fp32
    sums scaled per output column). Contract of the cache layout:
    prompt_lens <= prompt_pad <= write_pos < S."""
    kw = dict(prompt_lens=prompt_lens, write_pos=write_pos, prompt_pad=prompt_pad,
              wo_scale=wo_scale, scale=scale)
    if x.device.type == "cpu":
        return decode_attention_wo_plain(q, k_all, v_all, k_new, v_new, wo_all, x, layer, **kw)
    check_attention_wo(q, k_all, v_all, k_new, v_new, wo_all, x, layer, prompt_lens, write_pos,
                       wo_scale)
    b, h, d = q.shape
    n_layers, _, kh, s = k_all.shape[:4]
    dm = x.shape[1]
    out = torch.empty_like(x)
    ws = torch.empty((b, kh, dm), dtype=torch.float32, device=x.device)  # a (row, kv head)'s slot
    counters = _counters(x.device)[COUNTERS_22:]
    q8 = wo_scale is not None
    err = _build.library().gar_decode_attention_wo(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        wo_all.data_ptr(), wo_scale.data_ptr() if q8 else None, x.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), prompt_lens.data_ptr(), write_pos.data_ptr(), layer,
        n_layers, b, h, kh, s, d, dm, prompt_pad, int(q8), attention_wo_splits(b, kh, x.device),
        d ** -0.5 if scale is None else scale, _build.stream_handle(x.device))
    _build.check(err, "gar_decode_attention_wo")
    launches["22"] += 1
    return out
