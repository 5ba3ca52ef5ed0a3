"""Kernels 17 and 18: the flash attention backward (FA-2), causal or full,
GQA, segment ids.

Replaces `grasp_any_region_tpu/ops/flash_backward.py:flash_attention_bwd`
(`_dq_kernel`, `_dkv_kernel`). The forward saves the per-row log-sum-exp
(kernel B with `return_lse`); here delta = rowsum(dO * O) is computed in
fp32 plain torch, as the JAX package computes it outside Pallas, and two
CUDA kernels (csrc/flash_backward.cu) recompute each 64 x 64 probability
block from the LSE: 17 walks the causal band of 64-key tiles for 64 query
rows (dq), 18 the band's query tiles for 64 keys over every query head of
a GQA group (dk, dv summed per kv head in the block). Neither stores
anything (Sq, Sk)-sized, so memory is O(S), as the reference's 16k training
context needs. Both are bound by their tensor-core products (17: three,
18: four over the causal half).

Conventions match `ops/flash_attention.py` exactly: the right-aligned
causal offset Sk - Sq, keys past Sk masked, GQA, segment ids (Sq == Sk).
On a CPU tensor `flash_attention_bwd` runs `flash_attention_bwd_plain`; on
a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import attention_mask, check_segments, segment_tiles

launches_dq = 0  # kernel 17 launches since the last reset (chip_smoke.py reads them)
launches_dkv = 0  # kernel 18
launches_segments = 0  # launches of 17 or 18 with segment ids


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal: bool = True,
                              segment_ids: Optional[torch.Tensor] = None):
    """Kernels 17 and 18's plain version (and kernel 5's, non-causal): the
    FA-2 backward recurrences in fp32, one kv head at a time (so a
    long sequence needs group x Sq x Sk floats at once, not H x):
    p = exp(scale q k^T - lse) masked, dv = p^T dO, dp = dO v^T,
    ds = p (dp - delta), dq = scale ds k, dk = scale ds^T q, with
    delta = rowsum(dO O). q, out, g (B, Sq, H, D); k, v (B, Sk, K, D);
    lse (B, H, Sq). Returns (dq, dk, dv) in the input dtypes."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    group = h // kh
    scale = d ** -0.5
    delta = bwd_delta(out, g)
    mask = attention_mask(sq, sk, causal, segment_ids, q.device)
    mask = None if mask is None else mask[:, 0]  # (B|1, 1, Sq, Sk)
    dq = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, sk, kh, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for j in range(kh):
        hs = slice(j * group, (j + 1) * group)
        qf = q[:, :, hs].float().permute(0, 2, 1, 3)  # (B, G, Sq, D)
        gf = g[:, :, hs].float().permute(0, 2, 1, 3)
        kf = k[:, :, j].float()[:, None]  # (B, 1, Sk, D)
        vf = v[:, :, j].float()[:, None]
        p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[:, hs, :, None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dv[:, :, j] = torch.matmul(p.transpose(-1, -2), gf).sum(1)
        ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[:, hs, :, None])
        dq[:, :, hs] = (torch.matmul(ds, kf) * scale).permute(0, 2, 1, 3)
        dk[:, :, j] = torch.matmul(ds.transpose(-1, -2), qf).sum(1) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _args(q, k, v, lse, g, delta, causal, segment_ids):
    """Check the operands and return (C arguments before the outputs, after
    them, the segment tensors to hold until the launch)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or h % kh:
        raise ValueError(f"bad shapes: q {q.shape}, k {k.shape}, v {v.shape}")
    if g.shape != q.shape or tuple(lse.shape) != (b, h, sq) or tuple(delta.shape) != (b, h, sq):
        raise ValueError(f"bad shapes: g {g.shape}, lse {lse.shape}, delta {delta.shape}")
    if d != 64:
        raise ValueError(f"kernels 17 and 18 are built for head_dim 64, got {d}")
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq, got {sk} < {sq}")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g"), (lse, "lse"), (delta, "delta")):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g")):
        _build.check_operand(x, name)
    for x, name in ((lse, "lse"), (delta, "delta")):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{name}: the kernels take a contiguous fp32 (B, H, Sq) tensor")
    seg = tiles = None
    if segment_ids is not None:
        seg = check_segments(segment_ids, b, sq, sk)
        if seg.device != q.device:
            raise ValueError(f"segment ids are on {seg.device}, q on {q.device}")
        tiles = segment_tiles(seg)
    before = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), None if seg is None else seg.data_ptr(),
              None if tiles is None else tiles.data_ptr())
    after = (b, sq, sk, h, kh, d, int(causal), _build.strides_arg(q, k, v, g), d ** -0.5,
             _build.stream_handle(q.device))
    return before, after, (seg, tiles)


def flash_attention_bwd_dq(q, k, v, g, lse, delta, *, causal: bool = True,
                           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 17: dq (B, Sq, H, D) from q, k, v, the cotangent g, the
    forward's LSE and delta = rowsum(g * out), both (B, H, Sq) fp32."""
    before, after, (seg, tiles) = _args(q, k, v, lse, g, delta, causal, segment_ids)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check(_build.library().gar_flash_attention_bwd_dq(*before, dq.data_ptr(), *after),
                 "gar_flash_attention_bwd_dq")
    global launches_dq, launches_segments
    launches_dq += 1
    launches_segments += seg is not None
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, *, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None):
    """Kernel 18: (dk, dv), (B, Sk, K, D), summed over each kv head's group."""
    before, after, (seg, tiles) = _args(q, k, v, lse, g, delta, causal, segment_ids)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _build.check(_build.library().gar_flash_attention_bwd_dkv(
        *before, dk.data_ptr(), dv.data_ptr(), *after), "gar_flash_attention_bwd_dkv")
    global launches_dkv, launches_segments
    launches_dkv += 1
    launches_segments += seg is not None
    return dk, dv


def bwd_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out) in fp32, (B, S, H, D) -> (B, H, S) contiguous."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, *, causal: bool = True, segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from its saved q, k, v, output and
    (B, H, Sq) LSE, and the output's cotangent g. dk and dv are per kv head."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                         segment_ids=segment_ids)
    if out.shape != q.shape:
        raise ValueError(f"bad shapes: out {out.shape}, q {q.shape}")
    g = g.contiguous()
    delta = bwd_delta(out, g)
    kw = dict(causal=causal, segment_ids=segment_ids)
    return (flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
            *flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw))
