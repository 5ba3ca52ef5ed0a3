"""Kernels 17 and 18: the flash attention backward (FA-2), causal or full,
GQA, segment ids.

Replaces `grasp_any_region_tpu/ops/flash_backward.py:flash_attention_bwd`
(`_dq_kernel`, `_dkv_kernel` and the XLA delta). The TPU form makes two
passes, each recomputing S = Q K^T and dP = dO V^T (a TPU core has no
atomics). On Hopper (csrc/flash_backward_sm90.cu) it is one pass with five
wgmma products per (64 queries, 128 keys) pair:

- 17, two launches around 18: `bwd_prep` reads O and dO once and writes
  delta = rowsum(dO * O), fp32 (B, H, Sq), and a zeroed fp32 (B, Sq, H, D)
  dq workspace; `bwd_dq_cast` writes dq = bf16(workspace * scale). Its
  plain version is `bwd_delta` and a cast. Bound by bytes.
- 18, `flash_attention_bwd_dkv`: one CTA per (128 keys, kv head, batch),
  heaviest key tiles first, walks the causal band of 64-row query tiles of
  every query head of its GQA group (TMA ring, a producer warp, two
  consumer warpgroups): dk and dv leave the CTA summed over the group
  (deterministic), and each pair's dq share is added into the workspace
  by TMA fp32 reduce-adds (so dq is not bit-reproducible). Bound by its
  products. Non-causal without segment ids (kernel 5, the ViT backward,
  S = 1025) the <= 16 keys past the last full 128-key tile are folded
  into that tile's CTA rather than given a CTA of their own.

Nothing (Sq, Sk)-sized is stored, so memory is O(S), as the reference's
16k training context needs. Conventions match `ops/flash_attention.py`:
the right-aligned causal offset Sk - Sq, keys past Sk masked, GQA, segment
ids (Sq == Sk; a 64-row query tile and a 128-key tile whose [min, max] id
ranges are disjoint are skipped). On a CPU tensor `flash_attention_bwd`
runs `flash_attention_bwd_plain`; on a CUDA tensor it launches 17, 18, 17
on the current stream or raises.

Head dims: 64 (GAR-1B) and 128 (GAR-8B's decoder) with every mask, 96
(GAR-8B's PE-G tower) for kernel 5 only, full attention without segment
ids; any other raises before a launch. Above 64 a key row is two 128-byte
swizzle atoms (96 rides on 128's, TMA zero-filling columns 96-127), a
step of 18 takes 32 query rows (`bwd_query_tile`), and no tail is folded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import attention_mask, check_segments, segment_tiles

launches_dq = 0  # kernel 17 since the last reset: one a backward call, counted at its cast
launches_dkv = 0  # kernel 18
launches_segments = 0  # launches of 18 with segment ids

BWD_KEY_TILE = 128  # keys per CTA of kernel 18 (its segment-skip granularity)


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal: bool = True,
                              segment_ids: Optional[torch.Tensor] = None):
    """Kernels 17 and 18's plain version (and kernel 5's, non-causal): the
    FA-2 backward recurrences in fp32, one kv head at a time (so a
    long sequence needs group x Sq x Sk floats at once, not H x):
    p = exp(scale q k^T - lse) masked, dv = p^T dO, dp = dO v^T,
    ds = p (dp - delta), dq = scale ds k, dk = scale ds^T q, with
    delta = rowsum(dO O). q, out, g (B, Sq, H, D); k, v (B, Sk, K, D);
    lse (B, H, Sq). Returns (dq, dk, dv) in the input dtypes. p is rounded
    to g's dtype and ds to q's before their products, where the Pallas
    kernels (and, at bf16, the CUDA kernels) round them: at fp32 inputs
    nothing is rounded."""
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
        pr = p.to(g.dtype).float()
        dv[:, :, j] = torch.matmul(pr.transpose(-1, -2), gf).sum(1)
        del pr
        ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[:, hs, :, None])
        ds = ds.to(q.dtype).float()
        dq[:, :, hs] = (torch.matmul(ds, kf) * scale).permute(0, 2, 1, 3)
        dk[:, :, j] = torch.matmul(ds.transpose(-1, -2), qf).sum(1) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_HEAD_DIMS = (64, 96, 128)  # the backward kernels' instances (GAR-1B, GAR-8B)
FULL_ONLY_HEAD_DIMS = (96,)  # kernel 5's alone (GAR-8B's tower): no mask, no segment ids


def check_backward_head_dim(d: int, kernels: str, *, causal: bool = False,
                            segments: bool = False) -> None:
    """Raise unless the backward kernels (5, or 17 and 18) have an instance
    for head dim d with this mask, so that a train step without one raises
    here rather than falling back."""
    if d not in BWD_HEAD_DIMS or (d in FULL_ONLY_HEAD_DIMS and (causal or segments)):
        raise ValueError(f"{kernels} is built for head dims {BWD_HEAD_DIMS} ({d} without a "
                         f"mask or segment ids only for {FULL_ONLY_HEAD_DIMS}), got {d} with "
                         f"causal={causal}, segment ids={segments}")


def bwd_query_tile(d: int) -> int:
    """Query rows a step of kernel 18 (its segment-skip granularity for
    queries): 64 at head dim 64; 32 above it, where dK and dV take 128
    registers a thread."""
    return 64 if d == 64 else 32


def bwd_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out) in fp32, (B, S, H, D) -> (B, H, S) contiguous:
    kernel 17's plain prep."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def bwd_prep(out: torch.Tensor, g: torch.Tensor):
    """Kernel 17, first launch: (delta, dq workspace) from the forward's
    output and its cotangent, both (B, Sq, H, D) bf16, D in BWD_HEAD_DIMS:
    delta (B, H, Sq) fp32 and a zeroed fp32 (B, Sq, H, D) workspace for
    kernel 18."""
    if out.shape != g.shape or out.shape[-1] not in BWD_HEAD_DIMS or out.device != g.device:
        raise ValueError(f"bad shapes: out {out.shape}, g {g.shape} (head dims {BWD_HEAD_DIMS})")
    for x, name in ((out, "out"), (g, "g")):
        _build.check_operand(x, name)
    b, sq, h, d = out.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    dq_acc = torch.empty((b, sq, h, d), dtype=torch.float32, device=out.device)
    _build.check(_build.library().gar_flash_bwd_prep(
        out.data_ptr(), g.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), b, sq, h, d,
        *out.stride()[:3], *g.stride()[:3], _build.stream_handle(out.device)),
        "gar_flash_bwd_prep")
    return delta, dq_acc


def bwd_dq_cast(dq_acc: torch.Tensor) -> torch.Tensor:
    """Kernel 17, second launch: dq = bf16(workspace * head_dim ** -0.5)."""
    if dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous():
        raise TypeError("kernel 17 casts a contiguous fp32 workspace to bfloat16")
    dq = torch.empty(dq_acc.shape, dtype=torch.bfloat16, device=dq_acc.device)
    _build.check(_build.library().gar_flash_bwd_dq_cast(
        dq_acc.data_ptr(), dq.data_ptr(), dq_acc.numel(), dq_acc.shape[-1] ** -0.5,
        _build.stream_handle(dq_acc.device)), "gar_flash_bwd_dq_cast")
    global launches_dq
    launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, dq_acc, *, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None):
    """Kernel 18: (dk, dv), (B, Sk, K, D), summed over each kv head's group,
    from q, k, v, the cotangent g, the forward's LSE and delta (both (B, H,
    Sq) fp32); adds the unscaled dq into dq_acc (`bwd_prep`'s workspace)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or h % kh:
        raise ValueError(f"bad shapes: q {q.shape}, k {k.shape}, v {v.shape}")
    if g.shape != q.shape or tuple(lse.shape) != (b, h, sq) or tuple(delta.shape) != (b, h, sq):
        raise ValueError(f"bad shapes: g {g.shape}, lse {lse.shape}, delta {delta.shape}")
    check_backward_head_dim(d, "kernels 17 and 18 (the flash backward)", causal=causal,
                            segments=segment_ids is not None)
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq, got {sk} < {sq}")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g"), (lse, "lse"), (delta, "delta")):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    # TMA reads q, k, v and g: 16-byte aligned bases, strides of 16 bytes
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g")):
        _build.check_operand(x, name)
    for x, name in ((lse, "lse"), (delta, "delta")):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{name}: the kernels take a contiguous fp32 (B, H, Sq) tensor")
    if tuple(dq_acc.shape) != (b, sq, h, d) or dq_acc.dtype != torch.float32 \
            or not dq_acc.is_contiguous() or dq_acc.device != q.device:
        raise TypeError(f"dq_acc: kernel 18 adds into a contiguous fp32 {(b, sq, h, d)} tensor")
    seg = q_tiles = k_tiles = None
    if segment_ids is not None:
        seg = check_segments(segment_ids, b, sq, sk)
        if seg.device != q.device:
            raise ValueError(f"segment ids are on {seg.device}, q on {q.device}")
        q_tiles, k_tiles = segment_tiles(seg, bwd_query_tile(d)), segment_tiles(seg, BWD_KEY_TILE)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    ptr = [None if x is None else x.data_ptr() for x in (seg, q_tiles, k_tiles)]
    _build.check(_build.library().gar_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *ptr, dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
        kh, d, int(causal), _build.strides_arg(q, k, v, g), d ** -0.5,
        _build.stream_handle(q.device)), "gar_flash_bwd_dkv")
    global launches_dkv, launches_segments
    launches_dkv += 1
    launches_segments += seg is not None
    return dk, dv


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
    delta, dq_acc = bwd_prep(out, g)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, dq_acc, causal=causal,
                                     segment_ids=segment_ids)
    return bwd_dq_cast(dq_acc), dk, dv
