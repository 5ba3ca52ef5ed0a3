"""Kernels C and C8: decode attention with the KV append, on the stacked
cache, bf16 (C) or int8 (C8).

Replaces `grasp_any_region_tpu/ops/decode_attention.py:decode_attention_fused`
(`_fused_kernel`, the unpaired (L, B, K, S, D) layout; D 64 at GAR-1B, 128
at GAR-8B, where a cache row is 256 bytes). One query token per
row attends over layer `layer` of the cache with the mask
[0, prompt_len) ∪ [prompt_pad, write_pos), the current token is folded in
from `k_new` / `v_new`, and those are written at column `write_pos` of
(layer, b, k) in place.

The step does ~2 flops per cache byte, so it is bound by how fast the valid
cache columns stream in. The CUDA kernel (csrc/decode_attention.cu, body in
csrc/decode_split.cuh) runs one thread-block cluster per (kv head, batch
row), whose `splits` CTAs each stream an equal, contiguous chunk of the
valid columns (read as one flat index over the two intervals, so the gap
[prompt_len, prompt_pad) is never loaded) and score all H / K query heads
of the kv head against each K row on the tensor cores; the CTAs merge
their partial softmax sums over distributed shared memory, in rank order,
in the same launch. `decode_splits` picks `splits` so that the clusters
fill up to two waves of the card's SMs (8 at B = 1-4 with 8 kv heads, 2 at
B = 24), and `decode_attention_fused_split_plain` mirrors the split
arithmetic on any device. `prompt_lens` and `write_pos` stay on the device,
read inside the kernel, so the decode loop needs no host sync.

C8 replaces the int8-KV branch of the same JAX function
(`_fused_kernel_paired` with kv_q8, via `_decode_fused_paired_call`) on
the port's unpaired layout, with the reference's scale granularity: an
int8 (L, B, K, S, D) cache and fp32 scales (L, B, K/2, 1, 1), one per
kv-head pair, head k reading scale k // 2. The history is dequantized as
the TPU kernel does it, bf16(int8 * scale); the new K/V (bf16) are
quantized with the static scale, clip(round(x / s), -127, 127), written
at write_pos, and the current token enters the attention as its
dequantized fp32 value q * s, so this step sees what later steps read
back. It runs C's split-KV body on an int8 cache (its stages land as
int8, half of C's bytes, and each warp widens its own rows to bf16 before
C's tensor-core products), over `card_splits` CTAs a (kv head, row) as
C, at most MAX_SPLITS_Q8 (16 at B = 1-2 with 8 kv heads), at head dim 64
only (GAR-8B's int8 cache waits for its instance);
`decode_attention_fused_q8_split_plain` mirrors its chunks. (Kernel
22 of the mega step, ops/decode_megakernel.py, runs C's split body with
its own wo epilogue.)

On a CPU tensor the wrapper runs `decode_attention_fused_plain` (or
`decode_attention_fused_q8_plain`); on a CUDA tensor it launches the
kernel or raises. Both update the cache in place and return only the
attention output.

Kernel 16 replaces `decode_attention` and `decode_attention_stacked`
(`_decode_kernel` via `_decode_call`) with the same names and arguments:
C's split-KV body read only, over a bf16 cache that already holds the
current token at write_pos, at the layer that a () int32 device tensor
picks out of the stacked cache, so neither wrapper waits for the host; the
same `card_splits` CTAs a (kv head, row) as C, and
`decode_attention_split_plain` mirrors its chunks on any device. No JAX
path dispatches it (the XLA decode step attends through
`decode_attention_reference`), so none here does either.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, decode_attention_reference

launches = 0  # kernel C launches since the last reset (chip_smoke.py reads it)
launches_q8 = 0  # kernel C8 launches
launches_stacked = 0  # kernel 16 launches


def decode_attention_fused_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor, layer: int, *,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int,
) -> torch.Tensor:
    """`index_copy_` of the new row into the layer slab at the device
    write_pos (in place: no cache copy, no host sync), then
    `decode_attention_reference` over that slab."""
    idx = write_pos.reshape(1).long()
    k_all[layer].index_copy_(2, idx, k_new.to(k_all.dtype)[:, :, None, :])
    v_all[layer].index_copy_(2, idx, v_new.to(v_all.dtype)[:, :, None, :])
    return decode_attention_reference(
        q, k_all[layer], v_all[layer], prompt_lens=prompt_lens,
        write_pos=write_pos, prompt_pad=prompt_pad)


HEAD_DIMS = (64, 128)  # kernel C's instances: GAR-1B's decoder, GAR-8B's
HEAD_DIMS_Q8 = (64,)  # kernel C8's instance
MAX_SPLITS = 8  # the portable cluster size; 16 measured slower at B = 1, 2 on an H100 (PERF.md)
MAX_SPLITS_Q8 = 16  # C8 (half the bytes a column): 16 measured faster than 8 at B = 1 (PERF.md)


def decode_splits(batch: int, kv_heads: int, *, sms: int = 132,
                  max_splits: int = MAX_SPLITS) -> int:
    """Kernel C's (C8's) CTAs per (kv head, batch row): the largest power of
    two up to `max_splits` such that batch * kv_heads * splits stays within
    two waves of `sms` SMs, and at least 2. GAR-1B's 8 kv heads: C 8 at B =
    1-4, C8 16 at B = 1-2 and 8 at B = 3-4, both 2 at B = 24. (The kernel
    takes 1-16: on an H100 at B = 1 and 2, 16 CTAs a (kv head, row) took
    longer than 8 for C, and less for C8.)"""
    splits = 2
    while splits * 2 <= max_splits and batch * kv_heads * splits * 2 <= 2 * sms:
        splits *= 2
    return splits


def valid_columns(prompt_len: int, prompt_pad: int, write_pos: int, seq: int) -> list[int]:
    """The cache columns kernel C attends over for one row, in the order of
    its flat index: [0, min(prompt_len, prompt_pad)), then [prompt_pad,
    write_pos) (both cut at seq and at write_pos)."""
    hi = min(write_pos, seq)
    n1 = max(min(prompt_len, prompt_pad, hi), 0)
    return list(range(n1)) + list(range(prompt_pad, max(hi, prompt_pad)))


def split_bounds(total: int, splits: int) -> list[tuple[int, int]]:
    """The flat-index chunk [f0, f1) of each CTA of a cluster: equal and
    contiguous, ceil(total / splits) long, the last ones shorter or empty."""
    chunk = -(-total // splits)
    return [(min(total, r * chunk), min(total, (r + 1) * chunk)) for r in range(splits)]


def decode_attention_fused_split_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor, layer: int, *,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int, splits: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel C's split arithmetic in torch (the logits times `scale`, by
    default D^-0.5, as kernels C and 22 take them): the new row written at write_pos
    (in place), then for each row the valid columns cut into `splits`
    chunks as the kernel cuts them (`valid_columns`, `split_bounds`); each
    chunk's (m, l, acc) with p = exp(s - the chunk's max) rounded to v's
    dtype before PV (the kernel rounds against the running max of each
    warp's 16 keys, which only shifts where bf16 rounds); the chunks merged
    in order with the current token from k_new / v_new. Reads write_pos
    and prompt_lens on the host: a mirror for the tests, not a path."""
    kc, vc = k_all[layer], v_all[layer]
    idx = write_pos.reshape(1).long()
    kc.index_copy_(2, idx, k_new.to(k_all.dtype)[:, :, None, :])
    vc.index_copy_(2, idx, v_new.to(v_all.dtype)[:, :, None, :])
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, kh, h // kh, d)
    wpos = int(write_pos)
    rows = []
    for r in range(b):
        cols = torch.tensor(valid_columns(int(prompt_lens[r]), prompt_pad, wpos, s),
                            dtype=torch.long, device=q.device)
        s_cur = (qf[r] * k_new[r].float()[:, None, :]).sum(-1) * scale  # (K, G)
        parts = []
        for f0, f1 in split_bounds(len(cols), splits):
            if f0 == f1:  # an empty chunk (m = -inf) weighs nothing
                continue
            k_chunk, v_chunk = kc[r][:, cols[f0:f1]], vc[r][:, cols[f0:f1]]  # (K, n, D)
            logits = torch.einsum("kgd,knd->kgn", qf[r], k_chunk.float()) * scale
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            acc = torch.einsum("kgn,knd->kgd", p.to(v_all.dtype).float(), v_chunk.float())
            parts.append((m, p.sum(-1), acc))
        m_all = torch.stack([s_cur] + [m for m, _, _ in parts]).amax(0)
        p_cur = torch.exp(s_cur - m_all)
        den, acc = p_cur, p_cur[..., None] * v_new[r].float()[:, None, :]
        for m, l_part, acc_part in parts:
            f = torch.exp(m - m_all)
            den, acc = den + f * l_part, acc + f[..., None] * acc_part
        rows.append(acc / torch.clamp(den, min=1e-30)[..., None])
    return torch.stack(rows).reshape(b, h, d).to(q.dtype)


def card_splits(batch: int, kv_heads: int, device: torch.device,
                max_splits: int = MAX_SPLITS) -> int:
    """`decode_splits` with the SM count of the card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return decode_splits(batch, kv_heads, sms=_build.sm_count(index), max_splits=max_splits)


def _pair_scales(scale: torch.Tensor, layer: int) -> torch.Tensor:
    """(L, B, K/2, 1, 1) -> layer's (B, K, 1, 1): head k takes pair k // 2."""
    return scale[layer].repeat_interleave(2, dim=1)


def decode_attention_fused_q8_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor, layer: int, *,
    k_scale: torch.Tensor, v_scale: torch.Tensor,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int,
) -> torch.Tensor:
    """Kernel C8's arithmetic in torch, after the TPU kernel with the
    history in one block: quantize the new column and write it in place
    (index_copy_ at the device write_pos); attend over the history
    [0, prompt_len) and [prompt_pad, write_pos) of the dequantized bf16
    slab, p = exp(s - the history's max) rounded to bf16 before PV; then
    fold in the current token from its dequantized fp32 K/V, p unrounded,
    rescaling the history's sums in fp32."""
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    g = h // kh
    ks, vs = _pair_scales(k_scale, layer), _pair_scales(v_scale, layer)  # (B, K, 1, 1)
    kq = torch.clamp(torch.round(k_new.float() / ks[..., 0]), -127, 127)  # (B, K, D)
    vq = torch.clamp(torch.round(v_new.float() / vs[..., 0]), -127, 127)
    idx = write_pos.reshape(1).long()
    k_all[layer].index_copy_(2, idx, kq.to(torch.int8)[:, :, None, :])
    v_all[layer].index_copy_(2, idx, vq.to(torch.int8)[:, :, None, :])
    kc = (k_all[layer].float() * ks).to(torch.bfloat16).float()  # (B, K, S, D)
    vc = (v_all[layer].float() * vs).to(torch.bfloat16).float()
    scale = d ** -0.5
    qf = q.float().reshape(b, kh, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, kc) * scale
    ids = torch.arange(s, device=q.device)[None, :]
    valid = (ids < prompt_lens[:, None]) | ((ids >= prompt_pad) & (ids < write_pos))
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m_hist = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m_hist)
    l_hist = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(torch.bfloat16).float(), vc)
    k_cur, v_cur = (kq * ks[..., 0])[:, :, None, :], (vq * vs[..., 0])[:, :, None, :]
    s_cur = (qf * k_cur).sum(-1, keepdim=True) * scale  # (B, K, G, 1)
    m = torch.maximum(m_hist, s_cur)
    alpha, p_cur = torch.exp(m_hist - m), torch.exp(s_cur - m)
    denom = l_hist * alpha + p_cur
    acc = acc * alpha + p_cur * v_cur
    return (acc / torch.clamp(denom, min=1e-30)).reshape(b, h, d).to(q.dtype)


def decode_attention_fused_q8_split_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor, layer: int, *,
    k_scale: torch.Tensor, v_scale: torch.Tensor,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int, splits: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel C8's split arithmetic in torch: the new column quantized
    with the pair's scale and written at write_pos (in place); the layer's
    history dequantized to bf16(int8 * scale) and cut into `splits` chunks
    as kernel C cuts it (`valid_columns`, `split_bounds`), each chunk's (m,
    l, acc) with p = exp(s - the chunk's max) rounded to bf16 before PV;
    the chunks merged in order with the current token's dequantized fp32
    K/V (`quantize(x) * scale`), p unrounded. Reads write_pos and
    prompt_lens on the host: a mirror for the tests, not a path."""
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    scale = d ** -0.5 if scale is None else scale
    ks, vs = _pair_scales(k_scale, layer), _pair_scales(v_scale, layer)  # (B, K, 1, 1)
    kq = torch.clamp(torch.round(k_new.float() / ks[..., 0]), -127, 127)  # (B, K, D)
    vq = torch.clamp(torch.round(v_new.float() / vs[..., 0]), -127, 127)
    idx = write_pos.reshape(1).long()
    k_all[layer].index_copy_(2, idx, kq.to(torch.int8)[:, :, None, :])
    v_all[layer].index_copy_(2, idx, vq.to(torch.int8)[:, :, None, :])
    kc = (k_all[layer].float() * ks).to(torch.bfloat16).float()  # (B, K, S, D)
    vc = (v_all[layer].float() * vs).to(torch.bfloat16).float()
    k_cur, v_cur = kq * ks[..., 0], vq * vs[..., 0]  # (B, K, D)
    qf = q.float().reshape(b, kh, h // kh, d)
    wpos = int(write_pos)
    rows = []
    for r in range(b):
        cols = torch.tensor(valid_columns(int(prompt_lens[r]), prompt_pad, wpos, s),
                            dtype=torch.long, device=q.device)
        s_cur = (qf[r] * k_cur[r][:, None, :]).sum(-1) * scale  # (K, G)
        parts = []
        for f0, f1 in split_bounds(len(cols), splits):
            if f0 == f1:  # an empty chunk (m = -inf) weighs nothing
                continue
            logits = torch.einsum("kgd,knd->kgn", qf[r], kc[r][:, cols[f0:f1]]) * scale
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            acc = torch.einsum("kgn,knd->kgd", p.to(torch.bfloat16).float(),
                               vc[r][:, cols[f0:f1]])
            parts.append((m, p.sum(-1), acc))
        m_all = torch.stack([s_cur] + [m for m, _, _ in parts]).amax(0)
        p_cur = torch.exp(s_cur - m_all)
        den, acc = p_cur, p_cur[..., None] * v_cur[r][:, None, :]
        for m, l_part, acc_part in parts:
            f = torch.exp(m - m_all)
            den, acc = den + f * l_part, acc + f[..., None] * acc_part
        rows.append(acc / torch.clamp(den, min=1e-30)[..., None])
    return torch.stack(rows).reshape(b, h, d).to(q.dtype)


def check_fused(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, layer: int,
                prompt_lens: torch.Tensor, write_pos: torch.Tensor,
                k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor]) -> None:
    """Raise unless kernel C (a bf16 cache) or C8 (an int8 one) takes these
    operands as they are: the shapes of the cache contract, head dim in
    HEAD_DIMS (C) or HEAD_DIMS_Q8 (C8), 1, 2, 4 or 8 query heads a kv head,
    the layer in range, contiguous tensors of the kernels' dtypes on q's
    device, one fp32 scale per (layer, batch row, kv-head pair) for C8, and
    prompt_lens and write_pos as int32 tensors there. Reads attributes
    only: it runs on any device, so the CPU tests reach it."""
    q8 = k_all.dtype == torch.int8
    b, h, d = q.shape
    n_layers, _, kh, s, _ = k_all.shape
    if (k_all.shape[1] != b or k_all.shape[4] != d or v_all.shape != k_all.shape
            or k_new.shape != (b, kh, d) or v_new.shape != (b, kh, d) or h % kh):
        raise ValueError(f"bad shapes: q {q.shape}, cache {k_all.shape}, "
                         f"k_new {k_new.shape}, v_new {v_new.shape}")
    if q8 and d not in HEAD_DIMS_Q8:
        raise ValueError(f"kernel C8 (the int8 KV cache) is built for head dims "
                         f"{HEAD_DIMS_Q8}, got {d}: an int8 cache at this head dim waits "
                         "for its instance")
    if d not in HEAD_DIMS or h // kh not in (1, 2, 4, 8):
        raise ValueError(f"kernel C is built for head dims {HEAD_DIMS} and 1, 2, 4 or 8 "
                         f"query heads per kv head, got {d} and {h // kh}")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range for {n_layers} layers")
    operands = [(q, "q", torch.bfloat16), (k_all, "k_all", k_all.dtype if q8 else torch.bfloat16),
                (v_all, "v_all", k_all.dtype if q8 else torch.bfloat16),
                (k_new, "k_new", torch.bfloat16), (v_new, "v_new", torch.bfloat16)]
    if q8:
        operands += [(k_scale, "k_scale", torch.float32), (v_scale, "v_scale", torch.float32)]
    for x, name, dtype in operands:
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q8 and not k_scale.shape == v_scale.shape == (n_layers, b, kh // 2, 1, 1):
        raise ValueError(f"scales {tuple(k_scale.shape)}, {tuple(v_scale.shape)}: one per "
                         f"(layer, batch row, kv-head pair), {(n_layers, b, kh // 2, 1, 1)}")
    for x, name, shape in ((prompt_lens, "prompt_lens", (b,)),
                           (write_pos, "write_pos", ())):
        if x.dtype != torch.int32 or tuple(x.shape) != shape or x.device != q.device:
            raise ValueError(f"{name} must be an int32 tensor of shape {shape} "
                             f"on {q.device}")


def decode_attention_fused(
    q: torch.Tensor,  # (B, H, D)
    k_all: torch.Tensor,  # (L, B, K, S, D) stacked cache, bf16 or int8, updated in place
    v_all: torch.Tensor,
    k_new: torch.Tensor,  # (B, K, D) current token
    v_new: torch.Tensor,
    layer: int,
    *,
    prompt_lens: torch.Tensor,  # (B,) int32, on the cache's device
    write_pos: torch.Tensor,  # () int32, on the cache's device
    prompt_pad: int,
    k_scale: torch.Tensor | None = None,  # int8 caches: (L, B, K/2, 1, 1) fp32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns (B, H, D). Contract of the cache layout:
    prompt_lens <= prompt_pad <= write_pos < S. An int8 cache (kernel C8)
    needs its scales, and an even K. On the card `check_fused` says what
    the kernels take."""
    q8 = k_all.dtype == torch.int8
    if q8 and (k_scale is None or v_scale is None):
        raise ValueError("an int8 cache needs its k_scale and v_scale")
    if q8 and k_all.shape[2] % 2:
        raise ValueError(f"an int8 cache pairs kv heads; {k_all.shape[2]} kv heads is odd")
    kw = dict(prompt_lens=prompt_lens, write_pos=write_pos, prompt_pad=prompt_pad)
    if q.device.type == "cpu":
        if q8:
            return decode_attention_fused_q8_plain(q, k_all, v_all, k_new, v_new, layer,
                                                   k_scale=k_scale, v_scale=v_scale, **kw)
        return decode_attention_fused_plain(q, k_all, v_all, k_new, v_new, layer, **kw)
    check_fused(q, k_all, v_all, k_new, v_new, layer, prompt_lens, write_pos, k_scale, v_scale)
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    prompt_lens = prompt_lens.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    head = (q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), prompt_lens.data_ptr(), write_pos.data_ptr())
    splits = card_splits(b, kh, q.device, MAX_SPLITS_Q8 if q8 else MAX_SPLITS)
    shape = (layer, b, h, kh, s, d, prompt_pad, splits)
    tail = (d ** -0.5, _build.stream_handle(q.device))
    global launches, launches_q8
    if q8:
        err = lib.gar_decode_attention_fused_q8(*head, k_scale.data_ptr(), v_scale.data_ptr(),
                                                *shape, *tail)
        _build.check(err, "gar_decode_attention_fused_q8")
        launches_q8 += 1
    else:
        err = lib.gar_decode_attention_fused(*head, *shape, *tail)
        _build.check(err, "gar_decode_attention_fused")
        launches += 1
    return out


def _block_s(s: int, block_s: int) -> int:
    """The TPU kernel's block of cache columns, and its check (on every
    device: the block decides which columns the kernel visits)."""
    block_s = min(block_s, s)
    if s % block_s:
        raise ValueError(f"cache columns {s} must be a multiple of block_s {block_s}; "
                         "allocate the cache padded (padding would copy it every step)")
    return block_s


def decode_attention_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: torch.Tensor, *,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int,
    scale: Optional[float] = None, block_s: int = 512,
) -> torch.Tensor:
    """Kernel 16's function at `_decode_kernel`'s rounding points: the
    unscaled q meets k in fp32 and `scale` multiplies the logits; an online
    softmax over blocks of block_s columns, blocks 0 .. write_pos // block_s
    (masked logits NEG_INF, so a fully masked first block takes p = 1 until
    a valid column arrives, and then weighs nothing); p = exp(s - the
    running max) rounded to v's dtype before PV; acc / max(l, 1e-30)
    rounded once to q's dtype. The blocks are summed at once (each block's
    sums times exp(its running max - the last)), so nothing waits for the
    host."""
    b, h, d = q.shape
    kh, s = k_all.shape[2], k_all.shape[3]
    g = h // kh
    bs = _block_s(s, block_s)
    if scale is None:
        scale = d ** -0.5
    idx = torch.as_tensor(layer, device=k_all.device).reshape(1).long()
    kc, vc = k_all.index_select(0, idx)[0], v_all.index_select(0, idx)[0]  # (B, K, S, D)
    logits = torch.einsum("bkgd,bksd->bkgs", q.reshape(b, kh, g, d).float(), kc.float()) * scale
    ids = torch.arange(s, device=q.device)
    end = (write_pos // bs + 1) * bs  # past the blocks the TPU kernel visits
    valid = (ids < prompt_lens[:, None]) | ((ids >= prompt_pad) & (ids <= write_pos))
    valid &= ids < end
    blk = torch.where(valid[:, None, None, :], logits, NEG_INF).unflatten(-1, (s // bs, bs))
    m = blk.amax(-1).cummax(-1).values  # (B, K, G, blocks): the running max after each block
    p = torch.exp(blk - m[..., None])
    w = torch.exp(m - m[..., -1:])
    pv = torch.einsum("bkgns,bknsd->bkgnd", p.to(v_all.dtype).float(),
                      vc.float().unflatten(2, (s // bs, bs)))
    acc = (pv * w[..., None]).sum(-2)
    den = (p.sum(-1) * w).sum(-1, keepdim=True)
    return (acc / torch.clamp(den, min=1e-30)).reshape(b, h, d).to(q.dtype)


def valid_columns_read(prompt_len: int, prompt_pad: int, write_pos: int, seq: int,
                       block_s: int) -> list[int]:
    """The cache columns kernel 16 attends over for one row, in the order of
    its flat index: [0, n1), n1 = prompt_len cut at the end of the block_s
    block that holds write_pos (the TPU kernel's last block), then
    [max(prompt_pad, n1), write_pos] (write_pos inclusive); both cut at
    seq."""
    n1 = max(min(prompt_len, (write_pos // block_s + 1) * block_s, seq), 0)
    return list(range(n1)) + list(range(max(prompt_pad, n1), min(write_pos + 1, seq)))


def decode_attention_split_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: torch.Tensor, *,
    prompt_lens: torch.Tensor, write_pos: torch.Tensor, prompt_pad: int, splits: int,
    scale: Optional[float] = None, block_s: int = 512,
) -> torch.Tensor:
    """Kernel 16's split arithmetic in torch: for each row the valid columns
    (`valid_columns_read`) cut into `splits` chunks as the kernel cuts them
    (`split_bounds`); each chunk's (m, l, acc) with p = exp(s - the chunk's
    max) rounded to v's dtype before PV (the kernel rounds against the
    running max of each warp's 16 keys, which only shifts where bf16
    rounds); the chunks merged in rank order, an empty one weighing
    nothing, and no current token folded in (it is in the cache). A layer
    outside [0, L) gives NaN rows, as the kernel does. Reads the layer,
    write_pos and prompt_lens on the host: a mirror for the tests, not a
    path."""
    b, h, d = q.shape
    n_layers, _, kh, s, _ = k_all.shape
    bs = _block_s(s, block_s)
    if scale is None:
        scale = d ** -0.5
    lay, wpos = int(layer), int(write_pos)
    if not 0 <= lay < n_layers:
        return torch.full_like(q, float("nan"))
    kc, vc = k_all[lay], v_all[lay]
    qf = q.float().reshape(b, kh, h // kh, d)
    rows = []
    for r in range(b):
        cols = torch.tensor(valid_columns_read(int(prompt_lens[r]), prompt_pad, wpos, s, bs),
                            dtype=torch.long, device=q.device)
        den = torch.zeros(qf.shape[1:3], device=q.device)
        acc = torch.zeros(qf.shape[1:], device=q.device)
        m_all = torch.full(qf.shape[1:3], float("-inf"), device=q.device)
        parts = []
        for f0, f1 in split_bounds(len(cols), splits):
            if f0 == f1:  # an empty chunk (m = -inf) weighs nothing
                continue
            k_chunk, v_chunk = kc[r][:, cols[f0:f1]], vc[r][:, cols[f0:f1]]  # (K, n, D)
            logits = torch.einsum("kgd,knd->kgn", qf[r], k_chunk.float()) * scale
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,knd->kgd", p.to(v_all.dtype).float(),
                                                     v_chunk.float())))
            m_all = torch.maximum(m_all, m)
        for m, l_part, acc_part in parts:
            f = torch.exp(m - m_all)
            den, acc = den + f * l_part, acc + f[..., None] * acc_part
        rows.append(acc / torch.clamp(den, min=1e-30)[..., None])
    return torch.stack(rows).reshape(b, h, d).to(q.dtype)


def decode_attention_stacked(
    q: torch.Tensor,  # (B, H, D)
    k_all: torch.Tensor,  # (L, B, K, S, D) stacked bf16 cache, read only
    v_all: torch.Tensor,
    layer: torch.Tensor,  # () int32, on the cache's device
    *,
    prompt_lens: torch.Tensor,  # (B,) int32
    write_pos: torch.Tensor,  # () int32
    prompt_pad: int,
    scale: Optional[float] = None,
    block_s: int = 512,
) -> torch.Tensor:
    """Returns (B, H, D) in q's dtype: one query token per row over layer
    `layer` of the cache, valid columns [0, prompt_len) and [prompt_pad,
    write_pos] (the current token is in the cache at write_pos). Layout
    contract: prompt_pad <= write_pos < S. Kernel 16 takes bf16, head_dim
    64 and 1, 2, 4 or 8 query heads per kv head; a layer outside [0, L)
    gives NaN rows on the card."""
    b, h, d = q.shape
    n_layers, _, kh, s, _ = k_all.shape
    bs = _block_s(s, block_s)
    if scale is None:
        scale = d ** -0.5
    kw = dict(prompt_lens=prompt_lens, write_pos=write_pos, prompt_pad=prompt_pad, scale=scale,
              block_s=bs)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, layer, **kw)
    if k_all.shape[1] != b or k_all.shape[4] != d or v_all.shape != k_all.shape or h % kh:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, cache {tuple(k_all.shape)}, "
                         f"{tuple(v_all.shape)}")
    if d != 64 or h // kh not in (1, 2, 4, 8):
        raise ValueError(f"kernel 16 is built for head_dim 64 and 1, 2, 4 or 8 query heads "
                         f"per kv head, got {d} and {h // kh}")
    for x, name in ((q, "q"), (k_all, "k_all"), (v_all, "v_all")):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel 16 takes bfloat16 (the TPU kernel has no int8 "
                            f"cache scales), got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for x, name, shape in ((prompt_lens, "prompt_lens", (b,)), (write_pos, "write_pos", ()),
                           (layer, "layer", ())):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or tuple(x.shape) != shape or x.device != q.device):
            raise ValueError(f"{name} must be an int32 tensor of shape {shape} on {q.device}")
    prompt_lens = prompt_lens.contiguous()
    out = torch.empty_like(q)
    err = _build.library().gar_decode_attention(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(), prompt_lens.data_ptr(),
        write_pos.data_ptr(), layer.data_ptr(), n_layers, b, h, kh, s, d, prompt_pad, bs,
        card_splits(b, kh, q.device), scale, _build.stream_handle(q.device))
    _build.check(err, "gar_decode_attention")
    global launches_stacked
    launches_stacked += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, K, S, D) head-major
    v_cache: torch.Tensor,
    *,
    prompt_lens: torch.Tensor,
    write_pos: torch.Tensor,
    prompt_pad: int,
    scale: Optional[float] = None,
    block_s: int = 512,
) -> torch.Tensor:
    """`decode_attention_stacked` over the one-layer stack k_cache[None] at
    layer 0, as the JAX function does it."""
    layer = torch.zeros((), dtype=torch.int32, device=q.device)
    return decode_attention_stacked(q, k_cache[None], v_cache[None], layer,
                                    prompt_lens=prompt_lens, write_pos=write_pos,
                                    prompt_pad=prompt_pad, scale=scale, block_s=block_s)
