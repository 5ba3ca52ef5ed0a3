"""Ring attention: context-parallel attention over the 'seq' axis
(`grasp_any_region_tpu/parallel/ring.py`).

q stays sequence-sharded; the K/V shards travel round the ring (each rank
sends to the next and receives from the previous one) while each rank
folds one block a hop into a running online-softmax state (m, l, acc), in
fp32, in plain torch, as JAX's is XLA einsums and no Pallas kernel. Unlike
Ulysses there is no head-count constraint: GQA kv heads are repeated
locally a block.

JAX gets the gradient by transposing its `ppermute`s; autograd does not
differentiate through point-to-point sends, so the backward is an
`autograd.Function` of its own (FlashAttention-2's recurrences a block):
dQ accumulates on its rank, and each block's dK and dV travel round the
ring with their K and V, arriving back at the block's rank after the
last hop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF, repeat_kv
from .collectives import group_rank, group_size, ring_shift


def _heads(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, K * g, S, D) in fp32."""
    return repeat_kv(x, g).float().permute(0, 2, 1, 3)


def _fold(x: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, K * g, S, D) -> (B, S, K, D), the g query heads of a kv head summed."""
    b, h, s, d = x.shape
    return x.reshape(b, kh, h // kh, s, d).sum(2).permute(0, 2, 1, 3)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        b, sl, h, d = q.shape
        kh = k.shape[2]
        g = h // kh
        p, idx = group_size(group), group_rank(group)
        qf = q.float().permute(0, 2, 1, 3) * scale  # (B, H, Sl, D)
        q_pos = idx * sl + torch.arange(sl, device=q.device)
        m = torch.full((b, h, sl, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for i in range(p):
            src = (idx - i) % p  # the rank this hop's block was born on
            s = qf @ _heads(k_blk, g).transpose(-1, -2)
            ok = None
            if causal:
                k_pos = src * sl + torch.arange(sl, device=q.device)
                ok = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            pm = torch.exp(s - m_new)
            if causal:  # a fully masked row has s == m_new == NEG_INF: exp(0) = 1
                pm = torch.where(ok, pm, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pm.sum(-1, keepdim=True)
            # JAX's PV product: p rounded to v's dtype, fp32 sums
            acc = acc * alpha + pm.to(v.dtype).float() @ _heads(v_blk, g)
            m = m_new
            if i < p - 1:
                k_blk, v_blk = ring_shift([k_blk, v_blk], group)
        out = (acc / l.clamp(min=1e-30)).permute(0, 2, 1, 3).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l.clamp(min=1e-30)))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        b, sl, h, d = q.shape
        kh = k.shape[2]
        g = h // kh
        p, idx = group_size(group), group_rank(group)
        qf = q.float().permute(0, 2, 1, 3) * scale
        do = grad.float().permute(0, 2, 1, 3)
        delta = (do * out.float().permute(0, 2, 1, 3)).sum(-1, keepdim=True)
        q_pos = idx * sl + torch.arange(sl, device=q.device)
        dq = torch.zeros_like(qf)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(p):
            src = (idx - i) % p
            kf, vf = _heads(k_blk, g), _heads(v_blk, g)
            pm = torch.exp(qf @ kf.transpose(-1, -2) - lse)
            if causal:
                k_pos = src * sl + torch.arange(sl, device=q.device)
                pm = torch.where(q_pos[:, None] >= k_pos[None, :], pm, 0.0)
            ds = pm * (do @ vf.transpose(-1, -2) - delta)
            dq += ds @ kf
            dk_blk = dk_blk + _fold(ds.transpose(-1, -2) @ qf, kh)
            dv_blk = dv_blk + _fold(pm.transpose(-1, -2) @ do, kh)
            # the block's dK / dV go on with it; after the last hop they are home
            if i < p - 1:
                k_blk, v_blk, dk_blk, dv_blk = ring_shift([k_blk, v_blk, dk_blk, dv_blk], group)
            else:
                dk_blk, dv_blk = ring_shift([dk_blk, dv_blk], group)
        dq = (dq * scale).permute(0, 2, 1, 3).to(q.dtype)
        return dq, dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None, None


def ring_attention(
    q: torch.Tensor,  # (B, S/P, H, D) this rank's sequence shard
    k: torch.Tensor,  # (B, S/P, K, D)
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    axis: str = "seq",
) -> torch.Tensor:
    """Context-parallel attention over the ranks of `axis`; returns this
    rank's (B, S/P, H, D) in q's dtype. Positions are global: shard j holds
    tokens [j S/P, (j + 1) S/P). Differentiable (its own backward)."""
    h, kh = q.shape[2], k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {kh}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _RingAttention.apply(q, k, v, mesh.group(axis), causal, scale)
