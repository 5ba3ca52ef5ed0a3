"""Training loss: label-masked next-token cross-entropy with a chunked head
(`grasp_any_region_tpu/train/losses.py`).

The head product and the CE run per chunk of `chunk_size` rows, each chunk
checkpointed (`torch.utils.checkpoint`, non-reentrant), so the (B, C, V)
fp32 logits of one chunk are alive at a time, in the forward and again in
the backward. Labels use -100 as the ignore index.

The head product is a plain large matrix product, as the JAX package
leaves it to XLA: operands in the working dtype, fp32 sums and fp32
logits (`torch.mm(..., out_dtype=float32)` on the card, as `lm_logits`;
fp32 products on the CPU). Its backward contracts the fp32 logit gradient
with the working-dtype operands in fp32 and rounds each result once, as
JAX's VJP does (dot_general f32 x bf16 -> f32, then one cast). On the card
cuBLAS takes no f32 x bf16 product, so the gradient goes in as two bf16
halves, g = hi + lo (hi = bf16(g), lo = bf16(g - hi): 16 significant
bits), two products each with fp32 sums.

Under a multi-rank mesh (`mesh=`) the head is gathered over fsdp and, where
its vocab is sharded over 'tensor', each rank computes the logits of its
vocab columns alone and the CE takes the max, the sum of exponentials and
the gold logit over the tensor ranks (three all-reduces of one value a
row: no rank holds a whole row of logits); `global_mean` makes the mean
one over every supervised token of the global batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import TextConfig
from ..ops.norms import rms_norm

IGNORE_INDEX = -100


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Align labels so position t supervises token t+1 (HF shift)."""
    pad = torch.full((labels.shape[0], 1), IGNORE_INDEX, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([labels[:, 1:], pad], dim=1)


class _HeadLogits(torch.autograd.Function):
    """fp32 logits x @ W of working-dtype operands: W is the tied (V, D)
    embedding (used transposed) or the untied (D, V) head."""

    @staticmethod
    def forward(ctx, x, head, tied):
        ctx.save_for_backward(x, head)
        ctx.tied = tied
        w = head.t() if tied else head
        if x.device.type == "cuda":
            return torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        x_dtype, head_dtype = x.dtype, head.dtype
        w = head.to(x_dtype)
        if x.device.type == "cuda" and x_dtype != torch.float32:
            hi = g.to(x_dtype)
            halves = (hi, (g - hi.float()).to(x_dtype))
        else:  # fp32 products, rounded once to the operands' dtypes
            halves, x, w = (g,), x.float(), w.float()
        if ctx.tied:  # logits = x @ head^T
            dx = _sum_mm([(h, w) for h in halves])
            dhead = _sum_mm([(h.t(), x) for h in halves])
        else:  # logits = x @ head
            dx = _sum_mm([(h, w.t()) for h in halves])
            dhead = _sum_mm([(x.t(), h) for h in halves])
        return dx.to(x_dtype), dhead.to(head_dtype), None


def _sum_mm(pairs) -> torch.Tensor:
    """The sum of the products a @ b of the pairs in fp32: on the card
    with fp32 sums from working-dtype operands (cuBLAS), else in fp32."""
    out = None
    for a, b in pairs:
        if a.is_cuda and a.dtype != torch.float32:
            p = torch.mm(a, b, out_dtype=torch.float32)
        else:
            p = a @ b
        out = p if out is None else out.add_(p)
    return out


def _chunk_nll(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, tied: bool,
               valid_vocab: Optional[int]) -> torch.Tensor:
    """Summed NLL of one chunk: x (B, C, D), labels (B, C)."""
    b, c, d = x.shape
    logits = _HeadLogits.apply(x.reshape(b * c, d), head, tied).reshape(b, c, -1)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        ok = torch.arange(logits.shape[-1], device=logits.device) < valid_vocab
        logits = torch.where(ok, logits, -1e30)
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, torch.logsumexp(logits, dim=-1) - gold, 0.0)
    return nll.sum()


def _chunk_nll_vocab_sharded(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                             tied: bool, valid_vocab: Optional[int], tp,
                             lo: int) -> torch.Tensor:
    """`_chunk_nll` with this rank's vocab columns [lo, lo + V_t) of the head
    (`models/llama.sharded_head`): the logsumexp and the gold logit summed
    over the tensor ranks (Megatron's vocab-parallel CE). x enters the
    region through `copy_to`; the sums' gradients pass as they are, each
    rank back-propagating its own columns."""
    from ..parallel.collectives import all_reduce, copy_to, reduce_from

    b, c, d = x.shape
    logits = _HeadLogits.apply(copy_to(x.reshape(b * c, d), tp), head, tied).reshape(b, c, -1)
    cols = lo + torch.arange(logits.shape[-1], device=logits.device)
    if valid_vocab is not None:
        logits = torch.where(cols < valid_vocab, logits, -1e30)
    m = all_reduce(logits.detach().amax(-1), tp, op=torch.distributed.ReduceOp.MAX)
    lse = m + torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(-1), tp))
    mask = labels != IGNORE_INDEX
    local = labels.long() - lo
    mine = mask & (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    gold = reduce_from(torch.where(mine, gold, 0.0), tp)
    return torch.where(mask, lse - gold, 0.0).sum()


def ce_sums(llm_params, cfg: TextConfig, hidden: torch.Tensor, labels: torch.Tensor, *,
            chunk_size: int = 1024, valid_vocab: Optional[int] = None, mesh=None):
    """(sum of NLL over supervised positions, supervised count), both 0-dim
    device tensors. hidden (B, S, D) is the decoder output before the final
    norm; labels (B, S) are already shifted. mesh: a sharded tree's
    vocab-sharded head (`models/llama.sharded_head`); the sums are this
    rank's."""
    x = rms_norm(hidden, llm_params.final_norm, cfg.rms_norm_eps)
    tied = cfg.tie_word_embeddings
    head = llm_params.embed if tied else llm_params.lm_head
    nll, extra = _chunk_nll, ()
    if mesh is not None and mesh.size > 1:  # the head gathered once, outside the chunks
        from ..models.llama import sharded_head

        head, sharded = sharded_head(llm_params, cfg, mesh)
        if sharded:
            nll = _chunk_nll_vocab_sharded
            extra = (mesh.group("tensor"), mesh.coords["tensor"] * head.shape[0 if tied else 1])
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, x.shape[1], chunk_size):
        total = total + checkpoint(nll, head, x[:, lo:lo + chunk_size],
                                   labels[:, lo:lo + chunk_size], tied, valid_vocab, *extra,
                                   use_reentrant=False)
    return total, (labels != IGNORE_INDEX).sum()


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the global batch of a rank's (NLL sum, count): both
    summed over the data, fsdp and seq ranks (each holds other tokens),
    the sum's gradient passed as it is, so each rank back-propagates its
    own tokens' part of the global mean."""
    from ..parallel.collectives import all_reduce, reduce_from

    group = mesh.group(("data", "fsdp", "seq"))
    return reduce_from(total, group) / all_reduce(count, group).clamp(min=1).float()


def chunked_cross_entropy(llm_params, cfg: TextConfig, hidden: torch.Tensor,
                          labels: torch.Tensor, *, chunk_size: int = 1024,
                          valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean CE over supervised positions. Never materializes full logits."""
    total, count = ce_sums(llm_params, cfg, hidden, labels, chunk_size=chunk_size,
                           valid_vocab=valid_vocab)
    return total / count.clamp(min=1).float()
