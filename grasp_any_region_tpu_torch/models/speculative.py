"""Self-speculative greedy decoding (`grasp_any_region_tpu/models/speculative.py`):
a shallow-prefix draft and a batched verify.

A decode step streams every decoder weight once for one token. A verify
pass over a chunk of gamma + 1 tokens streams them once for all of them,
so if a cheap draft guesses the next gamma greedy tokens, a round emits up
to gamma + 1 tokens for about (1 + gamma * k / L) steps' weights. The draft
is the model's own first `draft_layers` layers with the shared final norm
and head: no second model. The draft layers' K/V go into the same cache and
the verify pass rewrites those columns over every layer. A draft token is
kept only where it equals the full model's argmax, and the first mismatch
is replaced by it, so the output is the base model's greedy trajectory.

Single request only (B = 1): one write position is shared by the cache.

The port runs JAX's `jax.lax.while_loop` over rounds as a Python loop.
Each round needs m, the tokens it emits, to place the next round, so the
host reads the round's targets and drafts once a round (one transfer): a
caption makes 1 + rounds host syncs (the first reads the prefill's token).
Nothing else waits for the card: the output tokens are also kept in a
device buffer, filled from the targets on the card. JAX's chunk attention
and products are XLA (no Pallas call), and so here the draft and the
verify are plain torch (cuBLAS products on the card) on the decoder's
plain helpers; the prefill is `gar_prefill` (on the card kernels D-G and
B).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..core.config import EOT_TOKEN_ID, GARConfig, TextConfig
from ..ops.attention import NEG_INF
from ..ops.rope import llama_inv_freq, rope_cos_sin
from .gar import GARBatch, GARParams, gar_prefill, seed_cache_from_prefill
from .llama import LlamaParams, _layer, embed_tokens, lm_logits, refuse_adapters


class SpecStats(NamedTuple):
    rounds: int  # rounds executed
    drafted: int  # draft tokens proposed (gamma a round)
    accepted: int  # draft tokens accepted and emitted: a round cut by eot
    #   counts only the drafts before its eot, so accepted / drafted is the
    #   realized accept rate


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # (1, max_new_tokens) int32, pad after the first eot
    num_generated: torch.Tensor  # (1,) int32, the first eot counted
    stats: SpecStats


def _chunk_attention(
    q: torch.Tensor,  # (B, C, H, Dh) roped queries
    k_cache: torch.Tensor,  # (B, K, S, Dh) one layer, the chunk already written
    v_cache: torch.Tensor,
    *,
    prompt_lens: torch.Tensor,
    write_pos: int,  # column of chunk row 0
    prompt_pad: int,
) -> torch.Tensor:
    """Multi-token decode attention: chunk row c attends the two-interval
    cache [0, prompt_lens) u [prompt_pad, write_pos + c], logits in fp32,
    probabilities rounded to the cache's dtype before the PV product (as
    JAX's einsums). Columns past the last row are masked for every row, so
    only [0, write_pos + C) is read."""
    b, c, h, d = q.shape
    kh = k_cache.shape[1]
    s = write_pos + c
    k_cache, v_cache = k_cache[:, :, :s], v_cache[:, :, :s]
    qf = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).reshape(b, c, kh, h // kh, d)
    logits = torch.einsum("bckgd,bksd->bckgs", qf.float(), k_cache.float())
    ids = torch.arange(s, device=q.device)[None, None, :]  # (1, 1, S)
    row_end = write_pos + torch.arange(c, device=q.device)[None, :, None]  # (1, C, 1)
    valid = (ids < prompt_lens[:, None, None]) | ((ids >= prompt_pad) & (ids <= row_end))
    logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bckgs,bksd->bckgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, c, h, d).to(q.dtype)


def _layer_step(
    cfg: TextConfig,
    bp: dict,
    x: torch.Tensor,  # (B, C, D)
    k_all: torch.Tensor,  # (L, B, K, S, Dh)
    v_all: torch.Tensor,
    layer: int,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    prompt_lens: torch.Tensor,
    write_pos: int,
    prompt_pad: int,
):
    """One decoder layer over a C-token chunk, its K/V written into the
    cache at [write_pos, write_pos + C) in place."""
    c = x.shape[1]

    def attend(q, k, v):  # q (B, C, H, Dh), k / v (B, C, K, Dh)
        k_all[layer, :, :, write_pos:write_pos + c] = k.transpose(1, 2).to(k_all.dtype)
        v_all[layer, :, :, write_pos:write_pos + c] = v.transpose(1, 2).to(v_all.dtype)
        return _chunk_attention(q, k_all[layer], v_all[layer], prompt_lens=prompt_lens,
                                write_pos=write_pos, prompt_pad=prompt_pad)

    x, _, _ = _layer(cfg, bp, x, cos, sin, attend)
    return x, k_all, v_all


def _forward_chunk(
    llm: LlamaParams,
    cfg: TextConfig,
    tokens: torch.Tensor,  # (B, C)
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    *,
    prompt_lens: torch.Tensor,
    write_pos: int,
    prompt_pad: int,
    num_layers: int,
    compute_dtype=torch.bfloat16,
    inv_freq: Optional[torch.Tensor] = None,
    blocks: Optional[List[dict]] = None,
):
    """`num_layers` decoder layers over a token chunk, appending K/V at
    [write_pos, write_pos + C): num_layers < L is the shallow draft,
    num_layers == L the verify pass. inv_freq and blocks (the layers'
    weight views) may be made once by the caller."""
    c = tokens.shape[1]
    x = embed_tokens(llm, tokens, compute_dtype)
    if inv_freq is None:
        inv_freq = llama_inv_freq(cfg, tokens.device)
    if blocks is None:
        blocks = llm.blocks.layers()
    pos = (prompt_lens[:, None] + (write_pos - prompt_pad)) + torch.arange(
        c, device=tokens.device)[None]
    cos, sin = rope_cos_sin(pos, inv_freq)
    for layer in range(num_layers):
        x, cache_k, cache_v = _layer_step(cfg, blocks[layer], x, cache_k, cache_v, layer, cos,
                                          sin, prompt_lens=prompt_lens, write_pos=write_pos,
                                          prompt_pad=prompt_pad)
    return x, cache_k, cache_v


@torch.inference_mode()
def generate_speculative(
    params: GARParams,
    cfg: GARConfig,
    batch: GARBatch,
    prompt_lens: torch.Tensor,  # (1,)
    *,
    max_new_tokens: int = 1024,
    gamma: int = 4,
    draft_layers: int = 4,
    eot_id: int = EOT_TOKEN_ID,
    pad_id: int = 0,
    mask_compat: bool = True,
    double_scale_compat: bool = True,
    compute_dtype=torch.bfloat16,
) -> SpecResult:
    """Greedy generation by self-speculative draft / verify. The tokens are
    `models/generate.generate(temperature=0)`'s up to ties between the
    chunk and step forms' roundings. The cache is seeded bf16 whatever the
    compute dtype, as JAX seeds it."""
    b, s = batch.input_ids.shape
    if b != 1:
        raise ValueError(f"speculative decode is single-stream (a shared write_pos); got B = {b}")
    t = cfg.text
    if not 0 < draft_layers <= t.num_layers:
        raise ValueError(f"draft_layers must be in [1, {t.num_layers}], got {draft_layers}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    # the draft and verify read the base weights alone, as the decode steps do
    refuse_adapters(params.llm, "generate_speculative")
    dev = batch.input_ids.device
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    llm = params.llm
    vocab = cfg.extended_vocab_size

    hidden, kv = gar_prefill(params, cfg, batch, mask_compat=mask_compat,
                             double_scale_compat=double_scale_compat, compute_dtype=compute_dtype)
    last = hidden[torch.arange(b, device=dev), prompt_lens.long() - 1]
    cur = torch.argmax(lm_logits(llm, t, last, valid_vocab=vocab), dim=-1).to(torch.int32)
    max_len = ((s + max_new_tokens + gamma + 511) // 512) * 512
    cache = seed_cache_from_prefill(cfg, kv, prompt_lens, max_len)
    del hidden, kv

    kw = dict(prompt_lens=cache.prompt_lens, prompt_pad=s, compute_dtype=compute_dtype,
              inv_freq=llama_inv_freq(t, dev), blocks=llm.blocks.layers())
    # the tokens stay on the device as well (a round may overshoot by gamma)
    buf = torch.full((1, max_new_tokens + gamma + 1), pad_id, dtype=torch.int32, device=dev)
    buf[:, 0] = cur
    out = cur.tolist()  # the first host sync
    done = out[0] == eot_id
    wp, rounds, accepted = s, 0, 0
    while len(out) < max_new_tokens and not done:
        # draft: gamma single-token steps through the first draft_layers layers
        tok, drafts = cur, []
        for j in range(gamma):
            h, _, _ = _forward_chunk(llm, t, tok[:, None], cache.k, cache.v, write_pos=wp + j,
                                     num_layers=draft_layers, **kw)
            tok = torch.argmax(lm_logits(llm, t, h[:, 0], valid_vocab=vocab),
                               dim=-1).to(torch.int32)
            drafts.append(tok)
        # verify: one full-depth pass over [cur, d_1 .. d_gamma], rewriting
        # the draft layers' columns
        chunk = torch.cat([cur[:, None]] + [d[:, None] for d in drafts], dim=1)
        h, _, _ = _forward_chunk(llm, t, chunk, cache.k, cache.v, write_pos=wp,
                                 num_layers=t.num_layers, **kw)
        targets = torch.argmax(lm_logits(llm, t, h, valid_vocab=vocab), dim=-1).to(torch.int32)
        both = torch.cat([targets[0], chunk[0, 1:]]).tolist()  # the round's host sync
        tg, dr = both[:gamma + 1], both[gamma + 1:]
        n_acc = 0
        while n_acc < gamma and dr[n_acc] == tg[n_acc]:
            n_acc += 1
        m = n_acc + 1  # tokens emitted: the accepted drafts and the correction
        if eot_id in tg[:m]:  # emit up to and including the first eot
            m = tg.index(eot_id) + 1
            done = True
        buf[:, len(out):len(out) + m] = targets[:, :m]
        out.extend(tg[:m])
        cur = targets[:, m - 1]
        wp += m
        rounds += 1
        accepted += m - 1

    toks = out[:max_new_tokens]
    num = toks.index(eot_id) + 1 if eot_id in toks else len(toks)
    tokens = buf[:, :max_new_tokens]
    tokens[:, num:] = pad_id  # a round may have written past the first eot
    return SpecResult(
        tokens=tokens,
        num_generated=torch.full((1,), num, dtype=torch.int32, device=dev),
        stats=SpecStats(rounds=rounds, drafted=rounds * gamma, accepted=accepted),
    )
