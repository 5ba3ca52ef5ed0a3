"""Generation: greedy and temperature sampling (`grasp_any_region_tpu/models/generate.py`).

Multimodal prefill, cache seeding, then a decode loop whose cache append,
write position and done flags all stay on the device. The host looks at
the done flags only every EOT_CHECK_EVERY steps, to stop early once every row
has emitted eot, and never when `eot_id < 0`. Stopping early changes no
output: rows that are done only ever append `pad_id`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import EOT_TOKEN_ID, GARConfig
from .gar import GARBatch, GARParams, gar_decode_step, gar_prefill, seed_cache_from_prefill
from .llama import lm_logits

EOT_CHECK_EVERY = 32  # decode steps between host looks at the done flags


class GenerationResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new_tokens) generated ids, pad after eot
    num_generated: torch.Tensor  # (B,) count including the eot token


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.inference_mode()
def generate(
    params: GARParams,
    cfg: GARConfig,
    batch: GARBatch,
    prompt_lens: torch.Tensor,  # (B,) true prompt lengths
    *,
    max_new_tokens: int = 1024,
    eot_id: int = EOT_TOKEN_ID,
    pad_id: int = 0,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    mask_compat: bool = True,
    double_scale_compat: bool = True,
    compute_dtype=torch.bfloat16,
    quantize_kv: bool = False,
) -> GenerationResult:
    """Prefill, seed the cache, then up to max_new_tokens - 1 decode steps.

    quantize_kv: seed an int8 cache (`seed_cache_from_prefill`), which the
    decode steps run through the fused form and kernel C8 on any device.
    JAX `generate` honours the flag only where its head-paired cache exists
    (the TPU); the port keeps no paired layout and honours it everywhere.
    Int8 decode weights are the params' own (models/quantize.py)."""
    b, s = batch.input_ids.shape
    dev = batch.input_ids.device
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    hidden, kv = gar_prefill(params, cfg, batch, mask_compat=mask_compat,
                             double_scale_compat=double_scale_compat,
                             compute_dtype=compute_dtype)
    last_hidden = hidden[torch.arange(b, device=dev), prompt_lens.long() - 1]
    logits0 = lm_logits(params.llm, cfg.text, last_hidden,
                        valid_vocab=cfg.extended_vocab_size)
    cur = _sample(logits0, generator, temperature)

    # cache columns rounded up to a multiple of 512
    max_len = ((s + max_new_tokens + 511) // 512) * 512
    cache = seed_cache_from_prefill(cfg, kv, prompt_lens, max_len, quantize_kv=quantize_kv)
    del hidden, kv

    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    out[:, 0] = cur
    done = cur == eot_id
    for step in range(1, max_new_tokens):
        logits, cache = gar_decode_step(params, cfg, cur, cache, s,
                                        compute_dtype=compute_dtype)
        nxt = _sample(logits, generator, temperature)
        nxt = torch.where(done, pad_id, nxt)
        out[:, step] = nxt
        done = done | (nxt == eot_id)
        cur = nxt
        if eot_id >= 0 and step % EOT_CHECK_EVERY == 0 and bool(done.all()):
            break

    # count tokens up to and including the first eot (or max_new_tokens)
    is_eot = out == eot_id
    first_eot = torch.argmax(is_eot.to(torch.int32), dim=-1)
    num = torch.where(is_eot.any(dim=-1), first_eot + 1, max_new_tokens)
    return GenerationResult(tokens=out, num_generated=num.to(torch.int32))
