"""Continuous-batching serving engine over the paged KV cache
(`grasp_any_region_tpu/serve/engine.py`).

A fixed ring of decode slots over one paged KV pool (serve/paged_cache.py):

  * requests queue; when a slot and enough pages are free a request is
    admitted: same-shape requests at the head of the queue prefill together
    (the fused tower and kernel B on the card), and each one's first token
    (tok0) is the argmax of its last prompt position.
  * `step()` decodes one token for every active slot through the paged
    decode step (`llama_decode_step_paged`, or the weight-stream form with
    `use_fused`); a slot retires on eot or when its budget runs out, and
    its pages go back to the free list.
  * `run()` with `decode_chunk > 1` decodes in windows (`_run_pipelined`):
    the live slots' pages are gathered into a dense two-interval KVCache,
    up to `decode_chunk` steps of `llama_decode_step` run on it (the fused
    step J, C, H, I, H a layer on the card; with `quantize_kv` an int8
    window cache and J8 / C8 / H8 / I8 with int8 weights), and the window's
    new K/V are flushed back into the pages. A burst of slots all admitted
    in the same cycle skips the pages: their prefill K/V feed the window
    cache directly (`_decode_window_fresh`).

JAX runs a window as a device `while_loop` that exits early on eot. Here
the window is a Python loop of steps whose count the host knows,
min(decode_chunk, the largest remaining budget); eot and the per-slot
budget are tracked on the device, finished slots freeze, and the host
looks at the done flags only every EOT_CHECK_EVERY steps and only when
`eot_id >= 0`, as `generate` does. The window's tokens, counts and the
deferred first tokens come back in one fetch at its end; admission in
that mode (`_admit(defer_tok0=True)`) fetches nothing.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import EOT_TOKEN_ID, GARConfig
from ..core.weights import require_device
from ..models.gar import (GARBatch, GARParams, _quantize_pairs, build_prefill_embeds, gar_prefill,
                          map_batch)
from ..models.generate import EOT_CHECK_EVERY
from ..models.llama import (KVCache, embed_tokens, llama_decode_step, llama_decode_step_paged,
                            llama_decode_step_paged_fused, llama_prefill_chunk, lm_logits)
from .paged_cache import (PageAllocator, flush_window_pages, gather_pages_dense, init_paged_kv,
                          pages_needed, write_prompt_pages)


@dataclass
class EngineConfig:
    slots: int = 8  # concurrent decode streams
    page_size: int = 64
    num_pages: int = 512  # pool size (page 0 reserved)
    max_pages_per_slot: int = 96  # block-table width
    max_new_tokens: int = 1024
    eot_id: int = EOT_TOKEN_ID
    pad_id: int = 0
    # per-token steps (decode_chunk = 1) through the weight-stream paged
    # step (kernels J, H, I or their int8 forms); None or False = the plain
    # paged step, JAX's default
    use_fused: Optional[bool] = None
    # int8 window cache: each window's dense cache is quantized with one
    # scale per (layer, slot, kv-head pair), recomputed every window, the
    # window decodes through kernel C8, and its new columns are dequantized
    # back into the pools, which stay in the compute dtype. Needs an even
    # kv-head count.
    quantize_kv: bool = False
    mask_compat: bool = True
    double_scale_compat: bool = True
    # decode up to this many tokens for all slots a window, with one host
    # fetch; 1 = per-token steps (`step`)
    decode_chunk: int = 1
    # when set and other slots are decoding, a queued request's decoder
    # sweep advances this many prompt tokens an engine cycle
    # (llama_prefill_chunk); its tower and replay run whole. Admissions
    # into an idle engine keep the batched whole-prompt path.
    prefill_chunk: Optional[int] = None


class StepEvent(NamedTuple):
    request_id: int
    token: int
    done: bool


@dataclass
class _SlotState:
    request_id: int
    pages: List[int]
    tokens: List[int] = field(default_factory=list)


@dataclass
class _PrefillJob:
    """A chunked prefill in flight (prefill_chunk scheduling)."""

    request_id: int
    slot: int
    plen: int
    pages: List[int]
    embeds: torch.Tensor  # (1, S, D) the whole prompt's embeds
    pos: int = 0  # next chunk start
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (L, 1, P, K, Dh) so far
    last_hidden: Optional[Tuple[torch.Tensor, int]] = None  # the chunk holding plen - 1


def _on(t_dev: torch.device, dev: torch.device) -> bool:
    return t_dev.type == dev.type and (dev.index is None or t_dev.index == dev.index)


class ContinuousBatchingEngine:
    """params: `GARParams` on `device` (the card unless the caller asks for
    the CPU), bf16 or int8 decode weights (models/quantize.py); dtype: the
    compute dtype of prefill, decode and the page pools.

    `timing` sums the host seconds of each phase (admission, chunked
    prefill, and of each window: setup, gather, steps, flush, fetch,
    bookkeeping); the card runs behind the host, so only the fetch waits
    for it. `counts` counts the schedule: admission groups and their rows,
    tower passes, prefill chunks, windows by path, pool gathers and
    flushes, window steps, the host's eot looks in them, and per-token
    steps."""

    def __init__(self, params: GARParams, cfg: GARConfig, ecfg: EngineConfig,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = require_device(device)
        off = sorted({str(p.device) for p in params.parameters()
                      if not _on(p.device, self.device)})
        if off:
            raise ValueError(f"the engine runs on {self.device}, but params are on {off}")
        tc = cfg.text
        if ecfg.quantize_kv and tc.num_kv_heads % 2:
            raise ValueError(f"quantize_kv pairs kv heads for the int8 window cache; "
                             f"{tc.num_kv_heads} kv heads is odd")
        if ecfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be at least 1, got {ecfg.decode_chunk}")
        self.params, self.cfg, self.ecfg, self.dtype = params, cfg, ecfg, dtype
        paged = init_paged_kv(tc.num_layers, ecfg.num_pages, ecfg.page_size, tc.num_kv_heads,
                              tc.head_dim, slots=ecfg.slots,
                              max_pages_per_slot=ecfg.max_pages_per_slot, dtype=dtype,
                              device=self.device)
        self.k_pool, self.v_pool = paged.k, paged.v
        self.allocator = PageAllocator(ecfg.num_pages)
        self.block_table = np.zeros((ecfg.slots, ecfg.max_pages_per_slot), np.int32)
        self.seq_lens = np.zeros(ecfg.slots, np.int32)
        self.active = np.zeros(ecfg.slots, bool)
        self.cur = np.zeros(ecfg.slots, np.int32)
        self.slots: List[Optional[_SlotState]] = [None] * ecfg.slots
        self.queue: Deque[Tuple[int, GARBatch, int]] = deque()
        self.finished: Dict[int, List[int]] = {}
        # StepEvents made during _admit (tok0 of each request, and requests
        # that finish at admission), drained by step() / _run_pipelined
        self._pending_events: List[StepEvent] = []
        # deferred admission: ([slots], device tok0s) to seed into cur, and
        # the slots whose tok0 the next window's fetch resolves
        self._deferred: List[Tuple[List[int], torch.Tensor]] = []
        self._fresh: set = set()
        # slot -> (ks (L, S, K, Dh), vs, plen, page_vec): prompt K/V admitted
        # this cycle whose page seeding waits for the next window
        self._fresh_kv: Dict[int, Tuple] = {}
        self._prefill_jobs: List[_PrefillJob] = []
        self._reserved: set = set()
        self._next_id = 0
        self.timing: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # per-request latency: submit -> first host-visible token -> done
        # (host-visible at fetches, so with decode_chunk = N a fresh
        # request's TTFT includes its first window)
        self.req_stats: Dict[int, dict] = {}

    # -- helpers -------------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        """A host array as a new device tensor: copied on the host first (the
        engine goes on mutating its arrays), then sent without waiting for
        the card (a pageable source is staged before the call returns)."""
        return torch.tensor(np.asarray(a)).to(self.device, non_blocking=True)

    def _count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def _lap(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.timing[key] = self.timing.get(key, 0.0) + (t1 - t0)
        return t1

    def _prefill(self, batch: GARBatch, plens: torch.Tensor):
        """Batched whole-prompt prefill -> (tok0 (G,) int32, (ks, vs) (L, G,
        S, K, Dh)), on the device."""
        e, cfg = self.ecfg, self.cfg
        hidden, kv = gar_prefill(self.params, cfg, batch, mask_compat=e.mask_compat,
                                 double_scale_compat=e.double_scale_compat,
                                 compute_dtype=self.dtype)
        last = hidden[torch.arange(hidden.shape[0], device=self.device), plens.long() - 1]
        logits = lm_logits(self.params.llm, cfg.text, last, valid_vocab=cfg.extended_vocab_size)
        self._count("prefill_groups")
        self._count("prefill_rows", hidden.shape[0])
        self._count("tower_passes")
        return torch.argmax(logits, dim=-1).to(torch.int32), kv

    def _seed(self, ks: torch.Tensor, vs: torch.Tensor, plen: int, page_vec) -> None:
        write_prompt_pages(self.k_pool, self.v_pool, ks, vs, self._dev(page_vec), plen)

    def _next_tokens(self, hidden: torch.Tensor) -> torch.Tensor:
        logits = lm_logits(self.params.llm, self.cfg.text, hidden,
                           valid_vocab=self.cfg.extended_vocab_size)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _decode(self, cur, block_table, seq_lens, active) -> torch.Tensor:
        """One per-token step of every slot against the pools (in place)."""
        embeds = embed_tokens(self.params.llm, cur[:, None], self.dtype)
        step = llama_decode_step_paged_fused if self.ecfg.use_fused else llama_decode_step_paged
        hidden, _, _ = step(self.params.llm, self.cfg.text, embeds, self.k_pool, self.v_pool,
                            block_table, seq_lens, active)
        self._count("token_steps")
        return self._next_tokens(hidden[:, 0])

    # -- the window ----------------------------------------------------------

    def _window_loop(self, cache: KVCache, cur, active, rem, n_steps: int, s_base: int):
        """Up to n_steps decode steps of all slots on the dense window cache.
        Fresh slots arrive with an unfetched tok0 in `cur`: tok0 == eot or
        an exhausted budget freezes the slot before it decodes anything.
        Returns (packed (2 + n_steps, slots) int32: row 0 the input cur,
        row 1 each slot's new-token count, then the tokens; the cache;
        counts)."""
        e = self.ecfg
        slots = cur.shape[0]
        done = active & ((cur == e.eot_id) | (rem <= 0))
        counts = torch.zeros(slots, dtype=torch.int32, device=self.device)
        out = torch.full((n_steps, slots), e.pad_id, dtype=torch.int32, device=self.device)
        cur0 = cur
        for i in range(n_steps):
            act = active & ~done
            embeds = embed_tokens(self.params.llm, cur[:, None], self.dtype)
            hidden, cache = llama_decode_step(self.params.llm, self.cfg.text, embeds, cache,
                                              s_base)
            nxt = self._next_tokens(hidden[:, 0])
            out[i] = torch.where(act, nxt, e.pad_id)
            counts = counts + act.to(torch.int32)
            done = done | (act & ((nxt == e.eot_id) | (counts >= rem)))
            cur = torch.where(act, nxt, cur)
            self._count("window_steps")
            # the host's one look every EOT_CHECK_EVERY steps, as generate's
            if e.eot_id >= 0 and (i + 1) % EOT_CHECK_EVERY == 0 and i + 1 < n_steps:
                self._count("eot_looks")
                if bool((done | ~active).all()):
                    break
        return torch.cat([cur0[None], counts[None], out]), cache, counts

    def _quantize_dense(self, kd: torch.Tensor, vd: torch.Tensor, seq_lens: torch.Tensor,
                        s_base: int):
        """The window cache as int8 with one fp32 scale per (layer, slot,
        kv-head pair) (`models/gar._quantize_pairs`, 1.5x headroom over the
        pair's amax). The masked columns [seq_len_b, s_base) are zeroed
        first: on the gather path they hold whatever the slot's pages or the
        trash page hold, so JAX's amax over them can depend on the order of
        earlier trash-page writes; zeroed, the scales depend on the cached
        tokens alone, and the burst and gather paths quantize alike."""
        cols = torch.arange(kd.shape[3], device=self.device)
        masked = (cols[None, :] >= seq_lens[:, None]) & (cols[None, :] < s_base)  # (B, S)
        for x in (kd, vd):
            x.masked_fill_(masked[None, :, None, :, None], 0)
        (kq, ksc), (vq, vsc) = _quantize_pairs(kd), _quantize_pairs(vd)
        return kq, vq, ksc, vsc

    def _window_columns(self, cache: KVCache, s_base: int, steps: int):
        """The window's columns (L, slots, K, steps, Dh) in the pools'
        dtype, dequantized from an int8 window cache."""
        kw = cache.k[:, :, :, s_base: s_base + steps]
        vw = cache.v[:, :, :, s_base: s_base + steps]
        if cache.k_scale is None:
            return kw, vw
        return tuple((w.float() * sc.repeat_interleave(2, dim=2)).to(self.dtype)
                     for w, sc in ((kw, cache.k_scale), (vw, cache.v_scale)))

    def _window_cache(self, kd, vd, seq_lens, s_base: int) -> KVCache:
        ksc = vsc = None
        if self.ecfg.quantize_kv:
            kd, vd, ksc, vsc = self._quantize_dense(kd, vd, seq_lens, s_base)
        return KVCache(k=kd, v=vd, prompt_lens=seq_lens,
                       write_pos=torch.full((), s_base, dtype=torch.int32, device=self.device),
                       k_scale=ksc, v_scale=vsc)

    def _decode_window(self, cur, block_table, seq_lens, active, rem, n_steps: int,
                       s_base: int) -> torch.Tensor:
        """One window through the pages: gather the slots' pages into a
        dense cache, run the steps, flush the new columns back."""
        steps = self.ecfg.decode_chunk
        t0 = time.perf_counter()
        kd, vd = gather_pages_dense(self.k_pool, self.v_pool, block_table, s_base, steps)
        cache = self._window_cache(kd, vd, seq_lens, s_base)
        self._count("gathers")
        t0 = self._lap("window_gather", t0)
        packed, cache, counts = self._window_loop(cache, cur, active, rem, n_steps, s_base)
        t0 = self._lap("window_steps", t0)
        kw, vw = self._window_columns(cache, s_base, steps)
        flush_window_pages(self.k_pool, self.v_pool, kw, vw, block_table, seq_lens, counts, 0,
                           steps)
        self._count("flushes")
        self._lap("window_flush", t0)
        return packed

    def _decode_window_fresh(self, fresh_kv: Dict[int, Tuple], order: List[int], cur,
                             seq_lens, active, rem, n_steps: int, s_base: int):
        """The burst path: every live slot was admitted this cycle, so its
        prefill K/V go straight into the dense window cache, and the pools
        are not touched. Returns (packed, the window's columns k, v); the
        caller seeds and flushes only the slots that survive the window."""
        steps = self.ecfg.decode_chunk
        t0 = time.perf_counter()
        l, s, kh, d = fresh_kv[order[0]][0].shape
        total = ((s_base + steps + 511) // 512) * 512
        cols = min(s, s_base)
        kd = torch.zeros((l, cur.shape[0], kh, total, d), dtype=self.dtype, device=self.device)
        vd = torch.zeros_like(kd)
        for slot in order:
            ks, vs = fresh_kv[slot][:2]
            kd[:, slot, :, :cols] = ks[:, :cols].transpose(1, 2)
            vd[:, slot, :, :cols] = vs[:, :cols].transpose(1, 2)
        cache = self._window_cache(kd, vd, seq_lens, s_base)
        t0 = self._lap("window_gather", t0)
        packed, cache, _ = self._window_loop(cache, cur, active, rem, n_steps, s_base)
        self._lap("window_steps", t0)
        return (packed, *self._window_columns(cache, s_base, steps))

    # -- client API ----------------------------------------------------------

    def submit(self, batch: GARBatch, prompt_len: int) -> int:
        """Queue one request (batch dim 1, on the engine's device). Returns
        its id. Raises, before anything runs, for a video request, for a
        request on another device, or for one whose prompt and budget need
        more pages than a slot's block table or the whole pool holds."""
        if batch.input_ids.shape[0] != 1:
            raise ValueError(f"submit one request at a time, got a batch of "
                             f"{batch.input_ids.shape[0]}")
        if batch.replay_tile is not None:
            raise ValueError("video requests (a batch with replay_tile) are not served: the "
                             "engine prefills in image mode; use generate(video_mode=True)")
        off = sorted({str(x.device) for x in batch
                      if x is not None and not _on(x.device, self.device)})
        if off:
            raise ValueError(f"the engine runs on {self.device}, but the request is on {off}")
        self._budget_pages(int(prompt_len))
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, batch, int(prompt_len)))
        self.req_stats[rid] = {"submit": time.perf_counter(), "first": None, "done": None,
                               "prompt_len": int(prompt_len), "n_tokens": 0}
        return rid

    def _mark_tokens(self, rid: int, n_new: int) -> None:
        """Record host-visible token arrivals (called at fetches only)."""
        st = self.req_stats.get(rid)
        if st is None or n_new <= 0:
            return
        if st["first"] is None:
            st["first"] = time.perf_counter()
        st["n_tokens"] += n_new

    def latency_stats(self) -> dict:
        """Latency of the requests that finished since the last call, which
        are then dropped from `req_stats`: p50 / p95 TTFT (submit -> first
        host-visible token), p50 / p95 latency (submit -> done), and their
        tokens over the span from the first submit to the last finish.
        Every key is present; the figures are None when no request
        finished."""
        done = {rid: s for rid, s in self.req_stats.items()
                if s["done"] is not None and s["first"] is not None}
        for rid in done:
            del self.req_stats[rid]
        stats = dict.fromkeys(("ttft_p50_s", "ttft_p95_s", "latency_p50_s", "latency_p95_s",
                               "tok_per_s"))
        stats["n"] = len(done)
        if not done:
            return stats
        ttft = np.sort([s["first"] - s["submit"] for s in done.values()])
        total = np.sort([s["done"] - s["submit"] for s in done.values()])

        def pct(a, p):
            return float(a[min(len(a) - 1, int(round(p / 100 * (len(a) - 1))))])

        toks = sum(s["n_tokens"] for s in done.values())
        span = (max(s["done"] for s in done.values())
                - min(s["submit"] for s in done.values()))
        stats.update(ttft_p50_s=pct(ttft, 50), ttft_p95_s=pct(ttft, 95),
                     latency_p50_s=pct(total, 50), latency_p95_s=pct(total, 95),
                     tok_per_s=toks / span if span > 0 else None)
        return stats

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any()) or bool(self._prefill_jobs)

    @torch.inference_mode()
    def run(self, on_event=None) -> Dict[int, List[int]]:
        """Drain the queue; returns request id -> token ids. on_event gets a
        StepEvent a generated token (with decode_chunk > 1 in bursts at the
        window boundaries)."""
        if self.ecfg.decode_chunk > 1:
            self._run_pipelined(on_event)
        else:
            while self.has_work():
                for ev in self.step():
                    if on_event is not None:
                        on_event(ev)
        out, self.finished = self.finished, {}
        return out

    # -- scheduling ----------------------------------------------------------

    def _budget_pages(self, prompt_len: int) -> int:
        # +1 only: the window tracks eot and the budget on the device, so no
        # speculative token is ever cached
        e = self.ecfg
        n = pages_needed(prompt_len + e.max_new_tokens + 1, e.page_size)
        for limit, name in ((e.max_pages_per_slot, "max_pages_per_slot"),
                            (e.num_pages - 1, "num_pages - 1 (page 0 is the trash page)")):
            if n > limit:
                raise ValueError(f"a request of {prompt_len} prompt tokens and max_new_tokens "
                                 f"{e.max_new_tokens} needs {n} pages of {e.page_size}, more "
                                 f"than {name} = {limit}")
        return n

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.slots) if not self.active[i] and i not in self._reserved]

    def _admit(self, defer_tok0: bool = False) -> None:
        """Admit as many queued requests as slots and pages allow; same-shape
        requests at the head of the queue prefill together.

        defer_tok0 (windowed mode): fetch nothing. The device tok0s queue
        in `_deferred`, the window seeds them into `cur` and returns them in
        its one fetch, and the prompt K/V wait in `_fresh_kv` (the burst
        path reads them straight from the prefill output; a request that
        finishes inside its first window never touches its pages)."""
        if defer_tok0 and self.ecfg.prefill_chunk and self.active.any() and self.queue:
            # slots are decoding: start chunked prefills instead of stalling
            # every slot for a whole prompt
            self._start_chunked_prefills()
            return
        mp = self.ecfg.max_pages_per_slot
        while self.queue:
            free_slots = self._free_slots()
            group: List[Tuple[int, GARBatch, int, List[int]]] = []
            budget = self.allocator.free_pages
            shape0 = None
            for rid, batch, plen in self.queue:
                if len(group) >= len(free_slots):
                    break
                need = self._budget_pages(plen)
                if budget < need:
                    break
                # bucket on every leaf's shape: tiles, regions and length vary
                # per request and concatenate only when equal
                shape = tuple(None if x is None else tuple(x.shape) for x in batch)
                if shape0 is None:
                    shape0 = shape
                elif shape != shape0:
                    break  # a bucket boundary; the next _admit takes it
                group.append((rid, batch, plen, self.allocator.alloc(need)))
                budget -= need
            if not group:
                return
            for _ in group:
                self.queue.popleft()
            batch = (group[0][1] if len(group) == 1 else
                     map_batch(lambda *xs: torch.cat(xs, dim=0), *(g[1] for g in group)))
            try:
                tok0s, (ks, vs) = self._prefill(batch, self._dev([g[2] for g in group]))
            except Exception:
                # a long-lived server must not leak pool capacity on a failed prefill
                for _, _, _, pages in group:
                    self.allocator.release(pages)
                raise
            if defer_tok0:
                self._deferred.append((free_slots[: len(group)], tok0s))
            else:
                tok0s = tok0s.cpu().numpy()
            for i, (rid, _, plen, pages) in enumerate(group):
                slot = free_slots[i]
                page_vec = np.zeros(mp, np.int32)
                page_vec[: len(pages)] = pages
                self.block_table[slot] = page_vec
                self.seq_lens[slot] = plen
                self.active[slot] = True
                if defer_tok0:
                    self._fresh_kv[slot] = (ks[:, i], vs[:, i], plen, page_vec)
                    self.slots[slot] = _SlotState(request_id=rid, pages=pages)
                    self._fresh.add(slot)
                    continue
                self._seed(ks[:, i], vs[:, i], plen, page_vec)
                tok0 = int(tok0s[i])
                self._mark_tokens(rid, 1)  # tok0 was fetched above
                self.cur[slot] = tok0
                self.slots[slot] = _SlotState(request_id=rid, pages=pages, tokens=[tok0])
                done0 = tok0 == self.ecfg.eot_id or self.ecfg.max_new_tokens == 1
                self._pending_events.append(StepEvent(rid, tok0, done0))
                if done0:
                    self._retire(slot)

    def _start_chunked_prefills(self) -> None:
        """Pop queued requests into _PrefillJobs: the tower and replay run
        now (one call a request), the decoder sweep advances prefill_chunk
        tokens an engine cycle (_advance_prefills)."""
        e = self.ecfg
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            rid, batch, plen = self.queue[0]
            need = self._budget_pages(plen)
            if self.allocator.free_pages < need:
                return
            self.queue.popleft()
            pages = self.allocator.alloc(need)
            try:
                embeds = build_prefill_embeds(self.params, self.cfg, batch,
                                              mask_compat=e.mask_compat,
                                              double_scale_compat=e.double_scale_compat,
                                              compute_dtype=self.dtype)
            except Exception:
                self.allocator.release(pages)
                raise
            self._count("tower_passes")
            slot = free[0]
            self._reserved.add(slot)
            self._prefill_jobs.append(_PrefillJob(request_id=rid, slot=slot, plen=plen,
                                                  pages=pages, embeds=embeds))

    def _advance_prefills(self) -> None:
        """Advance every chunked prefill in flight by one chunk."""
        c = self.ecfg.prefill_chunk
        finished = []
        for job in self._prefill_jobs:
            s = job.embeds.shape[1]
            c0 = job.pos
            c1 = min(c0 + c, s)
            pos = torch.arange(c0, c1, dtype=torch.int32, device=self.device)[None]
            hidden, job.kv = llama_prefill_chunk(self.params.llm, self.cfg.text,
                                                 job.embeds[:, c0:c1], pos, job.kv)
            self._count("prefill_chunks")
            job.pos = c1
            if c0 <= job.plen - 1 < c1:
                job.last_hidden = (hidden, c0)
            # chunks past the prompt are right padding: the seed writes plen
            # tokens only, so they are skipped
            if c1 >= s or c1 >= job.plen:
                finished.append(job)
        for job in finished:
            self._prefill_jobs.remove(job)
            self._finish_prefill(job)

    def _finish_prefill(self, job: _PrefillJob) -> None:
        page_vec = np.zeros(self.ecfg.max_pages_per_slot, np.int32)
        page_vec[: len(job.pages)] = job.pages
        ks, vs = job.kv  # (L, 1, P, K, Dh)
        self._seed(ks[:, 0], vs[:, 0], job.plen, page_vec)
        hidden, h0 = job.last_hidden
        tok0 = self._next_tokens(hidden[0, job.plen - 1 - h0][None])  # (1,)
        slot = job.slot
        self.block_table[slot] = page_vec
        self.seq_lens[slot] = job.plen
        self.active[slot] = True
        self.slots[slot] = _SlotState(request_id=job.request_id, pages=job.pages)
        self._reserved.discard(slot)
        self._deferred.append(([slot], tok0))
        self._fresh.add(slot)

    def _retire(self, slot: int) -> None:
        st = self.slots[slot]
        rs = self.req_stats.get(st.request_id)
        if rs is not None:
            rs["done"] = time.perf_counter()
        self.finished[st.request_id] = st.tokens
        self.allocator.release(st.pages)
        self.block_table[slot] = 0
        self.seq_lens[slot] = 0
        self.active[slot] = False
        self.slots[slot] = None

    # -- one engine tick -----------------------------------------------------

    @torch.inference_mode()
    def step(self) -> List[StepEvent]:
        """Admit, then one per-token step of every active slot (one fetch)."""
        self._admit()
        events, self._pending_events = self._pending_events, []
        if not self.active.any():
            return events
        nxt = self._decode(self._dev(self.cur), self._dev(self.block_table),
                           self._dev(self.seq_lens), self._dev(self.active))
        nxt = nxt.cpu().numpy()
        e = self.ecfg
        for slot in range(e.slots):
            if not self.active[slot]:
                continue
            st = self.slots[slot]
            self.seq_lens[slot] += 1  # the step cached cur's K/V
            tok = int(nxt[slot])
            self._mark_tokens(st.request_id, 1)
            st.tokens.append(tok)
            self.cur[slot] = tok
            done = tok == e.eot_id or len(st.tokens) >= e.max_new_tokens
            events.append(StepEvent(st.request_id, tok, done))
            if done:
                self._retire(slot)
        return events

    def _burst(self, live: List[int]) -> bool:
        """Whether the next window takes the burst path: every live slot was
        admitted this cycle, with one prompt shape."""
        fresh_kv = self._fresh_kv
        return (bool(fresh_kv) and all(s in fresh_kv for s in live)
                and len({fresh_kv[s][0].shape for s in live}) == 1)

    def _run_pipelined(self, on_event=None) -> None:
        """Windowed decode: one window of up to decode_chunk tokens for all
        slots and one fetch a cycle, then retire and admit at the boundary."""
        e = self.ecfg
        if self._pending_events:  # left over from step() calls
            if on_event is not None:
                for ev in self._pending_events:
                    on_event(ev)
            self._pending_events = []
        while self.has_work():
            t0 = time.perf_counter()
            self._advance_prefills()
            t0 = self._lap("prefill_chunks", t0)
            self._admit(defer_tok0=True)
            t0 = self._lap("admit", t0)
            if not self.active.any():
                # chunked prefills will activate their slots; a queued request
                # always fits an idle engine (`submit` checks its pages)
                continue
            live = [s for s in range(e.slots) if self.active[s]]
            rem = np.zeros(e.slots, np.int32)
            for s in live:
                # a fresh slot's tok0 (still on the device) counts against its budget
                rem[s] = e.max_new_tokens - len(self.slots[s].tokens) - (s in self._fresh)
            n_steps = min(e.decode_chunk, max(int(rem.max()), 0))
            cur = self._dev(self.cur)
            for slot_list, tok0s in self._deferred:
                cur.index_copy_(0, self._dev(np.asarray(slot_list, np.int64)), tok0s)
            self._deferred = []
            # the dense cache's column budget: the longest live sequence,
            # rounded up to a multiple of 256 tokens (of whole pages) so the
            # shapes are few; the window's total rounds up to 512 after it
            bucket = e.page_size * max(1, 256 // e.page_size)
            s_base = int(max(self.seq_lens[s] for s in live))
            s_base = min(-(-s_base // bucket) * bucket, e.max_pages_per_slot * e.page_size)
            # the burst path, or else seed the pending fresh K/V into pages
            fresh_kv = self._fresh_kv
            use_fresh = self._burst(live)
            if fresh_kv and not use_fresh:
                for ks_s, vs_s, plen, page_vec in fresh_kv.values():
                    self._seed(ks_s, vs_s, plen, page_vec)
                self._fresh_kv = fresh_kv = {}
            start_lens = self.seq_lens.copy()
            seq_lens, active, rem_d = (self._dev(start_lens), self._dev(self.active),
                                       self._dev(rem))
            t0 = self._lap("window_setup", t0)
            self._count("windows")
            if use_fresh:
                self._count("fresh_windows")
                order = sorted(live)
                packed, kwin, vwin = self._decode_window_fresh(fresh_kv, order, cur, seq_lens,
                                                               active, rem_d, n_steps, s_base)
            else:
                packed = self._decode_window(cur, self._dev(self.block_table), seq_lens,
                                             active, rem_d, n_steps, s_base)
            t0 = time.perf_counter()
            packed = packed.cpu().numpy()  # the window's one fetch
            t0 = self._lap("window_fetch", t0)
            cur0, counts, toks = packed[0], packed[1], packed[2:]
            fresh, self._fresh = self._fresh, set()
            for s in live:
                st = self.slots[s]
                if s in fresh:
                    tok0 = int(cur0[s])
                    self._mark_tokens(st.request_id, 1)
                    st.tokens.append(tok0)
                    if on_event is not None:
                        on_event(StepEvent(st.request_id, tok0,
                                           tok0 == e.eot_id or e.max_new_tokens == 1))
                n = int(counts[s])
                self._mark_tokens(st.request_id, n)
                for t in range(n):
                    tok = int(toks[t, s])
                    st.tokens.append(tok)
                    if on_event is not None:
                        on_event(StepEvent(st.request_id, tok, tok == e.eot_id
                                           or len(st.tokens) >= e.max_new_tokens))
                self.cur[s] = st.tokens[-1]
                self.seq_lens[s] += n
                if st.tokens[-1] == e.eot_id or len(st.tokens) >= e.max_new_tokens:
                    self._retire(s)
            if use_fresh:
                # the window left the pools alone: the slots that survive it
                # get their prompt pages seeded and then the window's columns
                # flushed on top (in that order: the seed writes every page
                # of the slot, zeros past the prompt). A retired slot's pages
                # are never written.
                survivors = [s for s in order if self.active[s]]
                if survivors:
                    for s in survivors:
                        ks_s, vs_s, plen, page_vec = fresh_kv[s]
                        self._seed(ks_s, vs_s, plen, page_vec)
                    counts_m = np.where(self.active, counts, 0).astype(np.int32)
                    flush_window_pages(self.k_pool, self.v_pool, kwin, vwin,
                                       self._dev(self.block_table), self._dev(start_lens),
                                       self._dev(counts_m), 0, e.decode_chunk)
                    self._count("flushes")
                self._fresh_kv = {}
            self._lap("window_host", t0)
