"""Paged KV cache: a global page pool, block tables and a host-side
allocator (`grasp_any_region_tpu/serve/paged_cache.py`).

  * `PagedKV`: the device state, k and v pools (L, K, N, page_size, D),
    head-major like models/llama.KVCache, block tables (slots, max_pages)
    and per-slot sequence lengths. Page 0 is a reserved trash page: unused
    block-table entries point at it, and masked or inactive writes land
    there, so no write needs a condition on the host.
  * `PageAllocator`: the host's free list (page ids are ints in block
    tables; allocation touches no device memory).
  * `write_prompt_pages`, `append_token_pages`, `flush_window_pages`:
    scatters into the pools, in place; `gather_pages_dense`: each slot's
    pages gathered into the dense two-interval cache a decode window runs on.

Indexing: torch applies an integer index first and keeps adjacent advanced
indices in place, where numpy (and JAX) move them to the front, so the
targets here are spelled out shape by shape. Every scatter may write page 0
more than once in one call; which write wins there is not fixed on the
card, and nothing reads page 0 unmasked.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class PagedKV(NamedTuple):
    k: torch.Tensor  # (L, K, N, page_size, D)
    v: torch.Tensor  # (L, K, N, page_size, D)
    block_table: torch.Tensor  # (slots, max_pages) int32; 0 = the trash page
    seq_lens: torch.Tensor  # (slots,) int32 cached tokens per slot


def init_paged_kv(
    num_layers: int,
    num_pages: int,
    page_size: int,
    kv_heads: int,
    head_dim: int,
    *,
    slots: int,
    max_pages_per_slot: int,
    dtype=torch.bfloat16,
    device="cpu",
) -> PagedKV:
    shape = (num_layers, kv_heads, num_pages, page_size, head_dim)
    return PagedKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_table=torch.zeros((slots, max_pages_per_slot), dtype=torch.int32, device=device),
        seq_lens=torch.zeros((slots,), dtype=torch.int32, device=device),
    )


class PageAllocator:
    """Host-side free list over page ids 1..N-1 (0 is the trash page)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"a pool needs the trash page and one more, got {num_pages} pages")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} is not an allocatable page of {self.num_pages}")
            self._free.append(int(p))


def pages_needed(tokens: int, page_size: int) -> int:
    return max(1, -(-tokens // page_size))


def write_prompt_pages(
    k_pool: torch.Tensor,  # (L, K, N, PS, D)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (L, S, K, D) one sequence's prefill K
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # (MP,) int: unused tail entries are 0
    seq_len: int,  # true prompt length (<= S); JAX's signature, unused as there
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one sequence's prompt K/V into its pages, in place: S padded
    with zeros to MP * PS and every listed page written, so the tail
    entries (id 0) write the trash page. Returns the pools."""
    l, s, kh, d = k_new.shape
    mp = page_ids.shape[0]
    ps = k_pool.shape[3]
    pad = mp * ps - s
    if pad < 0:
        raise ValueError(f"prompt of {s} tokens exceeds the page budget {mp} x {ps}")
    ids = page_ids.long()
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        # (L, S, K, D) -> head-major (L, K, MP, PS, D)
        x = torch.nn.functional.pad(new.to(pool.dtype), (0, 0, 0, 0, 0, pad))
        pool.index_copy_(2, ids, x.transpose(1, 2).reshape(l, kh, mp, ps, d))
    return k_pool, v_pool


def gather_pages_dense(
    k_pool: torch.Tensor,  # (L, K, N, PS, D)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP)
    s_base: int,  # column budget to gather (a multiple of PS)
    window: int,  # columns for the decode window after it
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's first s_base / PS pages as a dense (L, B, K, total, D)
    cache, the two-interval KVCache layout: the cached tokens in
    [0, seq_len_b), the window from column s_base, zeros from s_base on.
    total is s_base + window rounded up to a multiple of 512, the JAX
    shape (its attention kernel's block; kernel C takes any S)."""
    ps = k_pool.shape[3]
    if s_base % ps:
        raise ValueError(f"s_base {s_base} is not a multiple of the page size {ps}")
    bt = block_table[:, : s_base // ps].long()
    l, kh, _, _, d = k_pool.shape
    b = bt.shape[0]
    total = ((s_base + window + 511) // 512) * 512

    def gather(pool):
        dense = pool.new_zeros((l, b, kh, total, d))
        pages = pool[:, :, bt].reshape(l, kh, b, s_base, d)  # (L, K, B, n*PS, D)
        dense[:, :, :, :s_base] = pages.transpose(1, 2)
        return dense

    return gather(k_pool), gather(v_pool)


def flush_window_pages(
    k_pool: torch.Tensor,  # (L, K, N, PS, D)
    v_pool: torch.Tensor,
    k_dense: torch.Tensor,  # (L, B, K, >= s_base + window, D), window columns filled
    v_dense: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP)
    start_lens: torch.Tensor,  # (B,) tokens cached before the window
    counts: torch.Tensor,  # (B,) tokens decoded in the window
    s_base: int,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter the window's new K/V (dense columns [s_base, s_base +
    counts_b)) into each slot's pages at token positions start_lens_b + j,
    in place, as one scatter a pool; columns past a slot's count go to the
    trash page. Returns the pools."""
    ps = k_pool.shape[3]
    b, mp = block_table.shape
    ts = torch.arange(window, device=counts.device)[None, :]  # (1, T)
    mask = ts < counts[:, None]  # (B, T)
    pos = start_lens[:, None].long() + ts  # (B, T)
    page = torch.gather(block_table.long(), 1, (pos // ps).clamp(max=mp - 1))
    pid = torch.where(mask, page, 0)
    off = torch.where(mask, pos % ps, 0)
    for pool, dense in ((k_pool, k_dense), (v_pool, v_dense)):
        win = dense[:, :, :, s_base: s_base + window]  # (L, B, K, T, D)
        # pool[:, :, pid, off] is (L, K, B, T, D): the advanced dims stay in place
        pool[:, :, pid, off] = win.transpose(1, 2).to(pool.dtype)
    return k_pool, v_pool


def token_slots(block_table: torch.Tensor, write_pos: torch.Tensor, active: torch.Tensor,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page id, offset) of each slot's token at position write_pos[b];
    inactive slots get offset 0 of the trash page 0."""
    wp = write_pos.long()
    page = torch.gather(block_table.long(), 1,
                        (wp // page_size).clamp(max=block_table.shape[1] - 1)[:, None])[:, 0]
    return torch.where(active, page, 0), torch.where(active, wp % page_size, 0)


def append_token_pages(
    k_pool: torch.Tensor,  # (L, K, N, PS, D)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (L, B, K, D) this step's K per slot
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP)
    write_pos: torch.Tensor,  # (B,) int position the token lands at
    active: torch.Tensor,  # (B,) bool: inactive rows write the trash page
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token a slot into its page, in place. Returns the pools."""
    pid, off = token_slots(block_table, write_pos, active, k_pool.shape[3])
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        pool[:, :, pid, off] = new.transpose(1, 2).to(pool.dtype)  # target (L, K, B, D)
    return k_pool, v_pool
