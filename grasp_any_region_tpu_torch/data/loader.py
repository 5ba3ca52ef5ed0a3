"""Prefetching data loader: host preprocessing overlaps the device step
(`grasp_any_region_tpu/data/loader.py`).

A thread pool builds the samples. The costly work of a sample, RLE mask
decode and bicubic tiling, runs in C++ through ctypes (`data/native.py`),
which releases the interpreter lock, so the worker threads run in parallel
with each other and with the step on the card.

Order and failure:
  * batches come strictly in index order (futures are read first in,
    first out; the prefetch depth only sets how far ahead workers run);
  * a sample that raises raises at the batch that holds it (the dataset's
    `__getitem__` does its own bounded refetch).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, List, Sequence

__all__ = ["PrefetchLoader"]


class PrefetchLoader:
    """Iterate `dataset[i]` for i in `indices`, `batch_size` at a time,
    building samples on a thread pool `prefetch_batches` ahead of the
    consumer and collating each batch with `collate_fn(list_of_samples)`."""

    def __init__(self, dataset, indices: Sequence[int], *, batch_size: int,
                 collate_fn: Callable[[List], object], num_workers: int = 4,
                 prefetch_batches: int = 2, drop_last: bool = False):
        if batch_size < 1 or num_workers < 1 or prefetch_batches < 1:
            raise ValueError(f"batch_size {batch_size}, num_workers {num_workers} and "
                             f"prefetch_batches {prefetch_batches} must be at least 1")
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.drop_last = drop_last

    def _batches(self) -> List[List[int]]:
        bs = self.batch_size
        out = [self.indices[i:i + bs] for i in range(0, len(self.indices), bs)]
        if self.drop_last and out and len(out[-1]) < bs:
            out.pop()
        return out

    def __len__(self) -> int:
        return len(self._batches())

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: List[List[Future]] = []
            submitted = 0

            def top_up():
                nonlocal submitted
                while submitted < len(batches) and len(pending) < self.prefetch_batches:
                    pending.append([pool.submit(self.dataset.__getitem__, i)
                                    for i in batches[submitted]])
                    submitted += 1

            top_up()
            while pending:
                futs = pending.pop(0)
                top_up()  # keep the workers busy while the head is awaited
                samples = [f.result() for f in futs]
                yield self.collate_fn(samples)
