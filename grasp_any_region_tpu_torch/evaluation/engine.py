"""Batched benchmark inference (`grasp_any_region_tpu/evaluation/engine.py`).

The reference loops benchmark items one at a time through GARModel.generate
(GAR-Bench/inference.py:117-174). Here items go in fixed-size groups
through `GARRuntime.batch` and `answer` (the host's builder and collate,
then `generate`), so the card decodes B caption streams a weight pass. A
short last chunk is padded to the batch size with copies of its last item
(when there is more than one chunk), as JAX pads it to reuse its compiled
shape: a batch's prompt bucket, and so its bf16 numbers, are then the same
as JAX's for the same items.

`timer` (utils/profiling.PhaseTimer) keeps each batch's host ("batch") and
generate ("answer") seconds, and `batches` each batch's items, padding and
decode steps.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Sequence

from ..cli.runtime import GARRuntime
from ..data.builders import RegionSample
from ..utils.profiling import PhaseTimer


class BatchedCaptioner:
    def __init__(self, runtime: GARRuntime, batch_size: int = 8,
                 max_new_tokens: int = 1024):
        self.rt = runtime
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.timer = PhaseTimer()
        self.batches: List[dict] = []

    def run(self, samples: Sequence[RegionSample]) -> List[str]:
        outs: List[str] = []
        bs = self.batch_size
        t0 = time.time()
        for i in range(0, len(samples), bs):
            chunk = list(samples[i : i + bs])
            pad = 0
            if len(chunk) < bs and len(samples) > bs:
                pad = bs - len(chunk)  # the full batch's shape
                chunk = chunk + [chunk[-1]] * pad
            with self.timer.phase("batch"):
                batch, plens = self.rt.batch(chunk)
            with self.timer.phase("answer"):
                texts, res = self.rt.answer(batch, plens, max_new_tokens=self.max_new_tokens)
            self.batches.append({"items": len(chunk) - pad, "pad": pad, "steps": res.steps})
            outs.extend(texts[: len(texts) - pad] if pad else texts)
            done = min(i + bs, len(samples))
            rate = done / (time.time() - t0)
            print(f"[eval] {done}/{len(samples)} ({rate:.2f} items/s)",
                  file=sys.stderr)
        return outs


def write_outputs(path: str, items: List[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(items, f, indent=4, ensure_ascii=False)
    print(f"[eval] wrote {path}", file=sys.stderr)


def load_cache(path: str):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None
