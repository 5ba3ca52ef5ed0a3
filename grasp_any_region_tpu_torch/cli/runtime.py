"""The CLIs' runtime (`grasp_any_region_tpu/cli/runtime.py`): model loading
and the image -> caption pipeline.

`GARRuntime.load` reads a checkpoint directory (native or HF-exported,
`core/weights.load_checkpoint`) or makes seeded random weights, on the
card unless the caller asks for the CPU. `caption` is `batch` (the
builder and the collate on the host, `data/builders.build_region_batch`)
then `answer` (`models/generate.generate`, or with `speculative=(gamma,
k)` `models/speculative.generate_speculative`, and the decoded text). One
`torch.Generator` seeded from `seed` draws the random init and the
sampling.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import PRESETS, GARConfig
from ..core.weights import init_gar_params, load_checkpoint, require_device
from ..data.builders import (RegionSample, VideoRegionSample, build_region_batch,
                             build_video_batch)
from ..data.image_processor import GARImageProcessor, ImageProcessorConfig
from ..data.png import read_image
from ..data.tokenizer import GARTokenizer
from ..models.gar import GARBatch, GARParams
from ..models.generate import GenerationResult, generate
from ..models.speculative import SpecResult, generate_speculative


@dataclass
class GARRuntime:
    cfg: GARConfig
    params: GARParams
    tok: GARTokenizer
    proc: GARImageProcessor
    device: torch.device
    compute_dtype: torch.dtype
    generator: torch.Generator

    @classmethod
    def load(
        cls,
        model_path: Optional[str] = None,
        preset: str = "gar_1b",
        random_init: bool = False,
        seed: int = 0,
        int8_serving: bool = False,
        *,
        device="cuda",
    ) -> "GARRuntime":
        """A checkpoint directory's weights, else the preset's with seeded
        random weights, in bf16 (also the compute dtype) on `device`.

        int8_serving: serving-only int8 decoder weights
        (`models/quantize.serving_weights`: per-output-channel int8
        matmuls and head, no resident bf16 decoder copies)."""
        device = require_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        dtype = torch.bfloat16
        cfg = tok = params = None
        if model_path is not None and os.path.isdir(model_path):
            cfg, params = load_checkpoint(model_path, device=device, dtype=dtype)
            tok_file = os.path.join(model_path, "tokenizer.json")
            if os.path.exists(tok_file):
                tok = GARTokenizer.from_file(tok_file, cfg.prompt_numbers)
        if cfg is None:
            cfg = PRESETS[preset]()
        if params is None:
            if not random_init:
                print("[gar] no checkpoint found — using RANDOM weights "
                      "(pass --random-init to silence)", file=sys.stderr)
            params = init_gar_params(cfg, generator, device=device, dtype=dtype)
        if tok is None:
            tok = GARTokenizer.synthetic(cfg.prompt_numbers)
        if int8_serving:
            from ..models.quantize import serving_weights

            params = serving_weights(params)
            print("[gar] int8 serving-only weights: decoder matmuls quantized "
                  "per-output-channel int8 (no resident bf16 copies). Quality "
                  "vs bf16 is validated on random weights only — run "
                  "cli/parity.py check (c) against a real checkpoint before "
                  "trusting captions.", file=sys.stderr)
        proc = GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles))
        return cls(cfg=cfg, params=params, tok=tok, proc=proc, device=device,
                   compute_dtype=dtype, generator=generator)

    def caption(
        self,
        samples: List[RegionSample],
        *,
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
        speculative: Optional[tuple] = None,  # (gamma, draft_layers)
    ) -> List[str]:
        """The decoded text of each sample (single-region captions, or
        answers to questions over <PromptK> regions).

        speculative: (gamma, draft_layers) decodes one sample greedily by
        self-speculative draft / verify (`models/speculative.py`): the
        same tokens, fewer weight streams a token when the shallow draft
        guesses well."""
        batch, plens = self.batch(samples)
        return self.answer(batch, plens, max_new_tokens=max_new_tokens,
                           temperature=temperature, speculative=speculative)[0]

    def caption_video(
        self,
        samples: List[VideoRegionSample],
        *,
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
    ) -> List[str]:
        """The decoded answer of each video sample (`build_video_batch`,
        `generate(video_mode=True)`)."""
        batch, plens = self.batch(samples)
        return self.answer(batch, plens, max_new_tokens=max_new_tokens,
                           temperature=temperature, video_mode=True)[0]

    def batch(self, samples) -> Tuple[GARBatch, torch.Tensor]:
        """The host's part of a caption: the builder and the collate of
        region samples, or of video samples (`build_video_batch`), on the
        runtime's device."""
        video = isinstance(samples[0], VideoRegionSample)
        build = build_video_batch if video else build_region_batch
        return build(self.cfg, self.tok, self.proc, samples, device=self.device)

    def answer(self, batch: GARBatch, plens: torch.Tensor, *, max_new_tokens: int = 1024,
               temperature: float = 0.0, video_mode: bool = False,
               speculative: Optional[tuple] = None,
               ) -> Tuple[List[str], Union[GenerationResult, SpecResult]]:
        """`generate` on a collated batch (or `generate_speculative` with
        speculative=(gamma, draft_layers): one image row, greedy), then the
        decoded text of each row (up to its eot): (texts, the result)."""
        t0 = time.perf_counter()
        if speculative is not None:
            if len(plens) != 1 or temperature != 0.0 or video_mode:
                raise ValueError("speculative decode is single-stream greedy: one image "
                                 f"sample at temperature 0 (got {len(plens)} rows, temperature "
                                 f"{temperature}, video_mode {video_mode})")
            gamma, k = speculative
            out = generate_speculative(self.params, self.cfg, batch, plens,
                                       max_new_tokens=max_new_tokens, gamma=gamma,
                                       draft_layers=k, eot_id=self.tok.eot_id,
                                       compute_dtype=self.compute_dtype)
        else:
            out = generate(self.params, self.cfg, batch, plens, max_new_tokens=max_new_tokens,
                           eot_id=self.tok.eot_id, temperature=temperature,
                           generator=self.generator, compute_dtype=self.compute_dtype,
                           video_mode=video_mode)
        toks = out.tokens.cpu().numpy()  # waits for the card
        nums = out.num_generated.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"[gar] {len(toks)} caption(s) in {dt:.2f}s ({int(nums.sum())} tokens)",
              file=sys.stderr)
        texts = []
        for i in range(len(toks)):
            ids = toks[i, :nums[i]].tolist()
            if ids and ids[-1] == self.tok.eot_id:
                ids = ids[:-1]
            texts.append(self.tok.decode(ids, skip_special_tokens=False))
        return texts, out


def load_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB (PIL's convert("RGB")): PNGs
    through `data/png.py`, other formats through PIL."""
    return read_image(path, "RGB")


def load_mask(path: str) -> np.ndarray:
    """A mask image as a binary (H, W) uint8 mask: PIL's convert("L") > 127."""
    return (read_image(path, "L") > 127).astype(np.uint8)
