"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Imports no jax. Phases, each printing its own lines; any failure raises and
the script exits non-zero (there is no CPU fallback):

1. Environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions; builds the CUDA kernels from csrc/ and prints the
   build time.
2. Each kernel against its plain PyTorch version at GAR-1B shapes, on
   seeded bf16 (int8) inputs (the plain version in fp32 from the same
   inputs), atol = rtol = 2e-2 (bf16 p before PV, bf16 LayerNorm and GELU
   outputs before their products, bf16 output); median times of kernel and
   plain version from CUDA events, the kernel's bound (the larger of its
   bytes over 3.35 TB/s and its bf16 operations over 989 TFLOP/s, the
   H100 SXM's published peaks) and, where one PyTorch call computes the
   same function (SDPA for A and B, torch.mm for H, the W8A16 product
   torch._weight_int8pack_mm for H8, SDPA over views of E's fused buffer,
   torch.addmm for F, SDPA with the boolean mask for C), that call's time.
   D, F and G (the GEMMs of csrc/gemm_sm90.cu; D and G behind a LayerNorm
   pass) also at a tolerance sized to the output, D's and G's parts timed
   one by one (together they give the call's bits), the host time a call,
   and the cuBLAS composite of each (a sequence of calls, timed only).
   H, H8, I, I8, J and J8 (the TMA-fed weight stream, bf16 and int8) also
   with their host times a call and their times by CTAs a tile; J and J8
   (three segments, q, k and v) also against their stream mirrors, and
   J8 beside its library composite (three torch._weight_int8pack_mm).
   E also at a ragged S = 200. The decode matmuls H, I, J and their int8
   forms H8, I8, J8 also at B = 24 (with their GB/s of weights, cuBLAS's
   bf16 product of the same layer and the card's copy rate on the same
   bytes) and at the narrow config's ragged widths, J and J8 also at
   ragged q and kv widths. C8 (int8 KV, C's
   split-KV body) at the main path's cache, B = 1 and 5120 columns, and at
   B = 24, at atol 2e-3 and rtol 2^-8 (TOL16) with the interval probe and
   a current-token probe (`q8_probe`), beside C on a bf16 cache of the same
   shape, its CTAs a (kv head, row) swept 1-16; its written column within
   one quantization step of the plain version's. The mega
   decode step's kernels 19-23 at gar_1b shapes, B = 24 and B = 1 (22 with
   bf16 and with int8 wo, over a cache of the main path's shape, its
   written K/V column checked, beside kernel C + kernel H on wo; 21-23 also
   give the same bits on a second launch and leave their ordered sums'
   counters at 0; 19 and 20, on the weight stream, also against their
   stream mirrors, 16 layers back to back, their host time a call and their
   time by CTAs a tile), with their GB/s; the plain versions here take the
   same bf16 inputs. The two
   kernels that no JAX path dispatches, so that no later phase launches
   them: 16 (read-only decode attention, C's split-KV body read only) over
   C's seeded cache at every layer, the layer a device scalar, the cache
   unchanged, also at B = 24, with its CTAs a (kv head, row) swept 1-16,
   with SDPA under the two-interval boolean mask (enable_gqa) as its
   library call; 24 (LayerNorm) at the tower's (17, 1025, 1024) in bf16
   and fp32 and at a ragged (3, 37, 1024), with F.layer_norm as its
   library call beside the port's plain `layer_norm` (the tower's form),
   and `layer_norm_fused_df`'s forward and backward against autograd
   through the plain `layer_norm`.
3. End-to-end cross-check on a narrow gar_1b (ViT width 256, decoder
   hidden 256, 2 layers each, head dim 64): the same seeded bf16 params on
   the card (kernel path: the fused ViT and the fused decode step) and on
   the CPU (plain path: the unfused ViT, the XLA-form decode step);
   prefill logits and the first 4 decode-step logits must agree. Then once
   more with int8 decode weights and an int8 cache (2 kv heads, so the
   heads pair), the card's H8, I8, J8, C8 against their plain versions.
   Then the mega step (use_kernel="mega", a bf16 cache) on both sides, with
   bf16 and with int8 weights: 19, 22, 23 (20, 22, 21) once a layer.
4. Vision forms: the gar_1b tower over 17 tiles in the fused form (kernels
   D, E, F, G) and the unfused form (kernel A) on the same params and
   inputs; their outputs must agree to 5e-2 of the output range, and each
   form must launch its kernels once per layer.
5. Decode forms: one gar_1b decode step over the main path's seeded cache
   in the fused form (kernels J, C, H, I, H a layer) and in the XLA form
   (cuBLAS products around C), from the same input embedding; hidden and
   written K/V must agree to 5e-2 of their range; device and host ms per
   step of each form. Then the int8 fused step (J8, C8, H8, I8, H8 a layer)
   from the same cache seeded int8, its ms and its gap to the bf16 step;
   the mega step on the bf16 cache (19, 22, 23 a layer) held to the XLA
   form, and with int8 weights (20, 22, 21) held to the XLA form of the
   serving-only int8 tree, within 5e-2 of the range; the profiler's device
   ops per step of the fused and the mega form; and the LM head's device
   time, bf16 against int8.
6. Main path: gar_1b with seeded random weights, one 17-tile image, one
   region, a 4662-token prompt and 256 greedy tokens through `generate`;
   ms per caption split into vision, prefill and decode, and the kernel
   launch counts of one caption, which must be D = E = F = G = 23 (the
   fused ViT), A = 0, B = 16, C = I = J = 16 * 255, H = 2 * 16 * 255 (the
   fused decode step). Then the int8 main path, `generate` with
   `quantize_decode_weights(params)` and `quantize_kv=True`: the same
   split, launch counts C8 = I8 = J8 = 16 * 255, H8 = 2 * 16 * 255 and no
   C, H, I, J, and the relative gap of the first decode step's logits to
   the bf16 path's (printed, not bounded). Then generate with
   GAR_DECODE_PATH=mega, bf16 and then int8 weights on a bf16 cache: the
   same split, 19 = 22 = 23 = 16 * 255 (or 20 = 21 = 22) and no kernel of
   the fused step, and the first token where the greedy output leaves the
   fused path's (printed, not bounded).

Runtime (after phase 6, before serving; `phase_runtime`): the front door,
`GARRuntime` and the host data path (image processor, prompt rasterizer,
chat template, synthetic tokenizer, builders), inputs from seeded numpy
arrays (no image files, so neither PIL nor any other image reader is needed):

R1. On the narrow gar_1b of phase 3, the kernel path against the CPU plain
   path on builder batches (one region and two regions on a 672^2 image,
   8 frames of 320 x 180 in video_mode), within 5e-2 of the logit range;
   then a checkpoint through the port's writer and reader (every leaf
   bit-equal, the same 8 greedy tokens from both trees).
R2. GAR-1B at full width through `GARRuntime.load(random_init=True)` in
   bf16, 48 greedy tokens (eot 128009): one region on a 1792^2 image (17
   tiles, a 4705-token prompt), two regions and a <Prompt0> / <Prompt1>
   question (4969 tokens), 8 frames of 1280 x 720 with masks on frames 0
   and 4 (2622 tokens, video_mode); each with its host preprocessing ms
   (builder and collate), caption ms split into prefill (`gar_prefill`
   timed alone) and decode, decode steps, text length, and its launches:
   D = E = F = G = 23, B = 16, C = I = J = 16 x steps, H = 2 x 16 x steps,
   every other kernel 0. Then the one-region case with int8_serving:
   J8 = I8 = C = 16 x steps, H8 = 2 x 16 x steps, J = I = H = 0.

Evaluation (after the runtime, before SAM; `phase_eval`), on benchmark
files written from the seed (`evaluation/synthetic.py`: PNG images of 1344
x 1008 and 1792^2, the four annotation formats), GAR-1B bf16 random init:

E1. `cli.eval.main` for garbench-vqa (9 items: the second chunk, one item,
   padded to 8), garbench-detailed, dlc, ferret and mdvp at batch 8 and 32
   tokens: items/s, host preprocessing ms an item, generate ms a batch and
   each run's launches, exactly D = E = F = G = 23 and B = 16 a batch, C =
   I = J = 16 x steps, H = 2 x 16 x steps; the VQA output through
   `score_vqa`; one batch of 8 VQA items split into prefill (timed alone)
   and decode, its tokens against the same items captioned one at a time
   (printed, not bounded).
E2. `cli.parity.main` on those weights written by `save_checkpoint` and a
   PNG demo pair, --speculative 4,4: rc 1 (the demo caption differs at
   random weights), the speculative check exact, the int8 repeat run, the
   taps finite at their shapes; launches exactly A = 23, B = 80, D-G =
   138, C = 3 x 16 x 31, I = J = 2 x 16 x 31, H = 4 x 16 x 31, J8 = I8 =
   16 x 31, H8 = 2 x 16 x 31 (`parity_launches`).
E3. One 16-token caption under `utils.profiling.trace`: the ten kernels
   with the most device time, the kernels and device time of the tower,
   the rest of the prefill and a decode step, a decode step's kernels by
   launches, B's 16 events in the prefill range and C's 16 a step in the
   decode range; `device_memory_stats()`.
E4. `cli.warmup.main` (--grids 4x4, 32 tokens): build and first-caption
   seconds; `gar_with_mask.main` on the PNG pair (PIL never imported).

SAM and speculative decoding (after the runtime, before serving;
`phase_sam_speculative`), no kernel of their own (JAX's are XLA):

S1. SAM at the CPU tests' small config (grid 16, window 14), fp32: the
   card's `encode_image` and `decode_masks` against the CPU's, within 1e-4
   of the output's range (SAM_TOL; products in fp32, no TF32).
S2. SAM ViT-H at full width, seeded fp32 weights, one 1792² image: blocks 0
   (windowed) and 7 (global) against the same block on the CPU from the
   card's input (SAM_TOL); preprocess_sam and postprocess_mask host ms,
   encoder ms, prompt encoder + mask decoder ms, peak memory; a point and a
   box prompt through `SamPredictor` give non-empty masks (areas printed);
   every launch counter stays 0.
S3. The point prompt's mask captioned through `GARServer.describe_array`
   over `GARRuntime.load(gar_1b, random_init)` (bf16, 48 tokens): SAM
   predict, host preprocessing, prefill and decode ms, the steps, and
   launches D = E = F = G = 23, B = 16, C = I = J = 16 x steps,
   H = 32 x steps.
S4. `GARRuntime.caption(speculative=(4, 4))` on the one-region case of the
   runtime phase: rounds, accepted / drafted, tokens a verify pass, ms a
   caption against generate's (in turns), the host syncs (those in
   models/speculative.py must be rounds + 1), the first verify row's logits
   within 5e-2 of the range of one XLA-form decode step from the same
   seeded cache, the first token index leaving generate's fused and XLA
   forms (printed, not bounded: bf16); launches D-G = 23, B = 16, no
   decode kernel. Then the bound: wo and w_down zeroed past the draft
   depth, the draft is the whole model (at least half the drafts kept),
   timed against generate on the same weights. Last, at the narrow config
   in fp32 (prefill on the CPU, plain decode attention: the kernels take
   bf16 only), the speculative tokens equal generate's XLA form.

Serving (its kernels in phase 2, its cross-check after phase 7, its runs
after phase 6):

2. (serving) Kernel B at two prefill-chunk shapes, right-aligned causal
   (Sq = 1024 against Sk = 3072, Sq = 566 against Sk = 4662) with its
   LSE, SDPA with the boolean mask as library; C and C8 over a window's
   dense cache at B = 8 slots (prompt_lens 4662 - 64 r, prompt_pad the
   window base 4864, write_pos base + 17) at TOL16 with the interval
   probe, and C8 also at B = 16; J, I, H (wo, w_down) and J8, I8, H8 at
   B = 8 and 16; the shapes of an admission group: B over 8 and 16 rows
   of the 4662-token prompt, causal, and D, E, F, G over 136 and 272
   tiles (8 and 16 requests of 17), held against their plain versions
   block by block (rows are independent) at TOL and sized_tol. Each with
   its time after an L2 flush, plain time, bound and library time.
3. (serving) On the narrow config with 2 kv heads and 3 slots: the
   weight-stream paged step against the plain paged step, one window step
   on the gathered pages against the paged step, `llama_prefill_chunk` in
   three chunks against one prefill (each within 5e-2 of the range); the
   bf16 engine's burst window against its gather path, tokens bit for bit;
   the host syncs of a windowed run under set_sync_debug_mode("warn"): one
   fetch a window plus its eot looks.
6. (serving) The continuous-batching engine at GAR-1B's full width on
   bench.py:run_serving's workload (17-tile requests, the 4662-token
   prompt, 256 greedy tokens, eot -1; random bf16 params, serving_weights
   for int8): serving bf16 (8 requests, 8 slots, window 256), serving int8
   16-slot (quantize_kv), serving int8 low-TTFT (window 32), staggered
   (bf16, 4 requests up front and 4 at the first fetch, prefill_chunk
   1024, window 32) and per-token steps (use_fused, 4 steps). Each run a
   warm-up and a timed run of the same requests (the same tokens): requests/s,
   tok/s, TTFT and latency p50 / p95, peak memory, the host time of a window
   outside its steps; 256 valid tokens a request, every page free at the
   end, the launches derived from the engine's schedule (D-G a tower pass,
   B a layer per admission group and per prefill chunk, the fused step a
   window step) and the schedule the workload implies.

GAR-8B (its kernels in phase 2, its paths after phase 9):

2. (8B) Kernels A, B and C at GAR-8B's head dims against their plain
   versions: A at (9, 1025, 16, 96) views of the unfused PE-G block's qkv
   buffer (192-byte head stride) with its LSE, also at S = 1024 and 777; B
   causal at the 2614-token prompt, 32 / 8 heads of 128, with its LSE; C
   over layer 7 of a (32, B, 8, 3072, 128) cache at B = 1 and 24 at TOL16
   with the interval probe and its CTAs a (kv head, row) swept 1-16; then
   H, I, J, H8, I8, J8 at GAR-8B's widths (hidden 4096, MLP 14336, q 4096,
   k and v 1024; 8 stacked layers), as at GAR-1B's (`decode_matmul_kernels`
   with those widths) but without the narrow and ragged checks; the
   backward kernels of the 8B train step (`gar8b_train_kernels`): 5 at (9,
   1025, 16, 96), v a view of the qkv buffer, also at S = 1024, and the
   backward call (17's prep, 18, 17's cast) at the 2614-token prompt, 32 /
   8 heads of 128, causal, without and with segment ids, as the GAR-1B
   rows (`backward_case`). Each with its time after an L2 flush, plain
   time, bound and library time (SDPA; SDPA with enable_gqa; SDPA with the
   boolean mask; torch.mm, cuBLAS's composites, torch._weight_int8pack_mm;
   SDPA's backward).
10. Cross-check on a narrow 8B-shaped config (`narrow_8b_config`: tower
   width 192, 2 heads of 96, depth 2; decoder hidden 512, 4 heads of 128
   over 1 kv head, 2 layers, MLP 1024; untied head, rope factor 8), as
   phase 3: bf16 weights, then int8 weights on a bf16 cache; the prefill
   must launch A = 2 and B = 2, and 4 decode steps C = J = I = 8, H = 16
   (or J8, I8, H8).
11. GAR-8B's caption at full width (`phase_gar8b`, after the GAR-1B phases
   have freed their memory): bf16 weights, then weights born int8
   (`init_gar_serving_int8`), one 9-tile image (thumbnail + 2 x 4), one
   region, the 2614-token prompt, 64 greedy tokens; ms per caption (median
   of 2) split into vision, prefill and decode, decode tok/s, the weights'
   bytes and peak memory; launches per caption A = 47, B = 32, C = J = I =
   32 * 63, H = 2 * 32 * 63 (int8: J8 = I8 = 32 * 63, H8 = 2 * 32 * 63, C
   = 32 * 63), every other kernel 0.
12. GAR-8B's train step at full width (`phase_gar8b_train`), the
   reference's single-card regime: LoRA (rank 16, alpha 32 on wq, wk, wv,
   wo) over seeded random bf16 weights, `OptimizerConfig(lora_only=True)`,
   the 8B caption's batch (9 tiles, 2614 tokens); two warm-up steps, three
   timed: losses, ms a step, tok/s, peak memory, grad_norm and the launches
   a step, exactly A = 94, 5 = 47, B = 64, 17 = 18 = 32 + 47; then
   `merge_lora` and the merged tree's prefill logits against the unmerged
   tree's within 5e-2 of their range.

Training (its kernels in phase 2, its paths after phase 6):

2. (train) Kernel A and B with their LSE outputs, B with segment ids at the
   packed shape (2 rows of 4096, 5-8 documents a row, then padding), and
   the backward kernels against their plain versions: 5 (the non-causal
   call of 17's prep, 18 and 17's cast, v a view of the tower's qkv
   buffer) at the tower's (17, 1025, 16, 64), timed whole and at S = 1024
   (the price of the one-key tail tile); the backward call (17's prep,
   18, 17's cast) at the prefill's (1, 4662, 32 / 8 heads, 64) causal, at
   the packed shape with segment ids and at (1, 16384) causal, each output
   at atol a tenth of its RMS and rtol 2^-6 (`sized_tol`) of the plain
   version with p and dS rounded to bf16 where the kernels round them (the
   gap to the unrounded one is printed), 17's delta against `bwd_delta`,
   dk and dv equal across two runs, the call's peak memory over its inputs
   (under 256 MiB at 16k: no (S, S) buffer, one fp32 dq workspace), and
   the call's time beside the backward of
   scaled_dot_product_attention at the same shape (forward + backward
   through torch.autograd.grad, minus the forward; is_causal, or at the
   packed shape the boolean causal and equal-id mask with K/V widened to
   the 32 query heads), timed only. 17's bound is its bytes, 18's its
   five products.
7. Train cross-check on the narrow gar_1b of phase 3: one loss and backward
   on the card (kernels A, 5, B, 17, 18) and on the CPU (plain path) from
   the same seeded bf16 params; the losses and every gradient leaf within
   5e-2 of that leaf's max |g|; the worst leaf's gap printed beside the
   gap with the CE head's backward in its earlier form (the logit gradient
   rounded to bf16 before the products).
8. The GAR-1B train step (bench.py:128-226): bf16 params and Adam moments,
   one 17-tile image with one region (S = 4662), remat on, a warm-up window
   of 8 steps through make_train_loop, then 8 steps with CUDA events
   between them: median ms/step, supervised tok/s, TFLOP/s from gar_flops,
   peak memory, the losses (finite, the last below the first), the time
   split of one step (vision, decoder and CE forward and backward, the
   optimizer), the CE's backward alone in both head-backward forms, and
   the launches a step: A = 46, 5 = 23, B = 32, 17 = 18 =
   16 + 23 (kernel 5 is a call of 17's prep, 18 and 17's cast), every
   other kernel 0 (A and B twice a block: non-reentrant checkpointing
   replays each block's forward in the backward). The train cross-check
   counts the same way at its depths.
9. The packed text-only step (bench.py:229-277): 2 rows x 4096 tokens of
   documents of 300-1200 tokens, every token supervised: ms/step, tok/s,
   and B = 32, 17 = 18 = 16 a step, B and 18 with segment ids.
10. Training from an annotation file (`phase_trainer`): `cli.train.main`
   at gar_1b, bf16, batch 1, accumulation 2, on 8 synthetic items of 1344
   x 1008 (base64 PNGs, RLE masks; 13 tiles, about 3.9k tokens): 4 steps,
   then a second `main` in the same work dir resumes at step 4 (its state
   held bit for bit to the one the first run saved) and runs to 6, then
   exports HF safetensors, read back through `convert_hf_state_dict` to
   the trained params. Every step launches A = 46, 5 = 23, B = 32, 17 =
   18 = 39 and no other kernel; each step's loss, host and device ms and
   host wait on the loader, each checkpoint's bytes and seconds, the
   export's seconds, peak memory, and native against numpy resize at
   1792^2. The phase checks the free disk first and removes its directory.

The line before the last is a JSON object with one entry per kernel (A, B,
C, H, I, J, H8, I8, J8 also with a "gar8b" object: their figures at
GAR-8B's shapes and their launches per 8B caption; 5, 17 and 18 with
theirs per 8B LoRA train step; B, C, C8, D-G, H-J and
H8-J8 also with a "serving" object: the serving run, its launches and
their figures at the serving shapes; B, C, D-G and H-J also with an "eval"
object: their launches over all eval batches, the number of batches and
each batch's decode steps, B and C also their figures at an eval batch's
shapes; H8, I8, J8 also with a "parity" object: their launches in
parity's int8 repeat); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-2  # atol = rtol for kernel vs plain at bf16
# Kernel 16's outputs are averages over up to 4701 columns, ~0.02 in size, so
# it is held closer: atol a tenth of that, rtol one rounding of a bf16 output.
TOL16 = dict(atol=2e-3, rtol=2.0 ** -8)
LSE_TOL = 1e-3  # atol of an fp32 LSE (rtol 1e-4), as the card tests hold it
E2E_TOL = 5e-2  # max |logit difference| / max |logit|, kernel path vs plain path
SEED = 0
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, published: 3.35 TB/s
BF16_OPS_PER_MS = 989e9  # H100 SXM, published dense bf16 tensor-core rate: 989 TFLOP/s


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves n_bytes
    (each input read once, each output written once) and does `ops` bf16
    operations: the larger of the two times, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_MS, ops / BF16_OPS_PER_MS
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2, sleep_cycles: int = 1_000_000) -> float:
    """Median of per-call device times (CUDA events) after warm-up. The L2
    cache (50 MB on an H100) is flushed before each timed call: on the main
    path every decode layer reads its own cache slab, so the kernels find
    their inputs cold, and a warm repeat would flatter them. The card then
    sleeps for ~0.5 ms, so the host has queued the call before the card
    reaches it: a call of a few microseconds would otherwise be timed at
    the host's pace of issuing it; a call that issues many ops needs a
    longer sleep (sleep_cycles) for the same reason."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def share_line(r: dict) -> str:
    """A kernel's time, its share of the bound and its factor against the
    library call, for the log."""
    lib = r.get("library_ms")
    vs = f", {r['ms'] / lib:.2f}x the library's {lib:.4f} ms" if lib else ""
    return (f"{r['ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of its bound "
            f"({r['bound_ms']:.4f} ms of {r['bound_by']}){vs}")


def sdpa(q, k, v, **kw):
    """The library's attention on (B, S, H, D) views as SDPA's (B, H, S, D)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call takes to issue fn (the card runs behind, so
    this is the enqueue cost: Python, argument checks, launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def max_err(out: torch.Tensor, ref: torch.Tensor, name: str, atol: float = TOL,
            rtol: float = TOL) -> float:
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |diff| {err:.3e} (atol {atol}, rtol {rtol})")
    return err


def sized_tol(ref: torch.Tensor) -> dict:
    """Tolerance sized to an output: atol a tenth of its RMS, rtol 2^-6
    (two bf16 ulps). Kernels B, E, 17 and 18's outputs have an RMS of
    0.03-0.5, where TOL would pass a missing key tile."""
    return dict(atol=ref.float().pow(2).mean().sqrt().item() / 10, rtol=2.0 ** -6)


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from grasp_any_region_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    t0 = time.perf_counter()
    lib, compile_s = _build.build()
    _build.library()
    log(f"[env] kernels built in {compile_s:.1f} s (compile; 0 = up to date), "
        f"ready in {time.perf_counter() - t0:.1f} s: {lib}")
    from grasp_any_region_tpu_torch.data import native

    t0 = time.perf_counter()
    native.library()
    log(f"[env] native host library (RLE codec, bicubic resize; g++) ready in "
        f"{time.perf_counter() - t0:.1f} s: {native.library_path()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_kernels():
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import vit_attention as va

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    results = {}

    # A: ViT attention, 17 tiles x 1025 tokens x 16 heads, q/k/v views of
    # the unfused block's (T, S, 3, H, 64) qkv buffer
    qkv = rnd(17, 1025, 3, 16, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    ref = va.vit_attention_plain(q.float(), k.float(), v.float())
    err = max_err(out, ref, "A", **sized_tol(ref))
    results["A"] = dict(max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention(q, k, v)),
                        plain_ms=cuda_ms(lambda: va.vit_attention_plain(q, k, v), iters=5),
                        library_ms=cuda_ms(lambda: sdpa(q, k, v)),
                        **bound(nbytes(q, k, v, out), 4 * 17 * 16 * 1025 ** 2 * 64))
    a_host_us = host_us(lambda: va.vit_attention(q, k, v))
    # S = 1025 is 8 x 128 + 1: a one-key ninth key tile (an n16 product) and
    # a one-row ninth query tile (a whole CTA, 1/9 of the grid); S = 1024
    # has neither
    even = [x[:, 1:] for x in (q, k, v)]
    ms_1024 = cuda_ms(lambda: va.vit_attention(*even))
    log(f"[kernels] A (T = 17, S = 1025, 16 heads; library: SDPA): {share_line(results['A'])}; "
        f"S = 1024 {ms_1024:.4f} ms (work (1025 / 1024)^2 = 1.002x; one key tile and one "
        f"query tile fewer)")
    del q, k, v, out, ref, qkv, even

    # B: causal prefill, 4662 tokens, 32 query heads over 8 kv heads
    q, k, v = rnd(1, 4662, 32, 64), rnd(1, 4662, 8, 64), rnd(1, 4662, 8, 64)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    err = max_err(out, ref, "B", **sized_tol(ref))
    results["B"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5),
        library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
        **bound(nbytes(q, k, v, out), 4 * 32 * 64 * 4662 * 4663 // 2))
    log(f"[kernels] B (prefill): {share_line(results['B'])}")
    log(f"[kernels] host time a call (enqueue, the card behind): A {a_host_us:.1f} us, B "
        f"{host_us(lambda: fa.flash_attention(q, k, v, causal=True)):.1f} us (each encodes "
        "three TMA maps a call)")
    del q, k, v, out, ref
    results.update(train_kernels(rnd))

    results["C"] = decode_attention_split_kernel(rnd)
    results["16"] = decode_attention_read_kernel(rnd)
    results["24"] = layer_norm_kernel(rnd)
    results["C8"] = decode_attention_q8_kernel(rnd)
    results.update(vit_block_kernels(rnd, gen))
    results.update(decode_matmul_kernels(rnd))
    results.update(mega_kernels(rnd))
    # the serving engine's shapes: B's prefill chunks and batched prefill, C
    # and C8 over a window cache, the weight stream at 8 and 16 slots, the
    # tower's kernels over an admission group's tiles
    serving = serving_attention_rows(rnd)
    serving.update(serving_stream_rows(rnd))
    serving.update(serving_tower_rows(rnd, gen))
    for key, shapes in serving.items():
        results[key]["serving"] = shapes
    # the runtime cases' shapes: B over each padded prompt, C over each cache
    for key, shapes in runtime_attention_rows(rnd).items():
        results[key]["runtime"] = shapes
    # GAR-8B's shapes: A at head dim 96, B and C at 128, the stream at its widths
    gar8b = gar8b_attention_kernels(rnd)
    gar8b.update(gar8b_train_kernels(rnd))
    gar8b.update(decode_matmul_kernels(rnd, GAR8B_WIDTHS, 8, "8B "))
    torch.cuda.empty_cache()
    for name, r in gar8b.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernels 8B] {name}: max |kernel - plain| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {lib}")
        results[name]["gar8b"] = r
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernels] {name}: max |kernel - plain| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {lib}")
    torch.cuda.empty_cache()
    return results


def sdpa_bwd_ms(q, k, v, g, **kw) -> float:
    """The library's attention backward alone: scaled_dot_product_attention
    forward + backward (torch.autograd.grad), minus its forward, on (B, S,
    H, D) views as SDPA's (B, H, S, D)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    gt = g.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    both = cuda_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), gt))
    return both - cuda_ms(fwd)


def packed_segments(rows: int, seq: int, gen) -> torch.Tensor:
    """(rows, seq) int32 segment ids: documents 1, 2, ... of 400-800 tokens
    (5-8 a row), then padding (0) to the end of the row."""
    seg = torch.zeros((rows, seq), dtype=torch.int32)
    for r in range(rows):
        off, doc = 0, 1
        while True:
            n = int(torch.randint(400, 800, (1,), generator=gen))
            if off + n > seq - 64:
                break
            seg[r, off:off + n] = doc
            off, doc = off + n, doc + 1
    return seg.cuda()


def causal_pairs(seg: torch.Tensor) -> int:
    """(query, key) pairs a causal mask with these segment ids keeps: n(n+1)/2
    for each run of equal ids (padding included)."""
    total = 0
    for row in seg.cpu():
        _, counts = torch.unique_consecutive(row, return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def train_kernels(rnd):
    """Phase 2, training: A and B with their LSE, B with segment ids at the
    packed shape, and the backward kernels 5, 17 and 18 against their plain
    versions, with their times, bounds and the library's backward time."""
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import flash_backward as fb
    from grasp_any_region_tpu_torch.ops import vit_attention as va

    results = {}
    d = 64

    # A with its LSE and kernel 5 at the tower's shape: 17 tiles x 1025, 16 heads
    t, s, h = 17, 1025, 16
    q, k, v, g = (rnd(t, s, h, d) for _ in range(4))
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = va.vit_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    err = max(max_err(out, ref, "A (with LSE)", **sized_tol(ref)),
              max_err(lse, ref_lse, "A's LSE", atol=LSE_TOL, rtol=1e-4))
    a_ms = cuda_ms(lambda: va.vit_attention(q, k, v, return_lse=True))
    log(f"[kernels] A with its LSE: {a_ms:.4f} ms, max |kernel - plain| {err:.3e} "
        "(output and LSE)")
    # kernel 5, the whole call (17's prep, 18's non-causal pass, 17's cast),
    # with v a view of a (T, S, 3, H, 64) buffer as the unfused tower passes it
    v = rnd(t, s, 3, h, d)[:, :, 2]
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    got = va.vit_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    # the plain version at bf16 inputs rounds p and dS where the kernels do
    want = va.vit_attention_bwd_plain(q, k, v, out, lse, g)
    err = max(max_err(a, w, f"5 {n}", **sized_tol(w))
              for n, a, w in zip(("dq", "dk", "dv"), got, want))
    tols = ", ".join(f"{sized_tol(w)['atol']:.2e}" for w in want)
    del want
    ms = cuda_ms(lambda: va.vit_attention_bwd(q, k, v, out, lse, g))
    results["5"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(lambda: va.vit_attention_bwd_plain(q, k, v, out, lse, g), iters=3),
        library_ms=sdpa_bwd_ms(q, k, v, g),
        **bound(nbytes(q, k, v, out, g, lse, *got), 5 * 2 * t * h * s * s * d))
    # S = 1025 is 8 x 128 + 1: 18 folds the one key past the eighth key tile
    # into that tile's CTA. The call at S = 1024 prices what the tail costs.
    even = [x[:, 1:] if x is v else x[:, 1:].contiguous() for x in (q, k, v, out, g)]
    lse_even = lse[:, :, 1:].contiguous()
    ms_even = cuda_ms(lambda: va.vit_attention_bwd(*even[:4], lse_even, even[4]))
    log(f"[kernels] 5 (17's prep, 18, 17's cast; T = {t}, S = {s}, {h} heads; library: SDPA's "
        f"backward): {share_line(results['5'])}; max |kernel - plain| {err:.3e} (atol {tols}, "
        f"rtol 2^-6; p and dS rounded to bf16 in both); at S = 1024 {ms_even:.4f} ms (work "
        f"(1025 / 1024)^2 = 1.002x; the one-key tail folded into the eighth key tile's CTA)")
    del q, k, v, g, out, lse, got, even, lse_even

    results.update(backward_case(rnd, "prefill", 1, 4662, 32, 8, time_plain=True))
    gen = torch.Generator().manual_seed(SEED)
    backward_case(rnd, "packed", 2, 4096, 32, 8, seg=packed_segments(2, 4096, gen))
    backward_case(rnd, "16k", 1, 16384, 32, 8)
    torch.cuda.empty_cache()
    return results


def backward_case(rnd, label, b, sq, h, kh, d=64, seg=None, time_plain=False):
    """B with its LSE, then 17 and 18, at one shape, head dim d; returns the
    entries (the plain backward timed where time_plain)."""
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    q, g = rnd(b, sq, h, d), rnd(b, sq, h, d)
    k, v = rnd(b, sq, kh, d), rnd(b, sq, kh, d)
    kw = dict(causal=True, segment_ids=seg)
    pairs = b * sq * (sq + 1) // 2 if seg is None else causal_pairs(seg)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if sq <= 8192:  # the plain forward holds H x S x S fp32 logits
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                                return_lse=True, **kw)
        err_b = max(max_err(out, ref, f"B {label}", **sized_tol(ref)),
                    max_err(lse, ref_lse, f"B's LSE {label}", atol=LSE_TOL, rtol=1e-4))
        del ref, ref_lse
        b_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, return_lse=True, **kw))
        lim = bound(nbytes(q, k, v, out, lse), 4 * h * d * pairs)
        if seg is None:
            lib_fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        else:  # causal and equal ids as SDPA's boolean mask, K/V widened to every head
            mask = fa.attention_mask(sq, sq, True, seg, q.device)[:, 0]
            kw_, vw_ = k.repeat_interleave(h // kh, 2), v.repeat_interleave(h // kh, 2)
            lib_fwd = cuda_ms(lambda: sdpa(q, kw_, vw_, attn_mask=mask))
            del mask, kw_, vw_
        log(f"[kernels] B with its LSE, {label}: "
            f"{share_line(dict(ms=b_ms, library_ms=lib_fwd, **lim))} (SDPA"
            f"{' with the boolean mask' if seg is not None else ''}, no LSE), "
            f"max |kernel - plain| {err_b:.3e}")
    # the whole backward call (17, 18, 17): its peak over the inputs, its outputs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dq, dk, dv = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    if label == "16k" and peak_mb >= 256:
        raise AssertionError(f"17 / 18 at 16k: peak {peak_mb:.1f} MiB over the inputs >= 256")
    again = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dk, again[1]) and torch.equal(dv, again[2])):
        raise AssertionError(f"18 {label}: dk or dv differ between two runs")
    del again
    # the plain version at bf16 inputs rounds p and dS to bf16 where the
    # kernels (and the Pallas kernels at bf16) round them; at fp32 inputs
    # it rounds nothing, for the record
    want = fb.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    err = [max_err(a, w, f"{n} {label}", **sized_tol(w))
           for n, a, w in zip(("17 dq", "18 dk", "18 dv"), (dq, dk, dv), want)]
    tols = ", ".join(f"{sized_tol(w)['atol']:.2e}" for w in want)
    del want
    args = (q.float(), k.float(), v.float(), out.float(), lse, g.float())
    unrounded = max((a.float() - w).abs().max().item() for a, w in
                    zip((dq, dk, dv), fb.flash_attention_bwd_plain(*args, **kw)))
    del args
    delta, dq_acc = fb.bwd_prep(out, g)
    err_delta = max_err(delta, fb.bwd_delta(out, g), f"17's delta {label}", atol=1e-4,
                        rtol=1e-4)
    scale = d ** -0.5
    prep_ms = cuda_ms(lambda: fb.bwd_prep(out, g))
    cast_ms = cuda_ms(lambda: fb.bwd_dq_cast(dq_acc))
    dkv_ms = cuda_ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, g, lse, delta, dq_acc, **kw))
    call_ms = cuda_ms(lambda: fb.flash_attention_bwd(q, k, v, out, lse, g, **kw))
    if seg is None:
        lib = sdpa_bwd_ms(q, k, v, g, is_causal=True, enable_gqa=True)
    else:  # causal and equal ids as SDPA's boolean mask, K/V widened to every query head
        mask = fa.attention_mask(sq, sq, True, seg, q.device)[:, 0]
        lib = sdpa_bwd_ms(q, k.repeat_interleave(h // kh, 2), v.repeat_interleave(h // kh, 2),
                          g, attn_mask=mask)
        del mask
    # 17's function reads out and g and writes delta and dq; the fp32
    # workspace it zeroes and reads back is the price of 18's atomic dq,
    # so its bound leaves that out; 18's counts the workspace once, as
    # its output. No one PyTorch call computes prep and cast: SDPA's
    # backward stands on 18's row and beside the whole call.
    ops = 5 * 2 * h * d * pairs
    entries = {
        "17": dict(max_abs_err=max(err[0], err_delta), ms=prep_ms + cast_ms,
                   plain_ms=cuda_ms(lambda: fb.bwd_delta(out, g))
                   + cuda_ms(lambda: (dq_acc * scale).to(q.dtype)),
                   library_ms=None, **bound(nbytes(out, g, delta, dq), 0)),
        "18": dict(max_abs_err=max(err[1:]), ms=dkv_ms, library_ms=lib,
                   plain_ms=cuda_ms(lambda: fb.flash_attention_bwd_plain(
                       q, k, v, out, lse, g, **kw), iters=3) if time_plain else None,
                   **bound(nbytes(q, k, v, g, lse, delta, dk, dv, dq_acc), ops))}
    call_bound = bound(nbytes(q, k, v, out, g, lse, dq, dk, dv), ops)["bound_ms"]
    log(f"[kernels] 17 / 18, {label} (B = {b}, S = {sq}, {h} / {kh} heads, {pairs} causal "
        f"pairs): 17 {prep_ms:.4f} + {cast_ms:.4f} ms (prep + cast), 18 {dkv_ms:.4f} ms; the "
        f"backward call {call_ms:.4f} ms against SDPA's backward {lib:.4f} ms "
        f"({call_ms / lib:.2f}x; bound of the call {call_bound:.4f} ms, 17 "
        f"{entries['17']['bound_ms']:.4f} ms of bytes, 18 "
        f"{entries['18']['bound_ms']:.4f} ms of operations); peak memory of the backward call "
        f"{peak_mb:.1f} MiB over its inputs; max |kernel - plain| dq {err[0]:.3e}, dk "
        f"{err[1]:.3e}, dv {err[2]:.3e} (atol {tols}, rtol 2^-6; p and dS rounded to bf16 "
        f"in both; {unrounded:.3e} against the unrounded plain version), delta "
        f"{err_delta:.3e}; dk, dv equal across two runs")
    return entries


def decode_work(q, k_all, plens, pad, wpos):
    """Kernel C's (C8's, 22's attention) work at one layer, (bytes,
    operations): the valid K and V columns of each row read, the new column
    written, q read and the output written; 4 operations per query head,
    column and dim (QK and PV)."""
    _, _, kh, _, d = k_all.shape
    cols = sum(min(p, pad, wpos) + max(wpos - pad, 0) + 1 for p in plens)
    return 2 * cols * kh * d * k_all.element_size() + 2 * nbytes(q), 4 * q.shape[1] * d * cols


def decode_bound(q, k_all, plens, pad, wpos):
    return bound(*decode_work(q, k_all, plens, pad, wpos))


# Kernel 16's B = 24 prompt lengths: write_pos + 1, write_pos, past and at
# prompt_pad and one short of it, the edges of 512-column blocks, down to 1.
PLENS_24 = [4701, 4700, 4690, 4663, 4662, 4661, 4609, 4608, 4607, 4097, 4096, 4095,
            4000, 3500, 3000, 2048, 1025, 1024, 513, 512, 511, 100, 2, 1]


def interval_probe(v, plens, pad, wpos):
    """A one-layer (B, K, S, D) cache on which kernel 16's answer is the
    mean of v over each row's valid columns: k = 0 gives every column the
    same weight, and v holds a distinct spike on each side of each interval
    edge (prompt_len - 1, prompt_len, prompt_pad - 1, prompt_pad,
    write_pos, write_pos + 1), the i-th of a row 0.02 i times its count of
    valid columns. One column too many or too few, or one counted twice,
    moves that row's outputs by 0.02 or more."""
    v = v.clone()
    for row, plen in enumerate(plens):
        n = plen + max(0, wpos + 1 - max(pad, plen))
        edges = sorted({plen - 1, plen, pad - 1, pad, wpos, wpos + 1} & set(range(v.shape[2])))
        for i, col in enumerate(edges):
            v[row, :, col] = 0.02 * (i + 1) * n
    return torch.zeros_like(v), v


def c_row(rnd, plens, pad, wpos, s, layer: int = 7):
    """Kernel C over layer `layer` of a (16, B, 8, s, 64) cache, B =
    len(plens): the output against the plain version at TOL16, column
    write_pos holding the new K/V and the rest of the cache bit-identical,
    then the interval probe at TOL16; times: kernel, plain, bound (the
    valid columns' bytes) and the library call, SDPA over the layer slab
    with enable_gqa and the two-interval boolean mask (timed only; its gap
    to the kernel returned). Returns (figures, library gap, the kernel's
    arguments and keywords)."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import decode_attention as dec

    b = len(plens)
    wp = torch.tensor(wpos, dtype=torch.int32, device="cuda")
    plens_t = torch.tensor(plens, dtype=torch.int32, device="cuda")
    kw = dict(prompt_lens=plens_t, write_pos=wp, prompt_pad=pad)
    k_all, v_all = rnd(16, b, 8, s, 64), rnd(16, b, 8, s, 64)
    q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
    err = 0.0
    for probe in (False, True):
        if probe:  # one column too many, too few or twice moves a row by >= 0.02
            k0, vp = interval_probe(v_all[layer], plens, pad, wpos)
            k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
            del k0, vp
        k_ref, v_ref = k_all[layer].clone(), v_all[layer].clone()
        out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
        torch.cuda.synchronize()
        ref = dec.decode_attention_fused_plain(
            q.float(), k_ref[None].float(), v_ref[None].float(), k_new.float(),
            v_new.float(), 0, **kw)
        label = f"C (B = {b}, S = {s}, prompt_pad {pad}, write_pos {wpos}" \
                f"{', interval probe' if probe else ''})"
        err = max(err, max_err(out, ref, label, **TOL16))
        if not (torch.equal(k_all[layer, :, :, wpos], k_new)
                and torch.equal(v_all[layer, :, :, wpos], v_new)):
            raise AssertionError(f"{label}: column write_pos does not hold the new K/V")
        k_ref[:, :, wpos], v_ref[:, :, wpos] = k_new, v_new
        if not (torch.equal(k_all[layer], k_ref) and torch.equal(v_all[layer], v_ref)):
            raise AssertionError(f"{label}: the kernel changed cache entries other than "
                                 "column write_pos")
        del k_ref, v_ref, ref
    # library: SDPA with the two-interval boolean mask over the layer slab
    # (which holds the new column), as kernel 16's row times it
    ids = torch.arange(s, device="cuda")
    mask = ((ids < plens_t[:, None]) | ((ids >= pad) & (ids <= wpos)))[:, None, None, :]
    k_lay, v_lay, q4 = k_all[layer], v_all[layer], q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, k_lay, v_lay, attn_mask=mask,
                                              scale=64 ** -0.5, enable_gqa=True)

    lib_gap = (library()[:, :, 0].float() - out.float()).abs().max().item()
    args = (q, k_all, v_all, k_new, v_new, layer)
    r = dict(max_abs_err=err,
             ms=cuda_ms(lambda: dec.decode_attention_fused(*args, **kw)),
             plain_ms=cuda_ms(lambda: dec.decode_attention_fused_plain(*args, **kw), iters=5),
             library_ms=cuda_ms(library), **decode_bound(q, k_all, plens, pad, wpos))
    return r, lib_gap, args, kw


def decode_attention_split_kernel(rnd):
    """Kernel C (split-KV over a cluster of CTAs) over layer 7 of a (16, B,
    8, 5120, 64) cache, prompt_pad 4662, write_pos 4700, through `c_row`: at
    B = 2 (prompt lengths 4662 and 4000; the kernels line), B = 1 and B = 24
    (prompt lengths from 1 to prompt_pad, PLENS_24 cut at it), with the
    CTAs a (kv head, row) (`splits`, the cluster size) swept."""
    from grasp_any_region_tpu_torch.ops import decode_attention as dec

    layer, pad, wpos, s = 7, 4662, 4700, 5120
    line = None
    for b in (2, 1, 24):
        plens = {2: [4662, 4000], 1: [4662]}.get(b) or [min(x, pad) for x in PLENS_24]
        r, lib_gap, args, kw = c_row(rnd, plens, pad, wpos, s, layer)
        splits = dec.card_splits(b, 8, args[0].device)
        log(f"[kernels] C (B = {b}, layer {layer}, {splits} CTAs a (kv head, row) in a "
            f"cluster of {splits}, {b * 8} clusters; library: SDPA, boolean mask, enable_gqa, "
            f"max |library - kernel| {lib_gap:.3e}): {share_line(r)}; plain "
            f"{r['plain_ms']:.4f} ms; max |kernel - plain| {r['max_abs_err']:.3e} (TOL16)")
        chooser, sweep = dec.card_splits, {}
        try:  # the chooser's alternatives: the kernel takes 1-16 CTAs
            for n in (1, 2, 4, 8, 16):
                dec.card_splits = lambda *_: n
                sweep[n] = cuda_ms(lambda: dec.decode_attention_fused(*args, **kw))
        finally:
            dec.card_splits = chooser
        log(f"[kernels] C (B = {b}) by CTAs a (kv head, row), ms: "
            + ", ".join(f"{n}: {ms:.4f}" for n, ms in sweep.items()))
        line = line or r
        del args, kw
    torch.cuda.empty_cache()
    return line


def decode_attention_read_kernel(rnd):
    """Kernel 16 over the main path's seeded (16, B, 8, 5120, 64) bf16 cache,
    prompt_pad 4662, write_pos 4700 (the current token already in the
    cache): at B = 24 (prompt lengths from 1 to write_pos + 1, at and on
    both sides of prompt_pad, write_pos and block edges) at layers 0, 7 and
    15, then at B = 2 (prompt lengths 4662 and 4000, the kernels line) at
    all 16 layers, each layer a device int32 scalar, each against the
    plain version at TOL16, and the cache unchanged; then at both B the
    interval probe, at TOL16, and at B = 2 once more with block_s 128 and a
    prompt of 5000 (past the last block the TPU kernel visits). Times at layer 7: kernel (C's split-KV body
    read only, `card_splits` CTAs a (kv head, row); also at 1-16), plain,
    bound (C's bytes: the valid columns, q and the output), and the library
    call, SDPA over the layer slab with enable_gqa and the two-interval
    boolean mask (timed only; its gap to the plain version printed)."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import decode_attention as dec

    pad, wpos, s = 4662, 4700, 5120
    err = 0.0
    for b in (24, 2):
        k_all, v_all = rnd(16, b, 8, s, 64), rnd(16, b, 8, s, 64)
        q = rnd(b, 32, 64)
        plens = [4662, 4000] if b == 2 else PLENS_24
        plens_t = torch.tensor(plens, dtype=torch.int32, device="cuda")
        kw = dict(prompt_lens=plens_t, write_pos=torch.tensor(wpos, dtype=torch.int32,
                                                              device="cuda"), prompt_pad=pad)
        k_ref, v_ref = k_all.clone(), v_all.clone()
        zero = torch.zeros((), dtype=torch.int32, device="cuda")
        for layer in (range(16) if b == 2 else (0, 7, 15)):
            lay = torch.tensor(layer, dtype=torch.int32, device="cuda")
            out = dec.decode_attention_stacked(q, k_all, v_all, lay, **kw)
            torch.cuda.synchronize()
            ref = dec.decode_attention_plain(q.float(), k_all[layer:layer + 1].float(),
                                             v_all[layer:layer + 1].float(), zero, **kw)
            err = max(err, max_err(out, ref, f"16 (B = {b}, layer {layer})", **TOL16))
        if not (torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)):
            raise AssertionError(f"16 (B = {b}): the read-only kernel changed the cache")
        del k_ref, v_ref
        k0, vp = interval_probe(v_all[0], plens, pad, wpos)
        out = dec.decode_attention(q, k0, vp, **kw)
        torch.cuda.synchronize()
        ref = dec.decode_attention_plain(q.float(), k0[None].float(), vp[None].float(), zero, **kw)
        err = max(err, max_err(out, ref, f"16 (B = {b}) interval probe", **TOL16))
        if b == 2:  # block_s 128: row 0's prompt runs past the last block visited (4736)
            clip = dict(kw, prompt_lens=torch.tensor([5000, 4000], dtype=torch.int32,
                                                     device="cuda"), block_s=128)
            k0, vp = interval_probe(v_all[0], [5000, 4000], pad, wpos)
            out = dec.decode_attention(q, k0, vp, **clip)
            torch.cuda.synchronize()
            ref = dec.decode_attention_plain(q.float(), k0[None].float(), vp[None].float(), zero,
                                             **clip)
            err = max(err, max_err(out, ref, "16 (B = 2, block_s 128, a prompt past the last "
                                   "block visited) interval probe", **TOL16))
        del k0, vp
        lay = torch.tensor(7, dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: dec.decode_attention_stacked(q, k_all, v_all, lay, **kw))
        plain_ms = cuda_ms(lambda: dec.decode_attention_plain(q, k_all, v_all, lay, **kw),
                           iters=5)
        lim = decode_bound(q, k_all, plens, pad, wpos)
        ids = torch.arange(s, device="cuda")
        mask = ((ids < plens_t[:, None]) | ((ids >= pad) & (ids <= wpos)))[:, None, None, :]
        k7, v7, q4 = k_all[7], v_all[7], q[:, :, None, :]  # SDPA's (B, heads, S, D)

        def library():
            return F.scaled_dot_product_attention(q4, k7, v7, attn_mask=mask, scale=64 ** -0.5,
                                                  enable_gqa=True)

        lib_gap = (library()[:, :, 0].float() - dec.decode_attention_plain(
            q.float(), k_all[7:8].float(), v_all[7:8].float(), zero, **kw)).abs().max().item()
        lib_ms = cuda_ms(library)
        chooser, sweep = dec.card_splits, {}
        try:  # the chooser's alternatives: the kernel takes 1-16 CTAs
            for n in (1, 2, 4, 8, 16):
                dec.card_splits = lambda *_: n
                sweep[n] = cuda_ms(lambda: dec.decode_attention_stacked(q, k_all, v_all, lay, **kw))
        finally:
            dec.card_splits = chooser
        log(f"[kernels] 16, B = {b} ({dec.card_splits(b, 8, q.device)} CTAs a (kv head, row) "
            f"in a cluster): {ms:.4f} ms (bound {lim['bound_ms']:.4f} ms of "
            f"{lim['bound_by']}); plain {plain_ms:.4f} ms; library (SDPA, boolean mask, "
            f"enable_gqa) {lib_ms:.4f} ms, max |library - plain| {lib_gap:.3e}; "
            f"max |kernel - plain| over the layers {err:.3e}; by CTAs a (kv head, row), ms: "
            + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
        del k_all, v_all, k7, v7
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **lim)


GAR8B_PROMPT = 2614  # synthetic_batch(gar_8b(), grid=(2, 4), regions=1)'s prompt
GAR8B_COLUMNS = 3072  # generate's cache for it and 64 new tokens (a multiple of 512)


def gar8b_attention_kernels(rnd):
    """Kernels A, B and C at GAR-8B's head dims, each against its plain
    version: A at (9, 1025, 16, 96) views of the unfused PE-G block's (T, S,
    3, H, 96) qkv buffer (and at S = 1024 and a ragged S = 777), with its
    LSE; B causal at the 2614-token prompt, 32 / 8 heads of 128, with its
    LSE; C over layer 7 of a (32, B, 8, 3072, 128) cache at B = 1 and 24,
    prompt_pad 2614, write_pos 2650 (B = 24: prompt lengths from 1 to 2614),
    at TOL16 with the interval probe, its CTAs a (kv head, row) swept 1-16.
    Times after an L2 flush, the plain version's, the bound, and the
    library's: SDPA (enable_gqa for B; with the two-interval boolean mask
    for C). Returns each kernel's 8B entry (C's at B = 1)."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import decode_attention as dec
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import vit_attention as va

    out8 = {}
    t, s, h, d = 9, 1025, 16, 96
    qkv = rnd(t, s, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = va.vit_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    err = max(max_err(out, ref, "A (head dim 96)", **sized_tol(ref)),
              max_err(lse, ref_lse, "A's LSE (head dim 96)", atol=LSE_TOL, rtol=1e-4))
    out8["A"] = dict(max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention(q, k, v)),
                     plain_ms=cuda_ms(lambda: va.vit_attention_plain(q, k, v), iters=5),
                     library_ms=cuda_ms(lambda: sdpa(q, k, v)),
                     **bound(nbytes(q, k, v, out), 4 * t * h * s ** 2 * d))
    others = {}
    for s2 in (1024, 777):
        q2, k2, v2 = (x[:, s - s2:] for x in (q, k, v))
        ref2 = va.vit_attention_plain(q2.float(), k2.float(), v2.float())
        max_err(va.vit_attention(q2, k2, v2), ref2, f"A (head dim 96, S = {s2})",
                **sized_tol(ref2))
        others[s2] = (cuda_ms(lambda: va.vit_attention(q2, k2, v2)),
                      cuda_ms(lambda: sdpa(q2, k2, v2)))
    log(f"[kernels 8B] A (T = {t}, S = {s}, {h} heads of {d}, views of the qkv buffer; library: "
        f"SDPA): {share_line(out8['A'])}; plain {out8['A']['plain_ms']:.4f} ms; max |kernel - "
        f"plain| {err:.3e} (output and LSE); "
        + "; ".join(f"S = {n} {a:.4f} ms (SDPA {b:.4f})" for n, (a, b) in others.items())
        + "; PV at n128 over V's 96 columns and 32 zero-filled: 4/3 of PV's products")
    del q, k, v, qkv, out, lse, ref, ref_lse

    sq, h, kh, d = GAR8B_PROMPT, 32, 8, 128
    q, k, v = rnd(1, sq, h, d), rnd(1, sq, kh, d), rnd(1, sq, kh, d)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                            return_lse=True)
    err = max(max_err(out, ref, "B (head dim 128)", **sized_tol(ref)),
              max_err(lse, ref_lse, "B's LSE (head dim 128)", atol=LSE_TOL, rtol=1e-4))
    out8["B"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5),
        library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
        **bound(nbytes(q, k, v, out), 4 * h * d * sq * (sq + 1) // 2))
    log(f"[kernels 8B] B (causal prefill, S = {sq}, {h} / {kh} heads of {d}; library: SDPA, "
        f"enable_gqa): {share_line(out8['B'])}; plain {out8['B']['plain_ms']:.4f} ms; max "
        f"|kernel - plain| {err:.3e} (output and LSE)")
    del q, k, v, out, lse, ref, ref_lse

    layer, pad, wpos, s = 7, GAR8B_PROMPT, 2650, GAR8B_COLUMNS
    wp = torch.tensor(wpos, dtype=torch.int32, device="cuda")
    for b in (1, 24):
        plens = [pad] if b == 1 else [max(1, pad - 113 * i) for i in range(b)]
        plens_t = torch.tensor(plens, dtype=torch.int32, device="cuda")
        kw = dict(prompt_lens=plens_t, write_pos=wp, prompt_pad=pad)
        k_all, v_all = rnd(32, b, kh, s, d), rnd(32, b, kh, s, d)
        q, k_new, v_new = rnd(b, h, d), rnd(b, kh, d), rnd(b, kh, d)
        err = 0.0
        for probe in (False, True):
            if probe:  # one column too many, too few or twice moves a row by >= 0.02
                k0, vp = interval_probe(v_all[layer], plens, pad, wpos)
                k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
                del k0, vp
            k_ref, v_ref = k_all[layer].clone(), v_all[layer].clone()
            out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
            torch.cuda.synchronize()
            ref = dec.decode_attention_fused_plain(
                q.float(), k_ref[None].float(), v_ref[None].float(), k_new.float(),
                v_new.float(), 0, **kw)
            label = f"C (head dim 128, B = {b}{', interval probe' if probe else ''})"
            err = max(err, max_err(out, ref, label, **TOL16))
            k_ref[:, :, wpos], v_ref[:, :, wpos] = k_new, v_new
            if not (torch.equal(k_all[layer], k_ref) and torch.equal(v_all[layer], v_ref)):
                raise AssertionError(f"{label}: the cache is not the old one with column "
                                     "write_pos holding the new K/V")
            del k_ref, v_ref, ref
        ids = torch.arange(s, device="cuda")
        mask = ((ids < plens_t[:, None]) | ((ids >= pad) & (ids <= wpos)))[:, None, None, :]
        k_lay, v_lay, q4 = k_all[layer], v_all[layer], q[:, :, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, k_lay, v_lay, attn_mask=mask,
                                                  scale=d ** -0.5, enable_gqa=True)

        r = dict(max_abs_err=err,
                 ms=cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, k_new, v_new,
                                                                layer, **kw)),
                 plain_ms=cuda_ms(lambda: dec.decode_attention_fused_plain(
                     q, k_all, v_all, k_new, v_new, layer, **kw), iters=5),
                 library_ms=cuda_ms(library), **decode_bound(q, k_all, plens, pad, wpos))
        chooser, sweep = dec.card_splits, {}
        try:  # the chooser's alternatives: the kernel takes 1-16 CTAs
            for n in (1, 2, 4, 8, 16):
                dec.card_splits = lambda *_: n
                sweep[n] = cuda_ms(lambda: dec.decode_attention_fused(
                    q, k_all, v_all, k_new, v_new, layer, **kw))
        finally:
            dec.card_splits = chooser
        log(f"[kernels 8B] C (head dim 128, B = {b}, layer {layer} of a {tuple(k_all.shape)} "
            f"cache, {dec.card_splits(b, kh, q.device)} CTAs a (kv head, row); library: SDPA, "
            f"boolean mask, enable_gqa): {share_line(r)}; plain {r['plain_ms']:.4f} ms; max "
            f"|kernel - plain| {err:.3e} (TOL16); by CTAs a (kv head, row), ms: "
            + ", ".join(f"{n}: {ms:.4f}" for n, ms in sweep.items()))
        out8.setdefault("C", r)
        del k_all, v_all, k_lay, v_lay, mask, out
    torch.cuda.empty_cache()
    return out8


def gar8b_train_kernels(rnd):
    """Kernels 5, 17 and 18 at GAR-8B's head dims against their plain
    versions (p and dS rounded to bf16 where the kernels round them), at
    `sized_tol`: 5 (17's prep, 18's wide pass, 17's cast) at (9, 1025, 16,
    96), v a view of the PE-G block's (T, S, 3, H, 96) qkv buffer, also
    timed at S = 1024 (the price of the one-key tile's own CTA); the
    backward call at the 2614-token prompt, 32 / 8 heads of 128, causal,
    without segment ids (the train step's right-padded rows: its figures
    fill the 8B rows of 17 and 18) and with two documents and padding
    (`backward_case`). SDPA's backward at the same shape is the library
    time. Returns the 8B entries of 5, 17 and 18."""
    from grasp_any_region_tpu_torch.ops import vit_attention as va

    out8 = {}
    t, s, h, d = 9, 1025, 16, 96
    q, k, g = (rnd(t, s, h, d) for _ in range(3))
    v = rnd(t, s, 3, h, d)[:, :, 2]
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    got = va.vit_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    want = va.vit_attention_bwd_plain(q, k, v, out, lse, g)
    err = max(max_err(a, w, f"5 {n} (head dim 96)", **sized_tol(w))
              for n, a, w in zip(("dq", "dk", "dv"), got, want))
    tols = ", ".join(f"{sized_tol(w)['atol']:.2e}" for w in want)
    del want
    out8["5"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention_bwd(q, k, v, out, lse, g)),
        plain_ms=cuda_ms(lambda: va.vit_attention_bwd_plain(q, k, v, out, lse, g), iters=3),
        library_ms=sdpa_bwd_ms(q, k, v, g),
        **bound(nbytes(q, k, v, out, g, lse, *got), 5 * 2 * t * h * s * s * d))
    even = [x[:, 1:] if x is v else x[:, 1:].contiguous() for x in (q, k, v, out, g)]
    lse_even = lse[:, :, 1:].contiguous()
    ms_even = cuda_ms(lambda: va.vit_attention_bwd(*even[:4], lse_even, even[4]))
    log(f"[kernels 8B] 5 (17's prep, 18's wide pass, 17's cast; T = {t}, S = {s}, {h} heads of "
        f"{d}, v a view of the qkv buffer; library: SDPA's backward): {share_line(out8['5'])}; "
        f"plain {out8['5']['plain_ms']:.4f} ms; max |kernel - plain| {err:.3e} (atol {tols}, "
        f"rtol 2^-6); at S = 1024 {ms_even:.4f} ms (work (1025 / 1024)^2 = 1.002x; at 96 the "
        f"one key past the eighth key tile takes a ninth tile's CTAs, 1/8 more)")
    del q, k, v, g, out, lse, got, even, lse_even
    entries = backward_case(rnd, "8B prefill", 1, GAR8B_PROMPT, 32, 8, d=128, time_plain=True)
    for key in ("17", "18"):
        out8[key] = entries[key]
    seg = torch.zeros((1, GAR8B_PROMPT), dtype=torch.int32)
    seg[0, :1900], seg[0, 1900:2500] = 1, 2  # two documents, then padding
    backward_case(rnd, "8B prefill, segment ids", 1, GAR8B_PROMPT, 32, 8, d=128,
                  seg=seg.to("cuda"))
    torch.cuda.empty_cache()
    return out8


def layer_norm_kernel(rnd):
    """Kernel 24 at a ragged (3, 37, 1024) bf16, then at the tower's (17,
    1025, 1024) in fp32 and in bf16 (the kernels line), weights and bias in
    x's dtype, each against its plain version at TOL; times: kernel, plain
    (= `ops.norms.layer_norm`, the tower's form today), F.layer_norm as the
    library call, and the bound from bytes (x read and the output written
    once; ~8 fp32 operations an element take a tenth of that time). Then
    `layer_norm_fused_df` at the tower's bf16 shape, forward and backward,
    against autograd through the plain `layer_norm`: the output within TOL,
    every gradient within TOL of its range."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import norms

    d = 1024
    for shape, dtype in (((3, 37, d), torch.bfloat16), ((17, 1025, d), torch.float32),
                         ((17, 1025, d), torch.bfloat16)):
        x = (rnd(*shape).float() * 3 + 1).to(dtype)
        w, b = (1 + 0.3 * rnd(d).float()).to(dtype), (0.2 * rnd(d).float()).to(dtype)
        out = norms.layer_norm_fused(x, w, b)
        torch.cuda.synchronize()
        label = f"24 {tuple(shape)} {str(dtype)[6:]}"
        err = max_err(out, norms.layer_norm_fused_plain(x.float(), w.float(), b.float()), label)
        ms = cuda_ms(lambda: norms.layer_norm_fused(x, w, b))
        plain_ms = cuda_ms(lambda: norms.layer_norm_fused_plain(x, w, b))
        lib_ms = cuda_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6))
        lim = bound(nbytes(x, w, b, out), 0)
        log(f"[kernels] {label}: {ms:.4f} ms = {nbytes(x, out) / ms / 1e6:.0f} GB/s (bound "
            f"{lim['bound_ms']:.4f} ms of {lim['bound_by']}); plain = ops.norms.layer_norm "
            f"(the tower's form) {plain_ms:.4f} ms; library F.layer_norm {lib_ms:.4f} ms; "
            f"max |kernel - plain| {err:.3e}")
    g = rnd(*x.shape)
    leaves, refs = ([t.clone().requires_grad_() for t in (x, w, b)] for _ in range(2))
    got, want = norms.layer_norm_fused_df(*leaves), norms.layer_norm(*refs)
    got.backward(g)
    want.backward(g)
    df_err = max_err(got, want, "24 layer_norm_fused_df forward")
    gaps = [((a.grad.float() - r.grad.float()).abs().max() / r.grad.float().abs().max()).item()
            for a, r in zip(leaves, refs)]
    if max(gaps) > TOL:
        raise AssertionError(f"24 layer_norm_fused_df: gradient gaps {gaps} > {TOL} of the "
                             "range")
    log(f"[kernels] 24 layer_norm_fused_df: forward max |kernel - plain| {df_err:.3e}; "
        f"gradient gaps (x, weight, bias) {', '.join(f'{x:.3e}' for x in gaps)} of the range")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **lim)


def q8_probe(kind, k_all, v_all, k_scale, v_scale, q, k_new, v_new, layer, plens, pad, wpos):
    """C8's probes, written into `layer` of the int8 cache and its scales in
    place; returns the (k_new, v_new) to append. "interval": k = 0 and v
    int8 spikes on each side of each interval edge, the i-th 16 i steps of a
    scale of the row's count of valid columns / 800, so each spike is 0.02 i
    times that count (as `interval_probe`): one column too many, too few or
    twice moves a row by 0.02 or more. "current": k and v = 0 in the slab,
    and the first query head of each kv head carrying about half its weight
    on the current token (q . k_new scaled to log of the count), k_new and
    v_new quantized at a coarse scale of 0.5, so folding in the bf16 k_new
    or v_new instead of their dequantized values moves those rows by a few
    hundredths."""
    b, kh = k_new.shape[:2]
    counts = [p + max(0, wpos + 1 - max(pad, p)) for p in plens]
    k_all[layer].zero_()
    if kind == "interval":
        gen = torch.Generator(device="cuda").manual_seed(SEED + len(plens))
        v_all[layer] = torch.randint(-16, 17, v_all[layer].shape, generator=gen, device="cuda",
                                     dtype=torch.int8)
        for row, (plen, n) in enumerate(zip(plens, counts)):
            edges = sorted({plen - 1, plen, pad - 1, pad, wpos, wpos + 1}
                           & set(range(v_all.shape[3])))
            for i, col in enumerate(edges):
                v_all[layer, row, :, col] = 16 * (i + 1)
            v_scale[layer, row] = n / 800
        return torch.zeros_like(k_new), v_new
    v_all[layer].zero_()
    k_scale[layer], v_scale[layer] = 0.5, 0.5
    q0 = q.float().reshape(b, kh, -1, 64)[:, :, 0]
    n = torch.tensor(counts, device=q.device, dtype=torch.float32)[:, None, None]
    k_new = (q0 * 8 * n.log() / q0.pow(2).sum(-1, keepdim=True)).to(torch.bfloat16)
    return k_new, (v_new.float() * 2).to(torch.bfloat16)


def widened(x, scale):
    """An int8 (L, B, K, ...) tensor at its (L, B, K / 2, 1, 1) pair scales,
    as bf16 (C8's widening)."""
    sc = scale.repeat_interleave(2, dim=2)
    return (x.float() * sc.reshape(*sc.shape[:3], *[1] * (x.dim() - 3))).to(torch.bfloat16)


def c8_is_c_on_the_widened_cache(dec, q, k_all, v_all, layer, kw, label):
    """With power-of-two pair scales every dequantized value is exact in
    bf16, so C8 must give kernel C's bits (at C8's splits) on the widened
    cache with the new K/V as C8 quantizes them. Sets the scales in kw."""
    k_scale, v_scale = kw["k_scale"], kw["v_scale"]
    exps = torch.arange(k_scale.numel(), device="cuda").reshape(k_scale.shape) % 3
    k_scale.copy_(2.0 ** -(5 + exps).float())
    v_scale.copy_(2.0 ** -(6 + exps).float())
    b, kh = k_all.shape[1:3]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for x in (k_all, v_all):  # the layer afresh (the probes zeroed it)
        x[layer] = torch.randint(-127, 128, x[layer].shape, generator=gen, device="cuda",
                                 dtype=torch.int8)
    k_new, v_new = (torch.randn((b, kh, 64), generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    news = []
    for x, sc in ((k_new, k_scale), (v_new, v_scale)):
        step = sc[layer].repeat_interleave(2, dim=1)[..., 0]  # (B, K, 1)
        news.append((torch.clamp(torch.round(x.float() / step), -127, 127) * step)
                    .to(torch.bfloat16))
    k16, v16 = widened(k_all, k_scale), widened(v_all, v_scale)
    out8 = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    splits, chooser = dec.card_splits(b, kh, q.device, dec.MAX_SPLITS_Q8), dec.card_splits
    try:
        dec.card_splits = lambda *_: splits
        out16 = dec.decode_attention_fused(q, k16, v16, *news, layer,
                                           **{k: v for k, v in kw.items() if "scale" not in k})
    finally:
        dec.card_splits = chooser
    torch.cuda.synchronize()
    if not (torch.equal(out8, out16) and torch.equal(widened(k_all, k_scale), k16)
            and torch.equal(widened(v_all, v_scale), v16)):
        raise AssertionError(f"{label}: not kernel C's bits on the widened cache (max |diff| "
                             f"{(out8.float() - out16.float()).abs().max().item():.3e})")


def decode_attention_q8_kernel(rnd):
    """Kernel C8 (C's split-KV body on the int8 cache) over layer 7 of the
    main path's int8 cache, (16, B, 8, 5120, 64) with the 4662-token
    prompt, mid-decode: at B = 24 (ragged prompt lengths, so the (layer,
    row, pair) scale indexing is exercised) and at B = 1, which the
    kernels line carries. The scales make the dequantized cache unit-size,
    as the main path's quantized K/V and C's bf16 cache are. At each B:
    the output against the plain version at TOL16, the written column
    within one quantization step of the plain version's and the rest of
    the cache unchanged; times of kernel, plain and bound, beside kernel C
    on a bf16 cache of the same shape, and by CTAs a (kv head, row) (1-16);
    then the interval probe and the current-token probe (`q8_probe`), each
    held the same way; then, with power-of-two scales, C8 against kernel C
    on the widened cache, bit for bit (`c8_is_c_on_the_widened_cache`)."""
    from grasp_any_region_tpu_torch.ops import decode_attention as dec

    layer, pad, wpos = 7, 4662, 4662 + 128
    wp = torch.tensor(wpos, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for b in (24, 1):
        k_all, v_all = (torch.randint(-127, 128, (16, b, 8, 5120, 64), generator=gen,
                                      device="cuda", dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((16, b, 4, 1, 1), generator=gen, device="cuda") + 0.5)
                            / 73.3 for _ in range(2))
        plens = [pad] + torch.randint(3000, pad + 1, (b - 1,), generator=gen,
                                      device="cuda").tolist()
        q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
        kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
                  write_pos=wp, prompt_pad=pad, k_scale=k_scale, v_scale=v_scale)
        err = 0.0
        for probe in (None, "interval", "current"):
            if probe:
                k_new, v_new = q8_probe(probe, k_all, v_all, k_scale, v_scale, q, k_new, v_new,
                                        layer, plens, pad, wpos)
            label = f"C8 (B = {b}{f', {probe} probe' if probe else ''})"
            k_ref, v_ref = k_all.clone(), v_all.clone()
            out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
            torch.cuda.synchronize()
            ref = dec.decode_attention_fused_q8_plain(q.float(), k_ref, v_ref, k_new, v_new,
                                                      layer, **kw)
            err = max(err, max_err(out, ref, label, **TOL16))
            for got, want in ((k_all, k_ref), (v_all, v_ref)):
                col = (got[layer, :, :, wpos].int() - want[layer, :, :, wpos].int()).abs().max()
                if col > 1:
                    raise AssertionError(f"{label}: written column off by {int(col)} steps")
                got[layer, :, :, wpos] = want[layer, :, :, wpos]
                if not torch.equal(got, want):
                    raise AssertionError(f"{label}: entries other than column write_pos changed")
            del k_ref, v_ref, ref
            if probe:
                continue
            args = (q, k_all, v_all, k_new, v_new, layer)
            ms = cuda_ms(lambda: dec.decode_attention_fused(*args, **kw))
            plain_ms = cuda_ms(lambda: dec.decode_attention_fused_q8_plain(*args, **kw), iters=5)
            lim = decode_bound(q, k_all, plens, pad, wpos)
            k16, v16 = (rnd(16, b, 8, 5120, 64) for _ in range(2))
            kw16 = {key: val for key, val in kw.items() if not key.endswith("scale")}
            c_ms = cuda_ms(lambda: dec.decode_attention_fused(q, k16, v16, k_new, v_new, layer,
                                                              **kw16))
            del k16, v16
            chooser, sweep = dec.card_splits, {}
            try:  # the chooser's alternatives: the kernel takes 1-16 CTAs
                for n in (1, 2, 4, 8, 16):
                    dec.card_splits = lambda *_: n
                    sweep[n] = cuda_ms(lambda: dec.decode_attention_fused(*args, **kw))
            finally:
                dec.card_splits = chooser
        splits = dec.card_splits(b, 8, q.device, dec.MAX_SPLITS_Q8)
        log(f"[kernels] C8, B = {b} ({splits} CTAs a (kv head, row) in a cluster): {ms:.4f} ms "
            f"(bound {lim['bound_ms']:.4f} ms of {lim['bound_by']}, "
            f"{100 * lim['bound_ms'] / ms:.1f}%); kernel C on a bf16 cache of the same shape "
            f"{c_ms:.4f} ms; plain {plain_ms:.4f} ms; max |kernel - plain| {err:.3e} (TOL16, "
            "with the interval and current-token probes); by CTAs a (kv head, row), ms: "
            + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
        c8_is_c_on_the_widened_cache(dec, q, k_all, v_all, layer, kw, f"C8 (B = {b})")
        del k_all, v_all
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **lim)


def vit_block_kernels(rnd, gen):
    """Kernels D-G at one gar_1b ViT layer: 17 tiles x 1025 tokens, width
    1024, 16 heads of 64, MLP 4096, tanh GELU, LayerScale."""
    from grasp_any_region_tpu_torch.ops import vit_attention as va
    from grasp_any_region_tpu_torch.ops import vit_block as vb
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    t, s, d, m, h = 17, 1025, 1024, 4096, 16

    def w(*shape, scale):
        return (rnd(*shape).float() * scale).to(torch.bfloat16)

    results = {}
    # E: mixed (per-head) rope angles of the 32 x 32 grid's magnitude
    for seq in (200, s):  # a ragged S first, then the gar_1b shape
        qkv = rnd(t if seq == s else 2, seq, 3 * d)
        ang = torch.rand((h, seq - 1, 32), generator=gen, device="cuda") * 40.0
        cos, sin = rope_head_tables(ang, h, 1)
        out = va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)
        torch.cuda.synchronize()
        ref = va.vit_attention_fused_qkv_plain(qkv.float(), cos, sin, h, 64)
        err = max_err(out, ref, f"E (S = {seq})", **sized_tol(ref))
        del ref
    # library: SDPA over (B, H, S, D) views of the fused buffer (no rope)
    heads = [qkv[..., i * d:(i + 1) * d].unflatten(-1, (h, 64)).transpose(1, 2) for i in range(3)]
    results["E"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)),
        plain_ms=cuda_ms(lambda: va.vit_attention_fused_qkv_plain(qkv, cos, sin, h, 64),
                         iters=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads)),
        **bound(nbytes(qkv, cos, sin, out), 4 * t * h * s * s * 64))
    log(f"[kernels] E (S = 1025; library: SDPA without rope): {share_line(results['E'])}; "
        f"host time a call {host_us(lambda: va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)):.1f}"
        " us (one TMA map encoded a call)")
    # S = 1025 is 8 x 128 + 1: the ninth query and key tiles hold one row
    # each. E at S = 1024 (8 x 8 tile pairs against 9 x 9) prices that tail.
    qkv_even, cos_even, sin_even = (x[:, 1:].contiguous() for x in (qkv, cos, sin))
    ms_even = cuda_ms(lambda: va.vit_attention_fused_qkv(qkv_even, cos_even, sin_even, h, 64))
    log(f"[kernels] E at S = 1024: {ms_even:.4f} ms against {results['E']['ms']:.4f} at 1025 "
        f"(work (1025 / 1024)^2 = 1.002x; tile pairs 81 / 64 = 1.27x)")
    del heads, qkv_even, cos_even, sin_even
    del qkv, cos, sin, out

    x, attn = rnd(t, s, d), rnd(t, s, d)
    ln = (1.0 + w(d, scale=0.2), w(d, scale=0.2))
    wqkv, bqkv = w(d, 3 * d, scale=d ** -0.5), w(3 * d, scale=0.1)
    wo, bo, ls1 = w(d, d, scale=d ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    fc1, b1 = w(d, m, scale=d ** -0.5), w(m, scale=0.1)
    fc2, b2, ls2 = w(m, d, scale=m ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    rows = t * s
    cases = {  # name: (kernel, plain, args, kwargs, GEMM operations)
        "D": (vb.vit_ln_qkv, vb.vit_ln_qkv_plain, (x, *ln, wqkv, bqkv), {}, 2 * rows * d * 3 * d),
        "F": (vb.vit_wo_residual, vb.vit_wo_residual_plain, (attn, x, wo, bo, ls1), {},
              2 * rows * d * d),
        "G": (vb.vit_mlp_residual, vb.vit_mlp_residual_plain,
              (x, *ln, fc1, b1, fc2, b2, ls2), dict(fast_gelu=True), 4 * rows * d * m),
    }
    # library: F's product and residual as one torch.addmm (no bias, no LayerScale)
    library = dict(F=lambda: torch.addmm(x.view(rows, d), attn.view(rows, d), wo))
    calls = {}
    for name, (kernel, plain, args, kw, ops) in cases.items():
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*(a.float() for a in args), **kw)
        max_err(out, ref, name)  # and at the output-sized tolerance:
        err = max_err(out, ref, name, **sized_tol(ref))
        del ref
        results[name] = dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*args, **kw)),
                             plain_ms=cuda_ms(lambda: plain(*args, **kw), iters=5),
                             library_ms=cuda_ms(library[name]) if name in library else None,
                             **bound(nbytes(*args, out), ops))
        calls[name] = out
    log(f"[kernels] F (library: torch.addmm(x, attn, wo)): {share_line(results['F'])}")
    vit_block_parts(results, calls, x, ln, wqkv, bqkv, fc1, b1, fc2, b2, ls2)
    return results


def vit_block_parts(results, calls, x, ln, wqkv, bqkv, fc1, b1, fc2, b2, ls2):
    """D's and G's parts on their own at the gar_1b layer (the LayerNorm
    pass by kernel 24's entry, each GEMM by `gar_vit_gemm`, on the call's
    operands; together they must give the call's bits), the host time a
    call, and the cuBLAS composite of each: a sequence of library calls,
    timed only (`library_ms` stays null: no one call computes D or G)."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import _build
    from grasp_any_region_tpu_torch.ops import vit_block as vb

    lib, stream = _build.library(), _build.stream_handle(x.device)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    m = fc1.shape[1]
    xr = x.view(rows, d)
    lw, lb, bq, v1, v2, g2 = (v.float().contiguous() for v in (*ln, bqkv, b1, b2, ls2))
    xn, qkv = torch.empty_like(xr), torch.empty((rows, 3 * d), dtype=x.dtype, device=x.device)
    h, out = torch.empty((rows, m), dtype=x.dtype, device=x.device), torch.empty_like(xr)
    p = torch.Tensor.data_ptr
    # name: (launch, GEMM operations); gar_vit_gemm's first argument is the
    # epilogue (csrc/gemm_sm90.cuh, gemm90::Epilogue): 0 residual, 1 bias,
    # 2 bias and tanh GELU
    parts = {
        "LayerNorm pass": (lambda: lib.gar_layer_norm(
            p(xr), p(lw), p(lb), p(xn), rows, d, 0, 1, 1, 1e-6, stream), 0),
        "qkv GEMM + bias": (lambda: lib.gar_vit_gemm(
            1, p(xn), p(wqkv), None, p(bq), None, p(qkv), rows, 3 * d, d, stream),
            2 * rows * d * 3 * d),
        "fc1 GEMM + GELU": (lambda: lib.gar_vit_gemm(
            2, p(xn), p(fc1), None, p(v1), None, p(h), rows, m, d, stream), 2 * rows * d * m),
        "fc2 GEMM + residual": (lambda: lib.gar_vit_gemm(
            0, p(h), p(fc2), p(xr), p(v2), p(g2), p(out), rows, d, m, stream),
            2 * rows * m * d),
    }
    for name, (launch, _) in parts.items():  # in order: fc1 reads the pass's xn, fc2 fc1's h
        _build.check(launch(), name)
    torch.cuda.synchronize()
    for key, got in (("D", qkv), ("G", out)):
        if not torch.equal(got.view_as(calls[key]), calls[key]):
            raise AssertionError(f"{key}: its parts launched one by one give other bits than "
                                 "the call")
    ms = {name: cuda_ms(launch) for name, (launch, _) in parts.items()}
    tf = {name: ops / ms[name] / 1e9 for name, (_, ops) in parts.items() if ops}
    d_args = (x, *ln, wqkv, bqkv)
    g_args = (x, *ln, fc1, b1, fc2, b2, ls2)

    def d_composite():
        return torch.addmm(bqkv, F.layer_norm(x, (d,), *ln, 1e-6).view(rows, d), wqkv)

    def g_composite():
        hidden = F.gelu(torch.addmm(b1, F.layer_norm(x, (d,), *ln, 1e-6).view(rows, d), fc1),
                        approximate="tanh")
        return torch.addcmul(xr, torch.addmm(b2, hidden, fc2), ls2)

    for key, kernel, part_names, args, kw, composite, sequence, host in (
            ("D", vb.vit_ln_qkv, ("LayerNorm pass", "qkv GEMM + bias"), d_args, {},
             d_composite, "F.layer_norm, torch.addmm", "two launches, three TMA maps"),
            ("G", vb.vit_mlp_residual,
             ("LayerNorm pass", "fc1 GEMM + GELU", "fc2 GEMM + residual"), g_args,
             dict(fast_gelu=True), g_composite, "F.layer_norm, addmm, F.gelu, addmm, addcmul",
             "three launches, seven TMA maps")):
        split = ", ".join(f"{n} {ms[n]:.4f} ms" + (f" ({tf[n]:.0f} TFLOP/s)" if n in tf else "")
                          for n in part_names)
        log(f"[kernels] {key}: {share_line(results[key])}; parts: {split} (sum "
            f"{sum(ms[n] for n in part_names):.4f}); host time a call "
            f"{host_us(lambda: kernel(*args, **kw), n=20):.1f} us ({host}); cuBLAS composite, "
            f"a sequence of calls ({sequence}), not one library call: "
            f"{cuda_ms(composite):.4f} ms")


def stream_splits_chosen(key, ws, din, index):
    """The CTAs a tile that stream kernel `key`'s wrapper launches with, for
    its weights `ws` (int8: each followed by its scales)."""
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm

    q8 = key.endswith("8")
    if key.startswith("J"):
        hq, hk = ws[0].shape[2], ws[2 if q8 else 1].shape[2]
        return lm._card_qkv_stream_splits(hq, hk, din, 1 if q8 else 2, index)
    n = lm.stream_n(torch.int8) if q8 else lm.STREAM_N
    per_sm = lm.STREAM_CTAS_PER_SM_Q8 if key == "I8" else lm.STREAM_CTAS_PER_SM
    return lm._card_splits(ws[0].shape[2], din, index, n, per_sm)


def qkv_mirror_err(label, key, ws, layer, x) -> float:
    """J or J8 against the mirror of its partition and order
    (`layer_qkv_stream_plain`, `layer_qkv_q8_stream_plain`) at the
    chooser's CTAs a tile, at TOL; returns the largest error."""
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm

    q8 = key == "J8"
    kernel = lm.layer_qkv_q8 if q8 else lm.layer_qkv
    mirror = lm.layer_qkv_q8_stream_plain if q8 else lm.layer_qkv_stream_plain
    splits = stream_splits_chosen(key, ws, x.shape[1], x.device.index)
    out = kernel(x, *ws, layer)
    torch.cuda.synchronize()
    at = [w[layer:layer + 1] if w.dtype == torch.int8 else w[layer:layer + 1].float() for w in ws]
    want = mirror(x.float(), *at, 0, splits)
    return max(max_err(o, m, f"{label} against its stream mirror (B = {x.shape[0]})")
               for o, m in zip(out, want))


GAR1B_WIDTHS = (2048, 8192, 2048, 512)  # decoder hidden, MLP, q, k / v
GAR8B_WIDTHS = (4096, 14336, 4096, 1024)


def decode_matmul_kernels(rnd, widths=GAR1B_WIDTHS, n_layers: int = 16, tag: str = ""):
    """Kernels H, I, J and their int8 forms H8, I8, J8 at the gar_1b decode
    shapes (hidden 2048, q 2048, kv 512, MLP 8192; or `widths`, each log
    line led by `tag`: GAR-8B's at 8 layers, without the narrow and ragged
    checks), the weights stacked
    (16, Din, Dout) and read at layer 7; the int8 weights are the bf16 ones
    quantized (`quantize_int8`). H runs at both the wo and the w_down
    width; its entry carries w_down. Checked against the plain version at
    B = 24 and B = 1 (the kernels line carries B = 1), and at the narrow
    config's ragged widths (hidden 256, q 256, kv 64, MLP 1024) at B = 1 and
    5. Beside each time: the weight bytes over it, cuBLAS's bf16 product of
    the same layer (the XLA form's ops; torch.mm is H's library call, J's
    is three), for H8 torch._weight_int8pack_mm (the library's W8A16
    product, timed only; J8's composite is three of them), and a
    device-to-device copy of the same bytes. All six run on the TMA-fed
    stream, and each (H and H8 at both widths) is also reported with its
    host time a call and its time by CTAs a column tile (the cluster size,
    1-16), at B = 24 and 1. J and J8 are also held against the mirror of
    their partition and order at B = 24 and 1, at the narrow widths at B =
    1 and 5, and at ragged widths (Hq 136 / 144, Hk 40 / 48 for bf16 /
    int8: a part tile, k and v narrower than a tile) at B = 1, 5 and 24."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.models.quantize import quantize_int8
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm

    def calls(d, m, hq, hk, n_layers):
        def stack(din, n):
            return (rnd(n_layers, din, n).float() * din ** -0.5).to(torch.bfloat16)

        wq, wk, wv, wo = stack(d, hq), stack(d, hk), stack(d, hk), stack(hq, d)
        wg, wu, wd = stack(d, m), stack(d, m), stack(m, d)
        mm = (lm.layer_matmul, lm.layer_matmul_plain, lm.layer_matmul_q8,
              lm.layer_matmul_q8_plain, lambda x, w, i: x @ w[i])
        return {  # label: (key, kernel, plain, int8 kernel, int8 plain, cuBLAS form, weights, Din)
            "H wo": ("H", *mm, (wo,), hq),
            "I": ("I", lm.layer_swiglu, lm.layer_swiglu_plain, lm.layer_swiglu_q8,
                  lm.layer_swiglu_q8_plain,
                  lambda x, g, u, i: F.silu(x @ g[i]) * (x @ u[i]), (wg, wu), d),
            "J": ("J", lm.layer_qkv, lm.layer_qkv_plain, lm.layer_qkv_q8, lm.layer_qkv_q8_plain,
                  lambda x, a, b, c, i: (x @ a[i], x @ b[i], x @ c[i]), (wq, wk, wv), d),
            "H w_down": ("H", *mm, (wd,), m),
        }

    def check(label, kernel, plain, ws, layer, x):
        out = kernel(x, *ws, layer)
        torch.cuda.synchronize()
        ref = plain(x.float(), *(w[layer:layer + 1].float() for w in ws), 0)
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        return max(max_err(o, r, f"{label} (B = {x.shape[0]})") for o, r in zip(outs, refs))

    def int8(ws):  # (w, ...) -> (q, scale, ...)
        return tuple(t for w in ws for t in quantize_int8(w))

    for label, (key, kernel, plain, kernel8, plain8, _, ws, din) in calls(256, 1024, 256, 64,
                                                                           2).items():
        if widths != GAR1B_WIDTHS:
            break
        for b in (1, 5):
            check(f"{label}, narrow", kernel, plain, ws, 1, rnd(b, din))
            check(f"{label} int8, narrow", kernel8, plain8, int8(ws), 1, rnd(b, din))
            if key == "J":
                qkv_mirror_err("J, narrow", "J", ws, 1, rnd(b, din))
                qkv_mirror_err("J8, narrow", "J8", int8(ws), 1, rnd(b, din))
    for key, d, hq, hk in (("J", 200, 136, 40), ("J8", 208, 144, 48)):
        if widths != GAR1B_WIDTHS:
            break
        *_, ws, _ = calls(d, 64, hq, hk, 3)["J"]
        kernel, plain, ws = ((lm.layer_qkv_q8, lm.layer_qkv_q8_plain, int8(ws)) if key == "J8"
                             else (lm.layer_qkv, lm.layer_qkv_plain, ws))
        for b in (1, 5, 24):
            x = rnd(b, d)
            check(f"{key}, ragged", kernel, plain, ws, 2, x)
            qkv_mirror_err(f"{key}, ragged", key, ws, 2, x)

    def copy_ms(n_bytes):
        src = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        return cuda_ms(lambda: dst.copy_(src))

    def stream_report(name, key, kernel, ws, x, ms, seq_ms, n_bytes):
        """A stream kernel's time (one call, and a layer of 16 back to back,
        measured by the caller), its host time a call, and its time by CTAs
        a tile (the cluster size, 1-16)."""
        mirror = (f"; max |kernel - stream mirror| {qkv_mirror_err(name, key, ws, layer, x):.3e}"
                  if key.startswith("J") else "")
        hus = host_us(lambda: kernel(x, *ws, layer))
        attr = "_card_qkv_stream_splits" if key.startswith("J") else "_card_splits"
        chooser, times = getattr(lm, attr), {}
        try:  # the chooser's alternatives: the kernel takes 1-16 CTAs a tile
            for n in (1, 2, 4, 8, 16):
                setattr(lm, attr, lambda *_: n)
                times[n] = cuda_ms(lambda: kernel(x, *ws, layer))
        finally:
            setattr(lm, attr, chooser)
        splits = stream_splits_chosen(key, ws, x.shape[1], x.device.index)
        log(f"[kernels] {tag}{name}, B = {x.shape[0]}{mirror}: TMA-fed {ms:.4f} ms = "
            f"{n_bytes / ms / 1e6:.0f} GB/s of weights, back to back {seq_ms:.4f} ms a layer = "
            f"{n_bytes / seq_ms / 1e6:.0f} GB/s, host {hus:.1f} us a call ({splits} CTAs a "
            "tile); by CTAs a tile, ms: " + ", ".join(f"{n}: {t:.4f}" for n, t in times.items()))

    layer, results = 7, {}
    d_model, d_mlp, d_q, d_kv = widths
    for label, (key, kernel, plain, kernel8, plain8, cublas, ws, din) in calls(
            d_model, d_mlp, d_q, d_kv, n_layers).items():
        qs = int8(ws)
        n_bytes = nbytes(*(w[layer] for w in ws))
        n8 = nbytes(*(t[layer] for t in qs))
        copies = copy_ms(n_bytes), copy_ms(n8)
        n_out = ws[0].shape[2] if key == "I" else sum(w.shape[2] for w in ws)
        if key in ("H", "J"):  # the library's W8A16 call takes (N, K) weights, bf16 scales
            packs = [(qs[i][layer].t().contiguous(), qs[i + 1][layer].reshape(-1)
                      .to(torch.bfloat16)) for i in range(0, len(qs), 2)]
        for b in (24, 1):
            x = rnd(b, din)
            err, err8 = (check(label, kernel, plain, ws, layer, x),
                         check(f"{label} int8", kernel8, plain8, qs, layer, x))
            lib8_ms = None
            if key in ("H", "J"):  # H8's library call; J8's composite of three
                lib8 = lambda: [torch._weight_int8pack_mm(x, w_nk, s_n) for w_nk, s_n in packs]
                try:
                    refs8 = plain8(x.float(), *qs, layer)
                    lib_err = max((o.float() - r).abs().max().item() for o, r in zip(
                        lib8(), refs8 if key == "J" else (refs8,)))
                    lib8_ms = cuda_ms(lib8)
                    log(f"[kernels] {tag}{label} int8, B = {b}: library "
                        f"{len(packs)} x torch._weight_int8pack_mm {lib8_ms:.4f} ms (bf16 "
                        f"scales, bf16 out; max |library - plain| {lib_err:.3e})")
                except RuntimeError as e:
                    log(f"[kernels] {tag}{label} int8, B = {b}: library "
                        f"torch._weight_int8pack_mm refused: {e}")
            ms, ms8 = cuda_ms(lambda: kernel(x, *ws, layer)), cuda_ms(lambda: kernel8(x, *qs, layer))
            # every layer once, back to back, as a decode step calls them (the
            # 16 layers' weights exceed the L2, so each call finds its own cold)
            n_layers = ws[0].shape[0]
            seq_ms = cuda_ms(lambda: [kernel(x, *ws, i) for i in range(n_layers)],
                             iters=5, sleep_cycles=20_000_000) / n_layers
            seq8_ms = cuda_ms(lambda: [kernel8(x, *qs, i) for i in range(n_layers)],
                              iters=5, sleep_cycles=20_000_000) / n_layers
            stream_report(label, key, kernel, ws, x, ms, seq_ms, n_bytes)
            stream_report(label.replace(key, key + "8", 1), key + "8", kernel8, qs, x, ms8,
                          seq8_ms, n8)
            blas_ms = cuda_ms(lambda: cublas(x, *ws, layer))
            plain_ms = cuda_ms(lambda: plain(x, *ws, layer), iters=5)
            plain8_ms = cuda_ms(lambda: plain8(x, *qs, layer), iters=5)
            io = 2 * b * (din + n_out)
            ops = 2 * b * din * sum(w.shape[2] for w in ws)
            lim, lim8 = bound(n_bytes + io, ops), bound(n8 + io, ops)
            log(f"[kernels] {tag}{label}, B = {b}: {ms:.4f} ms = {n_bytes / ms / 1e6:.0f} GB/s of "
                f"weights ({n_bytes / 1e6:.1f} MB, bound {lim['bound_ms']:.4f} ms); cuBLAS bf16 "
                f"{blas_ms:.4f} ms ({n_bytes / blas_ms / 1e6:.0f} GB/s); plain fp32 "
                f"{plain_ms:.4f} ms; copy of the same bytes {copies[0]:.4f} ms (moves 2x: "
                f"{2 * n_bytes / copies[0] / 1e6:.0f} GB/s); {n_layers} layers back to back "
                f"{seq_ms:.4f} ms a layer = {n_bytes / seq_ms / 1e6:.0f} GB/s; "
                f"max |kernel - plain| {err:.3e}")
            log(f"[kernels] {tag}{label} int8 ({key}8), B = {b}: {ms8:.4f} ms = "
                f"{n8 / ms8 / 1e6:.0f} GB/s of int8 weights and scales ({n8 / 1e6:.1f} MB, bound "
                f"{lim8['bound_ms']:.4f} ms); bf16 kernel {ms:.4f} ms, cuBLAS bf16 "
                f"{blas_ms:.4f} ms; plain fp32 {plain8_ms:.4f} ms; copy of the same bytes "
                f"{copies[1]:.4f} ms; {n_layers} layers back to back {seq8_ms:.4f} ms a layer "
                f"= {n8 / seq8_ms / 1e6:.0f} GB/s; max |kernel - plain| {err8:.3e}")
        if label != "H wo":  # B = 1 at the last width of each kernel goes in the line
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=blas_ms if key == "H" else None, **lim)
            results[f"{key}8"] = dict(max_abs_err=err8, ms=ms8, plain_ms=plain8_ms,
                                      library_ms=lib8_ms if key == "H" else None, **lim8)
    return results


def same_bits(run, out, name: str) -> None:
    """Kernels 21-23 sum across clusters through arrival counters: a second
    launch must give `out`'s bits and leave every counter at 0."""
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk

    again = run()
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError(f"{name}: a second launch on the same inputs gives other bits")
    if mk._counters(out.device).any():
        raise AssertionError(f"{name}: an arrival counter is not back at 0 after the launch")


def xn_low_half_probe(d: int = 2048, hq: int = 2048, hk: int = 512) -> float:
    """Kernel 20 keeps JAX's fp32 xn as a bf16 high and a low half. On
    inputs whose two halves of K cancel but for xn's low bits (x = 1 +
    2^-7 and norm 1 + 2^-7 over the first half, x = 1 + 2^-6 and norm 1
    over the second; int8 weights +1 then -1 with scales 1; cos 1, sin 0)
    every output is rstd d 2^-15, about 0.062 at d = 2048; with xn rounded
    to bf16 it is 0 or 8. Checked against the plain version (fp32 xn) at
    TOL; returns the largest error."""
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk

    half = d // 2
    x = torch.cat([torch.full((1, half), 1 + 2 ** -7), torch.full((1, half), 1 + 2 ** -6)], 1)
    norm = torch.cat([torch.full((2, half), 1 + 2 ** -7), torch.ones(2, half)], 1)
    sign = torch.cat([torch.ones(half), -torch.ones(half)]).to(torch.int8)
    mats = [t.cuda() for n in (hq, hk, hk)
            for t in (sign[None, :, None].expand(2, d, n).contiguous(), torch.ones(2, 1, n))]
    cos, sin = torch.ones(1, 64, device="cuda"), torch.zeros(1, 64, device="cuda")
    args = (x.to("cuda", torch.bfloat16), norm.to("cuda", torch.bfloat16), *mats, cos, sin, cos,
            sin, 1)
    out = mk.layer_qkv_norm_rope_q8(*args, eps=1e-5, head_dim=64)
    torch.cuda.synchronize()
    ref = mk.layer_qkv_norm_rope_q8_plain(*args, eps=1e-5, head_dim=64)
    return max(max_err(o, r, "20's xn low-half probe") for o, r in zip(out, ref))


def qkv_stream_report(key, kernel, args, kw, layer, w_bytes) -> str:
    """Kernel 19 or 20 on the weight stream: held against its stream mirror
    (the kernel's partition and order) at the chooser's CTAs a tile; its 16
    layers back to back (each layer's weights cold: they exceed the L2), its
    host time a call, and its time by CTAs a tile (1-8 bf16, 1-16 int8; a
    size whose xn does not fit a CTA is refused). The line's tail."""
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk

    x, wq, wk = args[0], args[2], args[3 if key == "19" else 4]
    q8, (hq, hk), d = key == "20", (wq.shape[-1], wk.shape[-1]), x.shape[1]
    mirror = mk.layer_qkv_norm_rope_q8_stream_plain if q8 else mk.layer_qkv_norm_rope_stream_plain
    splits = mk.qkv_card_splits(hq, hk, d, q8, x.device)
    out = kernel(*args, layer, **kw)
    want = mirror(*args, layer, splits=splits, **kw)
    err = max(max_err(o, m, f"{key} against its stream mirror (B = {x.shape[0]})")
              for o, m in zip(out, want))
    n_layers = wq.shape[0]
    seq_ms = cuda_ms(lambda: [kernel(*args, i, **kw) for i in range(n_layers)], iters=5,
                     sleep_cycles=20_000_000) / n_layers
    hus = host_us(lambda: kernel(*args, layer, **kw))
    chooser, times = mk.qkv_card_splits, {}
    try:  # the chooser's alternatives
        for n in (1, 2, 4, 8, 16)[:5 if q8 else 4]:
            mk.qkv_card_splits = lambda *_: n
            try:
                times[n] = f"{cuda_ms(lambda: kernel(*args, layer, **kw)):.4f}"
            except RuntimeError:
                times[n] = "refused"
    finally:
        mk.qkv_card_splits = chooser
    probe = f"; xn low-half probe max err {xn_low_half_probe():.3e}" if q8 else ""
    return (f"; max |kernel - stream mirror| {err:.3e}{probe}; {n_layers} layers back to back "
            f"{seq_ms:.4f} ms a layer = {w_bytes / seq_ms / 1e6:.0f} GB/s; host {hus:.1f} us a "
            f"call ({splits} CTAs a tile); by CTAs a tile, ms: "
            + ", ".join(f"{n}: {v}" for n, v in times.items()))


def mega_kernels(rnd):
    """Kernels 19-23 at the gar_1b decode shapes (hidden 2048, q 2048, kv 512,
    MLP 8192, 32 / 8 heads of 64), the weights stacked (16, Din, Dout) and
    read at layer 7 (int8: the bf16 ones quantized), at B = 24 and B = 1
    (the kernels line carries B = 1), against their plain versions on the
    same bf16 inputs. 22 runs over a cache of the main path's shape, (16, B,
    8, 5120, 64) with the 4662-token prompt, write_pos just past prompt_pad;
    its written column must hold the new K/V and nothing else may change.
    Beside each time: the weight (and, for 22, cache) bytes over it, for 22
    kernel C + kernel H (wo) on the same inputs, the fused step's pair, and
    for 19 and 20 `qkv_stream_report`."""
    from grasp_any_region_tpu_torch.core.config import gar_1b
    from grasp_any_region_tpu_torch.models.quantize import quantize_int8
    from grasp_any_region_tpu_torch.ops import decode_attention as dec
    from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm
    from grasp_any_region_tpu_torch.ops.rope import llama_inv_freq, rope_cos_sin

    tc = gar_1b().text
    d, m, hq, hk, n_layers, layer = 2048, 8192, 2048, 512, 16, 7
    eps = tc.rms_norm_eps

    def stack(din, n):
        return (rnd(n_layers, din, n).float() * din ** -0.5).to(torch.bfloat16)

    wq, wk, wv, wo = stack(d, hq), stack(d, hk), stack(d, hk), stack(hq, d)
    wg, wu, wd = stack(d, m), stack(d, m), stack(m, d)
    bf = dict(wq=wq, wk=wk, wv=wv, wo=wo, wg=wg, wu=wu, wd=wd)
    q8 = {name: quantize_int8(w) for name, w in bf.items()}

    def mats(*names, int8=False):  # the weights (int8: and their scales) of `names`
        return [t for n in names for t in (q8[n] if int8 else (bf[n],))]

    norm = (1.0 + 0.2 * rnd(n_layers, d).float()).to(torch.bfloat16)
    pad, wpos = 4662, 4663
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    results = {}
    for b in (24, 1):
        plens = [pad] + torch.randint(3000, pad + 1, (b - 1,), generator=gen,
                                      device="cuda").tolist()
        cos, sin = rope_cos_sin(torch.tensor(plens, device="cuda") + (wpos - pad),
                                llama_inv_freq(tc, "cuda"))
        x = rnd(b, d) * 4
        io = 2 * nbytes(x)  # the residual in, the new residual (or q, k, v) out
        cases = {  # key: (kernel, plain, args, kwargs, weight tensors at the layer, GEMM ops)
            "19": (mk.layer_qkv_norm_rope, mk.layer_qkv_norm_rope_plain,
                   (x, norm, wq, wk, wv, cos, sin, cos, sin), dict(eps=eps, head_dim=64),
                   (wq, wk, wv), 2 * b * d * (hq + 2 * hk)),
            "20": (mk.layer_qkv_norm_rope_q8, mk.layer_qkv_norm_rope_q8_plain,
                   (x, norm, *mats("wq", "wk", "wv", int8=True), cos, sin, cos, sin),
                   dict(eps=eps, head_dim=64), mats("wq", "wk", "wv", int8=True),
                   2 * b * d * (hq + 2 * hk)),
            "23": (mk.layer_mlp_residual, mk.layer_mlp_residual_plain, (x, norm, wg, wu, wd),
                   dict(eps=eps), (wg, wu, wd), 6 * b * d * m),
            "21": (mk.layer_mlp_residual_q8, mk.layer_mlp_residual_q8_plain,
                   (x, norm, *mats("wg", "wu", "wd", int8=True)), dict(eps=eps),
                   mats("wg", "wu", "wd", int8=True), 6 * b * d * m),
        }
        for key, (kernel, plain, args, kw, ws, ops) in cases.items():
            out = kernel(*args, layer, **kw)
            torch.cuda.synchronize()
            ref = plain(*args, layer, **kw)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            err = max(max_err(o, r, f"{key} (B = {b})") for o, r in zip(outs, refs))
            if key in ("21", "23"):  # the ordered sum: the same bits again, the counters at 0
                same_bits(lambda: kernel(*args, layer, **kw), out, f"{key} (B = {b})")
            w_bytes = nbytes(*(w[layer] for w in ws))
            ms = cuda_ms(lambda: kernel(*args, layer, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, layer, **kw), iters=5)
            lim = bound(w_bytes + io + nbytes(cos, sin, norm[layer]), ops)
            clusters = (f"; {m // mk.MLP_TILE} tiles x {mk.mlp_card_splits(m, d, b, key == '21', x.device)}"
                        " CTAs" if key in ("21", "23")
                        else qkv_stream_report(key, kernel, args, kw, layer, w_bytes))
            log(f"[kernels] {key} ({kernel.__name__}), B = {b}: {ms:.4f} ms = "
                f"{w_bytes / ms / 1e6:.0f} GB/s of weights ({w_bytes / 1e6:.1f} MB, bound "
                f"{lim['bound_ms']:.4f} ms of {lim['bound_by']}); plain {plain_ms:.4f} ms; "
                f"max |kernel - plain| {err:.3e}{clusters}")
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **lim)

        # 22 over the main path's cache, bf16 wo then int8 wo
        k_all, v_all = rnd(n_layers, b, 8, 5120, 64), rnd(n_layers, b, 8, 5120, 64)
        q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
        kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
                  write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad)
        k_ref, v_ref = k_all.clone(), v_all.clone()
        cache_bytes, cache_ops = decode_work(q, k_all, plens, pad, wpos)
        c_h = cuda_ms(lambda: lm.layer_matmul(dec.decode_attention_fused(
            q, k_all, v_all, k_new, v_new, layer, **kw).reshape(b, hq), wo, layer))
        for label, w, scale in (("bf16 wo", wo, None), ("int8 wo", *q8["wo"])):
            args = (q, k_all, v_all, k_new, v_new, w, x, layer)
            out = mk.decode_attention_wo(*args, wo_scale=scale, **kw)
            torch.cuda.synchronize()
            k_exp, v_exp = k_ref.clone(), v_ref.clone()
            ref = mk.decode_attention_wo_plain(q, k_exp, v_exp, k_new, v_new, w, x, layer,
                                               wo_scale=scale, **kw)
            err = max_err(out, ref, f"22 {label} (B = {b})")
            if not (torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)
                    and torch.equal(k_all[layer, :, :, wpos], k_new)):
                raise AssertionError(f"22 {label} (B = {b}): the cache differs from the plain "
                                     "version's, or column write_pos does not hold the new K/V")
            same_bits(lambda: mk.decode_attention_wo(*args, wo_scale=scale, **kw), out,
                      f"22 {label} (B = {b})")
            del k_exp, v_exp
            ms = cuda_ms(lambda: mk.decode_attention_wo(*args, wo_scale=scale, **kw))
            plain_ms = cuda_ms(lambda: mk.decode_attention_wo_plain(*args, wo_scale=scale, **kw),
                               iters=5)
            n_bytes = cache_bytes + nbytes(w[layer]) + io
            if scale is not None:
                n_bytes += nbytes(scale[layer])
            lim = bound(n_bytes, cache_ops + 2 * b * hq * d)
            if scale is None:
                results["22"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                     **lim)
            log(f"[kernels] 22 (decode_attention_wo, {label}), B = {b}, "
                f"{mk.attention_wo_splits(b, 8, x.device)} CTAs a (kv head, row): {ms:.4f} ms = "
                f"{n_bytes / ms / 1e6:.0f} GB/s ({cache_bytes / 1e6:.1f} MB of cache, "
                f"{nbytes(w[layer]) / 1e6:.1f} MB of wo; bound {lim['bound_ms']:.4f} ms of "
                f"{lim['bound_by']}); kernel C + kernel H (bf16 wo) on the same inputs "
                f"{c_h:.4f} ms; plain {plain_ms:.4f} ms; max |kernel - plain| {err:.3e}")
        del k_all, v_all, k_ref, v_ref
    torch.cuda.empty_cache()
    return results


def narrow_config(kv_heads: int = 1):
    from grasp_any_region_tpu_torch.core.config import gar_1b

    cfg = gar_1b()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, width=256, num_heads=4, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=256, num_heads=4, num_kv_heads=kv_heads,
                                 head_dim=64, num_layers=2, intermediate_size=1024),
    )


def narrow_8b_config():
    """GAR-8B's shape at narrow widths: the PE-G tower at head dim 96
    (width 192, 2 heads, depth 2), the decoder at head dim 128 with GQA 4:1
    (hidden 512, 4 heads over 1 kv head, 2 layers, intermediate 1024), the
    untied head and llama3 rope at factor 8, as gar_8b has them."""
    from grasp_any_region_tpu_torch.core.config import gar_8b

    cfg = gar_8b()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, width=192, num_heads=2, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=512, num_heads=4, num_kv_heads=1,
                                 head_dim=128, num_layers=2, intermediate_size=1024),
    )


def random_params(cfg, device):
    """Seeded random init in bf16, with a random mask_embed (it is zero at
    init, which would leave the mask path idle)."""
    from grasp_any_region_tpu_torch.core.weights import init_gar_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_gar_params(cfg, gen, device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        params.mask_embed.kernel.normal_(0.0, 0.02, generator=gen)
    return params


def bench_batch(cfg, device):
    """One row, one region: GAR-1B's 17 tiles (thumbnail + 4 x 4), or a
    thumbnail and a 2 x 4 grid where the config takes at most 8 tiles
    (GAR-8B, as the JAX package's 8B caption bench)."""
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch

    grid = (4, 4) if cfg.max_num_tiles >= 16 else (2, 4)
    batch, _, prompt_lens = synthetic_batch(cfg, batch=1, grid=grid, regions=1,
                                            seed=SEED, device=device)
    return batch, prompt_lens


def mega_counts(layers: int, int8: bool) -> dict:
    """Launches of the mega step's kernels over `layers` layer calls."""
    return {"20": layers, "21": layers, "22": layers} if int8 else \
        {"19": layers, "22": layers, "23": layers}


@torch.inference_mode()
def phase_cross_check(cfg, int8: bool = False, mega: bool = False, int8_cache: bool = True,
                      batches=bench_batch, mask_compat: bool = False, video_mode: bool = False,
                      label: str = ""):
    """The kernel path on the card against the plain path on the CPU, from
    the same params (int8: quantized once, on the CPU, and copied). The
    default decode step (int8: with an int8 cache, unless int8_cache is
    False, as at GAR-8B's head dim, where C8 has no instance), or with mega
    the mega step on a bf16 cache, on the card and on the CPU (there
    through its plain versions), its launches counted. batches(cfg, device)
    gives the (batch, prompt_lens) of both sides (default the synthetic
    bench batch, whose mask plane is binary: mask_compat False); the
    prefill's logits are read at each row's last prompt token."""
    from grasp_any_region_tpu_torch.models.gar import (
        gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    p_cpu = random_params(cfg, "cpu")
    if int8:
        p_cpu = quantize_decode_weights(p_cpu)
    tag = ("[cross-check" + (" 8B-shaped" if cfg.text.head_dim == 128 else "")
           + (" mega" if mega else "") + (" int8" if int8 else "") + label + "]")
    use_kernel = "mega" if mega else None
    runs = []  # logits per path: prefill, then 4 decode steps
    tokens = None
    for dev, params in (("cuda", copy.deepcopy(p_cpu).to("cuda")), ("cpu", p_cpu)):
        batch, plens = batches(cfg, dev)
        s = batch.input_ids.shape[1]
        reset_counts()
        hidden, kv = gar_prefill(params, cfg, batch, mask_compat=mask_compat,
                                 video_mode=video_mode)
        if dev == "cuda" and cfg.text.head_dim == 128:  # the tower unfused at 96: A; prefill B
            torch.cuda.synchronize()
            want = expect(A=cfg.vision.depth, B=cfg.text.num_layers)
            if read_counts() != want:
                raise AssertionError(f"{tag} prefill launches {read_counts()}, expected {want}")
        last = hidden[torch.arange(hidden.shape[0], device=dev), plens.long() - 1]
        logits = [lm_logits(params.llm, cfg.text, last,
                            valid_vocab=cfg.extended_vocab_size).float().cpu()]
        cache = seed_cache_from_prefill(cfg, kv, plens, ((s + 4 + 511) // 512) * 512,
                                        quantize_kv=int8 and int8_cache and not mega)
        # both paths decode the card's greedy tokens, so the steps stay comparable
        feed = tokens if tokens is not None else [int(logits[0].argmax())]
        reset_counts()
        for step in range(4):
            tok = torch.tensor([feed[step]], dtype=torch.int32, device=dev)
            lg, cache = gar_decode_step(params, cfg, tok, cache, s, use_kernel=use_kernel)
            logits.append(lg.float().cpu())
            if tokens is None:
                feed.append(int(lg.argmax()))
        if dev == "cuda" and (mega or cfg.text.head_dim == 128):
            torch.cuda.synchronize()
            n = 4 * cfg.text.num_layers
            want = expect(**(mega_counts(n, int8) if mega else
                             dict(C=n, H8=2 * n, I8=n, J8=n) if int8 else
                             dict(C=n, H=2 * n, I=n, J=n)))
            if read_counts() != want:
                raise AssertionError(f"{tag} launches {read_counts()}, expected {want}")
        tokens = feed
        runs.append(logits)
    worst = 0.0
    for i, (a, b) in enumerate(zip(*runs)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"cross-check: non-finite logits at step {i}")
        valid = slice(0, cfg.extended_vocab_size)
        rel = ((a[..., valid] - b[..., valid]).abs().max() / b[..., valid].abs().max()).item()
        worst = max(worst, rel)
        log(f"{tag} step {i}: max |card - cpu| / max |cpu| = {rel:.3e}, "
            f"greedy card {int(a.argmax())}, cpu {int(b.argmax())}")
    if worst > E2E_TOL:
        raise AssertionError(f"{tag} kernel path and plain path differ by {worst:.3e} "
                             f"> {E2E_TOL} of the logit range")
    log(f"{tag} fed tokens {tokens}; worst relative logit error {worst:.3e} <= {E2E_TOL}")


def counter_modules():
    """The wrapper modules whose launch counters the phases read."""
    from grasp_any_region_tpu_torch.ops import decode_attention, flash_attention, layer_matmul
    from grasp_any_region_tpu_torch.ops import decode_megakernel, flash_backward, vit_attention
    from grasp_any_region_tpu_torch.ops import norms, vit_block

    return (decode_attention, flash_attention, vit_attention, vit_block, layer_matmul,
            flash_backward, decode_megakernel, norms)


def reset_counts():
    dec, fa, va, vb, lm, fb, mk, nm = counter_modules()
    va.launches = va.launches_fused = va.launches_bwd = 0
    fa.launches = fa.launches_segments = dec.launches = dec.launches_q8 = 0
    dec.launches_stacked = nm.launches = 0
    fb.launches_dq = fb.launches_dkv = fb.launches_segments = 0
    vb.launches.update(D=0, F=0, G=0)
    for counts in (lm.launches, mk.launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts():
    dec, fa, va, vb, lm, fb, mk, nm = counter_modules()
    return {"A": va.launches, "B": fa.launches, "C": dec.launches, "C8": dec.launches_q8,
            "D": vb.launches["D"], "E": va.launches_fused, "F": vb.launches["F"],
            "G": vb.launches["G"], **lm.launches, "5": va.launches_bwd,
            "16": dec.launches_stacked, "17": fb.launches_dq, "18": fb.launches_dkv,
            **mk.launches, "24": nm.launches}


def segmented_counts():
    """Launches of B and of 18 that carried segment ids."""
    _, fa, _, _, _, fb, _, _ = counter_modules()
    return {"B": fa.launches_segments, "18": fb.launches_segments}


def expect(**counts):
    """Launch counts of every kernel: the given ones, 0 for the rest."""
    return {key: counts.get(key, 0) for key in KERNELS}


@torch.inference_mode()
def phase_vision_forms(cfg, params):
    """The gar_1b tower in both forms on the same params and inputs."""
    from grasp_any_region_tpu_torch.models.gar import decode_mask_values, mask_patch_embed
    from grasp_any_region_tpu_torch.models.vision import vision_forward

    batch, _ = bench_batch(cfg, "cuda")
    pix = batch.pixel_values.reshape((-1,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((-1,) + batch.mask_values.shape[2:])
    me = mask_patch_embed(params, cfg, decode_mask_values(cfg, msk, compat=False)
                          .to(torch.bfloat16))
    outs, ms, counts = {}, {}, {}
    for form, fused in (("fused", True), ("unfused", False)):
        def run():
            return vision_forward(params.vision, cfg.vision, pix, me, fused_blocks=fused)

        reset_counts()
        outs[form] = run()
        torch.cuda.synchronize()
        counts[form] = read_counts()
        ms[form] = cuda_ms(run, iters=3, warmup=1)
    depth = cfg.vision.depth
    expected = dict(fused=expect(D=depth, E=depth, F=depth, G=depth), unfused=expect(A=depth))
    if counts != expected:
        raise AssertionError(f"vision forms: launch counts {counts}, expected {expected}")
    fused, plain = outs["fused"].float(), outs["unfused"].float()
    if fused.shape != (pix.shape[0], cfg.vision.seq_len, cfg.vision.width) \
            or not torch.isfinite(fused).all():
        raise AssertionError(f"vision forms: fused output {tuple(fused.shape)} or non-finite")
    rel = ((fused - plain).abs().max() / plain.abs().max()).item()
    log(f"[vision] {pix.shape[0]} tiles: fused {ms['fused']:.2f} ms, unfused "
        f"{ms['unfused']:.2f} ms; max |fused - unfused| / max |unfused| = {rel:.3e}")
    if rel > E2E_TOL:
        raise AssertionError(f"vision forms differ by {rel:.3e} > {E2E_TOL} of the range")
    return counts["unfused"]


def step_times(step, iters: int = 5):
    """(device ms, host ms) per call of `step`, medians. Device: CUDA events
    around the step while the card sleeps first, so the host has queued
    the whole step before the card reaches it and host dispatch leaves no
    gaps in the span. Host: wall clock of the step and a sync."""
    dev, host = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(dev), statistics.median(host)


def device_ops(run) -> int:
    """Device ops (kernels, copies, fills) the profiler sees in one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(r.count for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA)


@torch.inference_mode()
def phase_decode_forms(cfg, params, params_q8):
    """One gar_1b decode step in each form from one seeded cache (the main
    path's: B = 1, the 4662-token prompt, 5120 columns) and the same input
    embedding, each form on its own copy of the cache: fused, XLA, the int8
    step (params_q8: `quantize_decode_weights(params)`, the prefill seeded
    into an int8 cache), the mega step on the bf16 cache with bf16 and with
    int8 weights, and the XLA form of the serving-only int8 tree (which
    projects through the int8 weights, the mega int8 form's reference); then
    the LM head in bf16 and in int8."""
    from grasp_any_region_tpu_torch.models.gar import gar_prefill, seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.llama import embed_tokens, llama_decode_step, lm_logits
    from grasp_any_region_tpu_torch.models.quantize import serving_weights

    batch, plens = bench_batch(cfg, "cuda")
    s = batch.input_ids.shape[1]
    hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
    first = lm_logits(params.llm, cfg.text, hidden[:, -1],
                      valid_vocab=cfg.extended_vocab_size).argmax(-1)
    max_len = ((s + 256 + 511) // 512) * 512
    seeded = seed_cache_from_prefill(cfg, kv, plens, max_len)
    seeded_q8 = seed_cache_from_prefill(cfg, kv, plens, max_len, quantize_kv=True)
    del hidden, kv
    emb = embed_tokens(params.llm, first[:, None])
    n = cfg.text.num_layers
    serving = serving_weights(params)
    forms = {  # form: (decoder params, cache, use_kernel, launches a step)
        "fused": (params.llm, seeded, "fused", expect(C=n, H=2 * n, I=n, J=n)),
        "xla": (params.llm, seeded, False, expect(C=n)),
        "int8": (params_q8.llm, seeded_q8, None, expect(C8=n, H8=2 * n, I8=n, J8=n)),
        "mega": (params.llm, seeded, "mega", expect(**mega_counts(n, False))),
        "mega int8 weights": (params_q8.llm, seeded, "mega", expect(**mega_counts(n, True))),
        "xla int8 weights": (serving.llm, seeded, False, expect(C=n)),
    }
    outs, counts, times, ops = {}, {}, {}, {}
    for form, (llm, src, use_kernel, _) in forms.items():
        cache = src._replace(k=src.k.clone(), v=src.v.clone(), write_pos=src.write_pos.clone())

        def step():
            return llama_decode_step(llm, cfg.text, emb, cache, s, use_kernel=use_kernel)

        reset_counts()
        hidden, _ = step()
        torch.cuda.synchronize()
        counts[form] = read_counts()
        outs[form] = (hidden.float(), cache.k[:, :, :, s].float(), cache.v[:, :, :, s].float())
        times[form] = step_times(step)
        if form in ("fused", "mega"):
            ops[form] = device_ops(step)
    del serving
    expected = {form: f[3] for form, f in forms.items()}
    if counts != expected:
        raise AssertionError(f"decode forms: launch counts per step {counts}, "
                             f"expected {expected}")
    worst = 0.0
    for form, ref in (("fused", "xla"), ("mega", "xla"), ("mega int8 weights", "xla int8 weights")):
        for name, got, want in zip(("hidden", "K column", "V column"), outs[form], outs[ref]):
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"decode forms: {form} {name} {tuple(got.shape)} "
                                     "or non-finite")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            worst = max(worst, rel)
            log(f"[decode] max |{form} - {ref}| / max |{ref}| over the {name}: {rel:.3e}")
    h8, h16 = outs["int8"][0], outs["fused"][0]
    if h8.shape != h16.shape or not torch.isfinite(h8).all():
        raise AssertionError(f"decode forms: int8 hidden {tuple(h8.shape)} or non-finite")
    log(f"[decode] max |int8 - fused| / max |fused| over the hidden: "
        f"{((h8 - h16).abs().max() / h16.abs().max()).item():.3e} (int8 weights and cache; "
        "not bounded)")
    for form, (dev_ms, host_ms) in times.items():
        log(f"[decode] {form} form: {dev_ms:.3f} ms device, {host_ms:.3f} ms host per step; "
            f"launches per step {dict((k, v) for k, v in counts[form].items() if v)}")
    log(f"[decode] device ops per step (torch.profiler): fused {ops['fused']}, mega {ops['mega']}")
    x = h16[:, 0].to(torch.bfloat16)
    # the int8 head issues a few ops a chunk: sleep ~10 ms so the host has queued them
    head_ms = {name: cuda_ms(lambda: lm_logits(tree.llm, cfg.text, x), sleep_cycles=20_000_000)
               for name, tree in (("bf16", params), ("int8", params_q8))}
    log(f"[decode] LM head per step (B = 1, {cfg.padded_vocab_size} rows, L2 flushed): "
        f"bf16 {head_ms['bf16']:.4f} ms, int8 {head_ms['int8']:.4f} ms")
    if worst > E2E_TOL:
        raise AssertionError(f"decode forms differ by {worst:.3e} > {E2E_TOL} of the range")


def phase_main_path(cfg, params, params_q8=None, mega=False, fused_tokens=None):
    """generate at B = 1 on the bench workload: one warm-up and three timed
    runs, launch counts per caption, the vision / prefill / decode split.
    With params_q8 (`quantize_decode_weights(params)`) the int8 path:
    int8 decode weights and `quantize_kv=True`, and the gap of its first
    decode step's logits to the bf16 path's. With mega, GAR_DECODE_PATH=mega
    (a bf16 cache, int8 weights or not), and the first token where the
    greedy output leaves fused_tokens (printed, not bounded: random weights
    make near-ties). Returns (launches per caption, tokens)."""
    from grasp_any_region_tpu_torch.models.gar import (
        encode_images, gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.generate import generate
    from grasp_any_region_tpu_torch.models.llama import lm_logits

    int8 = params_q8 is not None
    run_params = params_q8 if int8 else params
    tag = "[main" + (" mega" if mega else "") + (" int8" if int8 else "") + "]"
    quantize_kv = int8 and not mega
    new_tokens = 256
    batch, plens = bench_batch(cfg, "cuda")
    b, s = batch.input_ids.shape
    log(f"{tag} B={b}, {batch.pixel_values.shape[1]} tiles, prompt {s} tokens, "
        f"{new_tokens} new tokens")

    def run():
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = generate(run_params, cfg, batch, plens, max_new_tokens=new_tokens, eot_id=-1,
                       mask_compat=False, quantize_kv=quantize_kv)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), read_counts()

    depth, steps = cfg.vision.depth, cfg.text.num_layers * (new_tokens - 1)
    dec = (mega_counts(steps, int8) if mega else
           dict(C8=steps, H8=2 * steps, I8=steps, J8=steps) if int8 else
           dict(C=steps, H=2 * steps, I=steps, J=steps))
    expected = expect(B=cfg.text.num_layers, D=depth, E=depth, F=depth, G=depth, **dec)
    path = os.environ.pop("GAR_DECODE_PATH", None)
    if mega:
        os.environ["GAR_DECODE_PATH"] = "mega"
    try:
        run()  # warm-up
        times, counts, out = [], None, None
        for _ in range(3):
            out, ms, counts = run()
            times.append(ms)
            if counts != expected:
                raise AssertionError(f"{tag} launch counts {counts}, expected {expected}")
    finally:
        os.environ.pop("GAR_DECODE_PATH", None)
        if path is not None:
            os.environ["GAR_DECODE_PATH"] = path
    toks = out.tokens
    if toks.shape != (b, new_tokens):
        raise AssertionError(f"{tag} tokens shape {tuple(toks.shape)}")
    if not ((toks >= 0) & (toks < cfg.extended_vocab_size)).all():
        raise AssertionError(f"{tag} a generated token is outside the valid vocab")

    # the split, timed on the same inputs: vision (the tower, projector
    # included), prefill (gar_prefill without the vision part), decode (the rest)
    pix = batch.pixel_values.reshape((-1,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((-1,) + batch.mask_values.shape[2:])
    with torch.inference_mode():
        vision_ms = cuda_ms(lambda: encode_images(run_params, cfg, pix, msk, mask_compat=False),
                            iters=3, warmup=1)
        prefill_total_ms = cuda_ms(
            lambda: gar_prefill(run_params, cfg, batch, mask_compat=False), iters=3, warmup=1)
        hidden, kv = gar_prefill(run_params, cfg, batch, mask_compat=False)
        logits = lm_logits(run_params.llm, cfg.text, hidden[:, -1],
                           valid_vocab=cfg.extended_vocab_size)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} non-finite prefill logits")
        if int8 and not mega:  # the first decode step from the same prefill, int8 against bf16
            tok = logits.argmax(-1).to(torch.int32)
            step = [gar_decode_step(p, cfg, tok, seed_cache_from_prefill(
                cfg, kv, plens, s + 512, quantize_kv=q), s)[0] for p, q in
                ((params_q8, True), (params, False))]
            if not torch.isfinite(step[0]).all():
                raise AssertionError(f"{tag} non-finite decode logits")
            valid = slice(0, cfg.extended_vocab_size)
            gap = ((step[0][:, valid] - step[1][:, valid]).abs().max()
                   / step[1][:, valid].abs().max()).item()
            log(f"{tag} first decode step: max |int8 - bf16| / max |bf16| over the logits "
                f"{gap:.3e}, greedy int8 {int(step[0].argmax())}, bf16 {int(step[1].argmax())} "
                "(not bounded)")
        del hidden, kv
    total_ms = statistics.median(times)
    decode_ms = total_ms - prefill_total_ms
    log(f"{tag} ms/caption {total_ms:.1f} (runs {', '.join(f'{t:.1f}' for t in times)}): "
        f"vision {vision_ms:.1f}, prefill {prefill_total_ms - vision_ms:.1f}, "
        f"decode {decode_ms:.1f}")
    log(f"{tag} decode {b * (new_tokens - 1) / (decode_ms / 1e3):.1f} tok/s; "
        f"{b / (total_ms / 1e3):.3f} captions/s")
    log(f"{tag} launches per caption {dict((k, v) for k, v in counts.items() if v)} "
        f"(every other kernel 0, as expected); first tokens {toks[0, :8].tolist()}")
    if fused_tokens is not None:
        diff = (toks[0] != fused_tokens[0]).nonzero()
        log(f"{tag} greedy tokens leave the fused path's at index "
            f"{int(diff[0]) if len(diff) else 'none (all 256 equal)'} (not bounded)")
    return counts, toks


RUNTIME_NEW_TOKENS = 48
RUNTIME_PAIR_Q = "What is the relation between <Prompt0> and <Prompt1>?"
RUNTIME_VIDEO_Q = "What is the masked object doing?"
# (tile rows after the collate, prompt tokens) of each runtime case at GAR-1B
RUNTIME_SHAPES = {"one region": (17, 4705), "two regions": (17, 4969), "video": (17, 2622)}


def runtime_shapes(name: str) -> tuple:
    """(prompt length, padded prompt length, cache columns) of a runtime
    case: the collate pads the prompt to a multiple of SEQ_BUCKET, and
    generate rounds the cache up to a multiple of 512 columns."""
    from grasp_any_region_tpu_torch.data.builders import SEQ_BUCKET

    plen = RUNTIME_SHAPES[name][1]
    pad = -(-plen // SEQ_BUCKET) * SEQ_BUCKET
    return plen, pad, (pad + RUNTIME_NEW_TOKENS + 511) // 512 * 512


def runtime_attention_rows(rnd) -> dict:
    """Kernels B and C at the runtime cases' shapes (`phase_runtime`), B = 1.
    B: causal over the padded prompt, (1, Sq, 32, 8, 64) with Sq = 4736,
    4992 and 2688 (prompts of 4705, 4969 and 2622 tokens), its output at
    `sized_tol`; library SDPA with is_causal. C (`c_row`): layer 7 of the
    case's (16, 1, 8, S, 64) cache (S = 5120, 5120, 3072), prompt_pad the
    padded prompt, write_pos at the last decode step, at TOL16 with the
    interval probe. Returns {key: {case: figures}}."""
    from grasp_any_region_tpu_torch.ops import flash_attention as fa

    rows = {"B": {}, "C": {}}
    for name in RUNTIME_SHAPES:
        plen, sq, cols = runtime_shapes(name)
        q, k, v = rnd(1, sq, 32, 64), rnd(1, sq, 8, 64), rnd(1, sq, 8, 64)
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
        label = f"B (runtime {name}, Sq = {sq})"
        err = max_err(out, ref, label, **sized_tol(ref))
        r = dict(max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
                 plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                                  iters=3),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
                 **bound(nbytes(q, k, v, out), 4 * 32 * 64 * sq * (sq + 1) // 2))
        rows["B"][name] = r
        log(f"[kernels runtime] {label}, causal (library: SDPA, is_causal): {share_line(r)}; "
            f"plain {r['plain_ms']:.4f} ms; max |kernel - plain| {err:.3e}")
        del q, k, v, out, ref
        wpos = sq + RUNTIME_NEW_TOKENS - 2  # the last decode step's column
        r, lib_gap, args, _ = c_row(rnd, [plen], sq, wpos, cols)
        rows["C"][name] = r
        log(f"[kernels runtime] C ({name}: cache (16, 1, 8, {cols}, 64), prompt_len {plen}, "
            f"prompt_pad {sq}, write_pos {wpos}; library: SDPA, boolean mask, max |library - "
            f"kernel| {lib_gap:.3e}): {share_line(r)}; plain {r['plain_ms']:.4f} ms; max "
            f"|kernel - plain| {r['max_abs_err']:.3e} (TOL16, interval probe)")
        del args
    torch.cuda.empty_cache()
    return rows


def eval_attention_rows(rnd, segment_ids, plens, steps: int) -> dict:
    """Kernels B and C at one eval batch's shapes (`phase_eval`), from its
    segment ids and prompt lengths. B: (B, Sq, 32, 8, 64), every row
    right-padded to Sq with its own prompt length, through `mha`'s
    right-padded dispatch (the causal kernel without the segment mask), one
    launch for the batch; its whole output against the plain causal
    version, and each row's real tokens against the plain version with the
    batch's segment ids, both at `sized_tol`; the plain version runs a row
    at a time (one fp32 (32, Sq, Sq) logit block) and is timed so; the bound
    counts the causal work over the padded rows, the kernel's; library SDPA
    with is_causal. C (`c_row`): layer 7 of the batch's (16, B, 8, S, 64)
    cache, its prompt lengths, prompt_pad Sq, write_pos at the last decode
    step, at TOL16 with the interval probe. Returns {key: figures}."""
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops.attention import mha

    b, sq = segment_ids.shape
    plens = [int(p) for p in plens]
    seg = segment_ids.to("cuda")
    if [int(n) for n in (seg != 0).sum(1)] != plens or len(set(plens)) < 2:
        raise AssertionError(f"[kernels eval] segment ids {seg.shape} and prompt lengths "
                             f"{plens}: expected right padding, rows of differing lengths")
    q, k, v = rnd(b, sq, 32, 64), rnd(b, sq, 8, 64), rnd(b, sq, 8, 64)
    before = fa.launches
    out = mha(q, k, v, causal=True, segment_ids=seg, right_padded=True)
    torch.cuda.synchronize()
    if fa.launches != before + 1:
        raise AssertionError("[kernels eval] the right-padded batch did not take kernel B")
    label = f"B (eval, B = {b}, Sq = {sq}, prompt lengths {plens})"
    err = 0.0
    for i, plen in enumerate(plens):
        row = [x[i:i + 1].float() for x in (q, k, v)]
        ref = fa.flash_attention_plain(*row, causal=True)
        err = max(err, max_err(out[i:i + 1], ref, f"{label} row {i}", **sized_tol(ref)))
        ref = fa.flash_attention_plain(*row, causal=True, segment_ids=seg[i:i + 1])[:, :plen]
        err = max(err, max_err(out[i:i + 1, :plen], ref,
                               f"{label} row {i}, its {plen} real tokens against the "
                               "segment-masked plain version", **sized_tol(ref)))
        del row, ref

    def plain_rows():
        for i in range(b):
            fa.flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)

    r = dict(max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
             plain_ms=cuda_ms(plain_rows, iters=2, warmup=1),
             library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
             **bound(nbytes(q, k, v, out), 4 * 32 * 64 * b * sq * (sq + 1) // 2))
    rows = {"B": r}
    log(f"[kernels eval] {label}, causal (library: SDPA, is_causal): {share_line(r)}; plain "
        f"{r['plain_ms']:.4f} ms (a row at a time); max |kernel - plain| {err:.3e} (sized_tol, "
        "the whole rows and each row's real tokens)")
    del q, k, v, out
    cols = (sq + EVAL_NEW_TOKENS + 511) // 512 * 512
    wpos = sq + steps - 1  # the last decode step's column
    r, lib_gap, args, _ = c_row(rnd, plens, sq, wpos, cols)
    rows["C"] = r
    log(f"[kernels eval] C (cache (16, {b}, 8, {cols}, 64), prompt lengths {plens}, prompt_pad "
        f"{sq}, write_pos {wpos}; library: SDPA, boolean mask, max |library - kernel| "
        f"{lib_gap:.3e}): {share_line(r)}; plain {r['plain_ms']:.4f} ms; max |kernel - plain| "
        f"{r['max_abs_err']:.3e} (TOL16, interval probe)")
    del args
    torch.cuda.empty_cache()
    return rows


def box_mask(h: int, w: int, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def runtime_samples(side: int = 1792, frame_hw=(720, 1280)) -> dict:
    """The runtime phase's requests, from seeded numpy arrays (no image
    files, so no PIL): a side x side RGB image with one mask; the same image
    with two masks and a <Prompt0> / <Prompt1> question; 8 frames with
    masks on frames 0 and 4."""
    from grasp_any_region_tpu_torch.data.builders import RegionSample, VideoRegionSample

    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    m0 = box_mask(side, side, side // 8, side // 2, side // 6, 2 * side // 3)
    m1 = box_mask(side, side, 9 * side // 16, 15 * side // 16, side // 16, side // 2)
    fh, fw = frame_hw
    frames = [rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8) for _ in range(8)]
    fmasks = {0: box_mask(fh, fw, fh // 8, fh // 2, fw // 8, fw // 2),
              4: box_mask(fh, fw, fh // 4, 3 * fh // 4, fw // 3, 5 * fw // 6)}
    return {"one region": [RegionSample(img, {1: m0})],
            "two regions": [RegionSample(img, {0: m0, 1: m1}, question=RUNTIME_PAIR_Q)],
            "video": [VideoRegionSample(frames, fmasks, RUNTIME_VIDEO_Q)]}


def build_case(cfg, samples, device):
    """(batch, prompt_lens) of a runtime case through the port's builders,
    with the synthetic tokenizer, as GARRuntime builds them."""
    from grasp_any_region_tpu_torch.data.builders import (VideoRegionSample, build_region_batch,
                                                          build_video_batch)
    from grasp_any_region_tpu_torch.data.image_processor import (GARImageProcessor,
                                                                 ImageProcessorConfig)
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer

    tok = GARTokenizer.synthetic(cfg.prompt_numbers)
    proc = GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles))
    video = isinstance(samples[0], VideoRegionSample)
    return (build_video_batch if video else build_region_batch)(cfg, tok, proc, samples,
                                                                device=device)


def narrow_case(kind: str):
    """A `phase_cross_check` batch factory: the runtime case `kind` on a
    672 x 672 image (8 frames of 180 x 320) through the builders."""
    return lambda cfg, device: build_case(cfg, runtime_samples(672, (180, 320))[kind], device)


@torch.inference_mode()
def phase_checkpoint_round_trip(cfg):
    """The port's checkpoint writer and reader at the narrow config: every
    leaf back bit for bit, and the same greedy tokens from both trees on a
    builder batch."""
    import tempfile

    from grasp_any_region_tpu_torch.core.weights import load_checkpoint, save_checkpoint
    from grasp_any_region_tpu_torch.models.generate import generate

    params = random_params(cfg, "cuda")
    with torch.no_grad():  # larger projections, so greedy decoding does not repeat one token
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(params.llm.blocks, name).mul_(10.0)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(d, cfg, params)
        t1 = time.perf_counter()
        cfg_back, back = load_checkpoint(d, device="cuda", dtype=torch.bfloat16)
        t2 = time.perf_counter()
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
    if cfg_back != cfg:
        raise AssertionError("[checkpoint] the config read back differs")
    leaves = 0
    for (name, p), (name_b, q) in zip(params.named_parameters(), back.named_parameters()):
        if name != name_b or p.dtype != q.dtype or not torch.equal(p, q):
            raise AssertionError(f"[checkpoint] leaf {name} differs after the round trip")
        leaves += 1
    batch, plens = narrow_case("two regions")(cfg, "cuda")
    toks = [generate(tree, cfg, batch, plens, max_new_tokens=8, eot_id=-1).tokens
            for tree in (params, back)]
    if not torch.equal(*toks):
        raise AssertionError(f"[checkpoint] greedy tokens differ: {toks[0].tolist()} against "
                             f"{toks[1].tolist()}")
    log(f"[checkpoint] narrow config: {leaves} leaves bit-equal after save ({t1 - t0:.2f} s) "
        f"and load ({t2 - t1:.2f} s) of {size / 2**20:.1f} MiB; greedy tokens equal "
        f"{toks[0][0].tolist()}")


@torch.inference_mode()
def phase_runtime(smi: str):
    """The front door: GARRuntime and the host data path. At the narrow
    config, the kernel path against the CPU plain path on builder batches
    (one region, two regions, video with video_mode) and the checkpoint
    round trip; then GAR-1B at full width through
    `GARRuntime.load(random_init=True)` in bf16: one region on a 1792^2
    image, two regions, 8 frames of 1280 x 720 (video), each with its host
    preprocessing ms, caption ms split into prefill and decode, decode
    steps, text length and launches (D = E = F = G = 23, B = 16,
    C = I = J = 16 x steps, H = 2 x 16 x steps, every other kernel 0);
    then the one-region case with int8_serving (J8 = I8 = C = 16 x steps,
    H8 = 2 x 16 x steps). Phase 2 holds B and C at these cases' shapes
    (`runtime_attention_rows`). Returns the figures by case."""
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.data.builders import VideoRegionSample
    from grasp_any_region_tpu_torch.models.gar import gar_prefill

    for kind in ("one region", "two regions", "video"):
        phase_cross_check(narrow_config(), batches=narrow_case(kind), mask_compat=True,
                          video_mode=kind == "video", label=f" builder {kind}")
    phase_checkpoint_round_trip(narrow_config())

    cases = runtime_samples()
    figures = {}
    for int8 in (False, True):
        t0 = time.perf_counter()
        rt = GARRuntime.load(None, "gar_1b", random_init=True, seed=SEED, int8_serving=int8,
                             device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        L, depth = rt.cfg.text.num_layers, rt.cfg.vision.depth
        names = ("one region",) if int8 else tuple(cases)
        for i, name in enumerate(names):
            samples = cases[name]
            video = isinstance(samples[0], VideoRegionSample)
            if i == 0:  # warm-up, through the user's entry point
                (rt.caption_video if video else rt.caption)(samples,
                                                            max_new_tokens=RUNTIME_NEW_TOKENS)
            # caption / caption_video is batch (the host) then answer
            t0 = time.perf_counter()
            batch, plens = rt.batch(samples)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            reset_counts()
            t0 = time.perf_counter()
            texts, out = rt.answer(batch, plens, max_new_tokens=RUNTIME_NEW_TOKENS,
                                   video_mode=video)
            torch.cuda.synchronize()
            caption_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            tag = f"[runtime {name}{' int8' if int8 else ''}]"
            steps = out.steps
            n = L * steps
            dec = dict(C=n, H8=2 * n, I8=n, J8=n) if int8 else dict(C=n, H=2 * n, I=n, J=n)
            want = expect(B=L, D=depth, E=depth, F=depth, G=depth, **dec)
            if counts != want:
                raise AssertionError(f"{tag} launch counts {counts}, expected {want}")
            shape = (batch.pixel_values.shape[1], int(plens[0]))
            padded = runtime_shapes(name)[1]  # the shape phase 2 holds B and C at
            if shape != RUNTIME_SHAPES[name] or batch.input_ids.shape[1] != padded:
                raise AssertionError(f"{tag} {shape[0]} tile rows and a {shape[1]}-token prompt "
                                     f"padded to {batch.input_ids.shape[1]}, expected "
                                     f"{RUNTIME_SHAPES[name]} padded to {padded}")
            ids = out.tokens
            if ids.shape != (1, RUNTIME_NEW_TOKENS) or not (
                    (ids >= 0) & (ids < rt.cfg.extended_vocab_size)).all():
                raise AssertionError(f"{tag} tokens {ids.shape} or outside the valid vocab")
            if len(texts) != 1 or not isinstance(texts[0], str):
                raise AssertionError(f"{tag} no text")
            prefill_ms = cuda_ms(lambda: gar_prefill(rt.params, rt.cfg, batch, video_mode=video),
                                 iters=3, warmup=1)
            del batch
            figures[tag] = dict(host_ms=host_ms, caption_ms=caption_ms, prefill_ms=prefill_ms,
                                decode_ms=caption_ms - prefill_ms, steps=steps,
                                text_len=len(texts[0]), prompt=shape[1], tiles=shape[0])
            f = figures[tag]
            log(f"{tag} {smi}: {f['tiles']} tile rows, prompt {f['prompt']} tokens; host "
                f"preprocessing {host_ms:.1f} ms (builder and collate); caption "
                f"{caption_ms:.1f} ms = prefill {prefill_ms:.1f} + decode {f['decode_ms']:.1f} "
                f"({steps} decode steps, {f['decode_ms'] / max(steps, 1):.2f} ms a step); "
                f"text {f['text_len']} characters; launches "
                f"{dict((k, v) for k, v in counts.items() if v)} (every other kernel 0)")
        log(f"[runtime{' int8' if int8 else ''}] GARRuntime.load(gar_1b, random_init) "
            f"{load_s:.1f} s")
        del rt
        torch.cuda.empty_cache()
    return figures


EVAL_NEW_TOKENS = 32
EVAL_BATCH = 8
# 16 items: VQA's 9 make two batches of 8, the second a padded chunk of one
EVAL_ITEMS = dict(n_vqa=9, n_detailed=2, n_dlc=2, n_ferret=1, n_mdvp=2)
EVAL_TASKS = (("garbench-vqa", "garbench_vqa", "images", "n_vqa"),  # (task, annotations,
              ("garbench-detailed", "garbench_detailed", "images", "n_detailed"),  # images, items)
              ("dlc", "dlc", "dlc_root", "n_dlc"), ("ferret", "ferret", "images", "n_ferret"),
              ("mdvp", "mdvp", "images", "n_mdvp"))
EVAL_KEYS = ("B", "C", "D", "E", "F", "G", "H", "I", "J")
EVAL_PATH = f"cli.eval (BatchedCaptioner, batch {EVAL_BATCH}, {EVAL_NEW_TOKENS} tokens)"
PARITY_KEYS = ("H8", "I8", "J8")
PARITY_PATH = "cli.parity check (c): the int8 repeat (serving_weights)"
KERNEL_SYMBOLS = {"flash_fwd_sm90_kernel": "B", "decode_split_kernel": "C"}


def eval_launches(cfg, batches) -> dict:
    """Launches of an eval run: each batch one fused tower pass (D-G a
    block), one prefill (B a layer) and its decode steps (C, I, J a layer,
    H twice a layer)."""
    L, depth, n = cfg.text.num_layers, cfg.vision.depth, len(batches)
    steps = sum(b["steps"] for b in batches)
    return expect(B=L * n, D=depth * n, E=depth * n, F=depth * n, G=depth * n,
                  C=L * steps, I=L * steps, J=L * steps, H=2 * L * steps)


def parity_launches(cfg, steps: int) -> dict:
    """Launches of `cli.parity.main` with a demo pair, the int8 repeat and
    the speculative probe, every caption of `steps` decode steps: (a) the
    bf16 caption, (c) the int8 caption (J8, I8, H8 with C on the bf16
    cache), (e) generate and generate_speculative (no decode kernel), (d)
    the taps: kernel A a block (the unfused `_block` loop), the fused tower
    twice (`vision_forward`, `build_prefill_embeds`) and one prefill."""
    L, depth = cfg.text.num_layers, cfg.vision.depth
    n = L * steps
    return expect(A=depth, B=5 * L, D=6 * depth, E=6 * depth, F=6 * depth, G=6 * depth,
                  C=3 * n, I=2 * n, J=2 * n, H=4 * n, J8=n, I8=n, H8=2 * n)


def tap_shapes(cfg, tiles: int, seq: int) -> dict:
    """The shapes of `cli.parity.activation_checksums`' taps."""
    v, t = cfg.vision, cfg.text
    shapes = {"mask_patch_embed": [tiles, v.num_patches, v.width],
              "vision_patch_embed": [tiles, v.seq_len, v.width]}
    for i in sorted({0, v.depth // 2, v.depth - 1}):
        shapes[f"vision_block{i}"] = [tiles, v.seq_len, v.width]
    shapes.update(vision_final=[tiles, v.seq_len, v.width],
                  projector=[tiles, cfg.tokens_per_tile, t.hidden_size],
                  prefill_embeds=[1, seq, t.hidden_size], decoder_final=[1, seq, t.hidden_size])
    return shapes


def kernel_profile(path: str, steps: int, top: int = 10) -> dict:
    """The kernels of a traced caption (`utils.profiling.trace_kernels`): the
    `top` that took the most device time, the kernels and device time of the
    tower ("vision"), the rest of the prefill and a decode step, and the
    `top` kernels of a decode step by launches."""
    from grasp_any_region_tpu_torch.utils.profiling import trace_kernels

    kernels = trace_kernels(path)
    if not kernels:
        raise AssertionError("[profile] the trace holds no device kernel (CUPTI saw nothing)")
    by_name = {}
    for k in kernels:
        n, us = by_name.get(k["name"], (0, 0.0))
        by_name[k["name"]] = (n + 1, us + k["us"])
    parts = {"vision": [k for k in kernels if "vision" in k["ranges"]],
             "prefill": [k for k in kernels if "prefill" in k["ranges"]
                         and "vision" not in k["ranges"]],
             "decode": [k for k in kernels if "decode" in k["ranges"]]}
    named = {key: {part: sum(sym in k["name"] for k in ks) for part, ks in parts.items()}
             for sym, key in KERNEL_SYMBOLS.items()}
    step = {}
    for k in parts["decode"]:
        n, us = step.get(k["name"], (0, 0.0))
        step[k["name"]] = (n + 1, us + k["us"])
    step = {name: (n / max(steps, 1), us / max(steps, 1)) for name, (n, us) in step.items()}
    return dict(top=sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top],
                step_top=sorted(step.items(), key=lambda kv: -kv[1][0])[:top],
                total_ms=sum(k["us"] for k in kernels) / 1e3, count=len(kernels),
                parts={part: (len(ks), sum(k["us"] for k in ks) / 1e3)
                       for part, ks in parts.items()},
                per_step=len(parts["decode"]) / max(steps, 1),
                step_ms=sum(k["us"] for k in parts["decode"]) / 1e3 / max(steps, 1),
                named=named)


@torch.inference_mode()
def phase_eval(smi: str) -> dict:
    """Benchmarks and the parity check at GAR-1B (bf16, random init) on
    synthetic benchmark files (`evaluation/synthetic.py`: PNG images of 1344
    x 1008 and 1792^2, the four annotation formats): `cli.eval.main` for
    garbench-vqa, garbench-detailed, dlc, ferret and mdvp at batch 8 and 32
    tokens (16 items; VQA's second chunk padded), each with items/s, host
    preprocessing ms an item, generate ms a batch and its launches (exactly
    `eval_launches`); the VQA output scored with `score_vqa`; the eval's
    weights with a random mask_embed written as parity's checkpoint; then,
    on decoder projections x10 (so greedy tokens vary), one batch's prefill
    (timed alone) and decode ms, and its tokens against the same items
    captioned one at a time (printed, not bounded: greedy bf16 across batch
    buckets), and against the same items in reverse order (the same
    shapes: rows equal unless they leak into each other); kernels B and C
    at that batch's shapes against their plain versions
    (`eval_attention_rows`); `cli.parity.main` on the checkpoint and a PNG
    demo pair (rc 1: the demo caption differs at random weights; the
    speculative check exact; the int8 repeat ran; taps finite, non-zero and
    at their shapes; launches exactly `parity_launches`); one 16-token
    caption under `utils.profiling.trace` (the top kernels, the kernels of
    a decode step, B in the prefill and C in the decode ranges, the memory
    stats);
    `cli.warmup.main` (build and first-caption seconds); `gar_with_mask.main`
    on PNG files (read with `data/png.py`: PIL stays unimported). Returns the
    figures, with the launches over all eval batches, each batch's decode
    steps, the B and C rows and parity's launches."""
    import contextlib
    import io
    import tempfile

    from grasp_any_region_tpu_torch.cli import eval as eval_cli
    from grasp_any_region_tpu_torch.cli import gar_with_mask, parity, warmup
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.data.builders import RegionSample
    from grasp_any_region_tpu_torch.core.weights import save_checkpoint
    from grasp_any_region_tpu_torch.data.png import write_png
    from grasp_any_region_tpu_torch.evaluation.garbench import item_to_sample, score_vqa
    from grasp_any_region_tpu_torch.evaluation.synthetic import write_benchmark_files
    from grasp_any_region_tpu_torch.models.gar import gar_prefill
    from grasp_any_region_tpu_torch.utils.profiling import device_memory_stats, trace

    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = write_benchmark_files(os.path.join(tmp, "bench"), seed=SEED, **EVAL_ITEMS)
        log(f"[eval] synthetic benchmark files ({sum(EVAL_ITEMS.values())} items, PNG images of "
            f"1344 x 1008 and 1792^2) written in {time.perf_counter() - t0:.1f} s")
        total, steps = dict.fromkeys(KERNELS, 0), []
        for task, anno, img, n_items in EVAL_TASKS:
            out = os.path.join(tmp, "out", f"{task}.json")
            reset_counts()
            t0 = time.perf_counter()
            cap = eval_cli.main([task, "--anno", files[anno], "--images", files[img], "--out", out,
                                 "--random-init", "--batch-size", str(EVAL_BATCH),
                                 "--max-new-tokens", str(EVAL_NEW_TOKENS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, want = read_counts(), eval_launches(cap.rt.cfg, cap.batches)
            tag = f"[eval {task}]"
            if counts != want:
                raise AssertionError(f"{tag} launch counts {counts}, expected {want}")
            with open(out) as f:
                results = json.load(f)
            items = sum(b["items"] for b in cap.batches)
            built = items + sum(b["pad"] for b in cap.batches)
            if len(results) != items or items != EVAL_ITEMS[n_items]:
                raise AssertionError(f"{tag} {len(results)} records for {items} items")
            summ = cap.timer.summary()
            host_s, gen_s = summ["batch"]["total_s"], summ["answer"]["total_s"]
            f = dict(items=items, batches=len(cap.batches), pads=built - items,
                     items_per_s=items / (host_s + gen_s), wall_s=wall,
                     host_ms_per_item=host_s * 1e3 / built,
                     generate_ms_per_batch=gen_s * 1e3 / len(cap.batches),
                     steps=[b["steps"] for b in cap.batches])
            figures[task] = f
            for key in KERNELS:
                total[key] += counts[key]
            steps += f["steps"]
            log(f"{tag} {smi}: {items} items in {f['batches']} batch(es) of {EVAL_BATCH} "
                f"({f['pads']} padded rows): {f['items_per_s']:.3f} items/s (host + generate; "
                f"{wall:.1f} s with GARRuntime.load); host preprocessing {f['host_ms_per_item']:.1f} "
                f"ms an item; generate {f['generate_ms_per_batch']:.1f} ms a batch, decode steps "
                f"{f['steps']}; launches {dict((k, v) for k, v in counts.items() if v)} (every "
                f"other kernel 0)")
            if task == "garbench-vqa":
                log(f"{tag} score_vqa: {json.dumps(score_vqa(results))}")
        log(f"[eval] launches over the {len(steps)} eval batches (decode steps {steps}): "
            f"{dict((k, v) for k, v in total.items() if v)}")

        # the parity checkpoint: the eval's weights with a random mask_embed
        # (zero at init, which would leave the mask path and its tap idle)
        rt, cfg = cap.rt, cap.rt.cfg
        with torch.no_grad():
            rt.params.mask_embed.kernel.normal_(0.0, 0.02, generator=torch.Generator(
                device="cuda").manual_seed(SEED))
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        save_checkpoint(ckpt, cfg, rt.params)
        save_s = time.perf_counter() - t0

        # one eval batch split into prefill and decode, and against one at a
        # time, on larger decoder projections (greedy decoding at random init
        # repeats one token, which agrees whatever the batching)
        with torch.no_grad():
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                getattr(rt.params.llm.blocks, name).mul_(10.0)
        with open(files["garbench_vqa"]) as f:
            items = json.load(f)[:EVAL_BATCH]
        samples = [item_to_sample(it, files["images"], "vqa") for it in items]
        t0 = time.perf_counter()
        batch, plens = rt.batch(samples)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, res = rt.answer(batch, plens, max_new_tokens=EVAL_NEW_TOKENS)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        prefill_ms = cuda_ms(lambda: gar_prefill(rt.params, rt.cfg, batch), iters=3, warmup=1)
        agree = []
        for i, sample in enumerate(samples):
            _, one = rt.answer(*rt.batch([sample]), max_new_tokens=EVAL_NEW_TOKENS)
            a, b = res.tokens[i].cpu(), one.tokens[0].cpu()
            agree.append((int((a == b).sum()), first_difference(a.tolist(), b.tolist())))
        distinct = [len(set(t.tolist())) for t in res.tokens.cpu()]
        # the same 8 items in reverse order: the same kernels at the same
        # shapes, so a row's tokens move with it unless rows leak into each other
        _, rev = rt.answer(*rt.batch(samples[::-1]), max_new_tokens=EVAL_NEW_TOKENS)
        reordered = sum(bool(torch.equal(a, b)) for a, b in zip(res.tokens, rev.tokens.flip(0)))
        figures["batch"] = dict(host_ms=host_ms, batch_ms=batch_ms, prefill_ms=prefill_ms,
                                decode_ms=batch_ms - prefill_ms, steps=res.steps,
                                distinct=distinct, agree=agree, reordered=reordered)
        log(f"[eval batch] {smi}: {len(samples)} VQA items, {batch.pixel_values.shape[1]} tile "
            f"rows, prompts padded to {batch.input_ids.shape[1]} tokens: host {host_ms:.1f} ms; "
            f"generate {batch_ms:.1f} ms = prefill {prefill_ms:.1f} (timed alone) + decode "
            f"{batch_ms - prefill_ms:.1f} ({res.steps} steps, "
            f"{(batch_ms - prefill_ms) / max(res.steps, 1):.2f} ms a step); decoder "
            f"projections x10: distinct tokens a row {distinct}; tokens that agree with the "
            f"same item captioned alone (of {EVAL_NEW_TOKENS}; first difference): {agree}; rows "
            f"equal to their tokens in the reversed batch: {reordered} of {len(samples)} "
            "(printed, not bounded)")
        # kernels B and C at this batch's shapes against their plain versions
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        figures["rows"] = eval_attention_rows(
            lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16),
            batch.segment_ids, plens.tolist(), res.steps)
        del batch, res

        # parity on the written checkpoint and a PNG demo pair
        demo = np.asarray(samples[0].image)
        demo_mask = next(iter(samples[0].masks.values()))
        with open(os.path.join(tmp, "demo.png"), "wb") as f:
            f.write(write_png(demo))
        with open(os.path.join(tmp, "demo_mask.png"), "wb") as f:
            f.write(write_png(demo_mask.astype(np.uint8) * 255))
        demo_batch, _ = rt.batch([RegionSample(demo, {1: demo_mask},
                                                instruction=parity.DEMO_INSTRUCTION)])
        tiles, seq = demo_batch.pixel_values.shape[1], demo_batch.input_ids.shape[1]
        del rt, cap, demo_batch
        torch.cuda.empty_cache()
        dump = os.path.join(tmp, "taps.json")
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = parity.main(["--model-path", ckpt, "--reference-root", os.path.join(tmp, "none"),
                              "--demo-image", os.path.join(tmp, "demo.png"),
                              "--demo-mask", os.path.join(tmp, "demo_mask.png"),
                              "--max-new-tokens", str(EVAL_NEW_TOKENS), "--speculative", "4,4",
                              "--dump-checksums", dump])
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t0
        parity_counts = read_counts()
        results = {r["check"]: r for r in json.loads(buf.getvalue())["results"]}
        if rc != 1 or list(results) != ["demo_caption", "demo_caption_int8", "speculative"]:
            raise AssertionError(f"[parity] rc {rc}, checks {list(results)}: expected rc 1 from "
                                 "demo_caption, demo_caption_int8 and speculative")
        if results["demo_caption"]["ok"] or not results["speculative"]["ok"]:
            raise AssertionError(f"[parity] {results}: the random-weight demo caption must "
                                 "differ and the speculative check must be exact")
        want = parity_launches(cfg, EVAL_NEW_TOKENS - 1)
        if parity_counts != want:
            raise AssertionError(f"[parity] launch counts {parity_counts}, expected {want}")
        with open(dump) as f:
            taps = json.load(f)
        shapes = tap_shapes(cfg, tiles, seq)
        got_shapes = {k: v["shape"] for k, v in taps.items()}
        if got_shapes != shapes or not all(
                np.isfinite([v["mean"], v["std"], v["abs_sum"]]).all() and v["abs_sum"] > 0
                for v in taps.values()):
            raise AssertionError(f"[parity] taps {got_shapes} (expected {shapes}), not finite "
                                 "or all zero")
        spec = results["speculative"]
        figures["parity"] = dict(rc=rc, seconds=parity_s, save_s=save_s,
                                 counts={k: parity_counts[k] for k in PARITY_KEYS})
        log(f"[parity] {smi}: save_checkpoint {save_s:.1f} s; cli.parity.main {parity_s:.1f} s, "
            f"rc {rc} (the demo caption differs at random weights; the int8 repeat ran, its "
            f"caption matches: {results['demo_caption_int8']['ok']}); speculative gamma "
            f"{spec['gamma']}, K {spec['draft_layers']} exact, accept {spec['accept_rate']:.3f} "
            f"against break-even {spec['break_even']:.3f}; taps "
            + ", ".join(f"{k} {v['shape']} std {v['std']:.4g}" for k, v in taps.items())
            + f"; launches {dict((k, v) for k, v in parity_counts.items() if v)}")

        # one 16-token caption under the profiler
        rt = GARRuntime.load(None, "gar_1b", random_init=True, seed=SEED, device="cuda")
        sample = samples[0]
        rt.caption([sample], max_new_tokens=16)
        with trace(os.path.join(tmp, "trace")) as prof:
            _, out = rt.answer(*rt.batch([sample]), max_new_tokens=16)
            torch.cuda.synchronize()
        prof_fig = kernel_profile(prof.trace_file, out.steps)
        L = rt.cfg.text.num_layers
        named = prof_fig["named"]
        if named["B"]["prefill"] != L or named["C"]["decode"] != L * out.steps:
            raise AssertionError(f"[profile] kernel events {named}: expected B = {L} in the "
                                 f"prefill and C = {L} x {out.steps} in the decode range")
        figures["profile"] = dict(prof_fig, mem=device_memory_stats())
        log(f"[profile] {smi}: one caption of 16 tokens ({out.steps} decode steps): "
            f"{prof_fig['count']} kernel events, {prof_fig['total_ms']:.2f} ms of device time; "
            + "; ".join(f"{part} {n} kernels {ms:.2f} ms" for part, (n, ms)
                        in prof_fig["parts"].items())
            + f"; a decode step {prof_fig['per_step']:.1f} kernels, {prof_fig['step_ms']:.3f} ms "
            f"of device; B, C by range {named}")
        for name, (n, us) in prof_fig["top"]:
            log(f"[profile top] {us / 1e3:9.3f} ms {n:6d} x  {name[:110]}")
        for name, (n, us) in prof_fig["step_top"]:
            log(f"[profile step] {n:6.1f} x {us:9.2f} us a decode step  {name[:110]}")
        log(f"[profile] device_memory_stats: {device_memory_stats()}")
        del rt
        torch.cuda.empty_cache()

        # the warmup CLI and the PNG CLI
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            figures["warmup"] = warmup.main(["--grids", "4x4", "--max-new-tokens",
                                             str(EVAL_NEW_TOKENS)])
        log(f"[warmup] {smi}: {figures['warmup']} ({err.getvalue().count('[warmup]')} lines)")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            gar_with_mask.main(["--preset", "gar_1b", "--random-init", "--max-new-tokens", "16",
                                "--image", os.path.join(tmp, "demo.png"),
                                "--mask", os.path.join(tmp, "demo_mask.png")])
        lines = buf.getvalue().splitlines()
        if not lines or lines[0] != f"=== {os.path.join(tmp, 'demo.png')} ===" \
                or "PIL" in sys.modules:
            raise AssertionError(f"[png cli] output {lines[:2]} or PIL imported")
        log(f"[png cli] gar_with_mask.main on PNG files ({demo.shape[1]} x {demo.shape[0]}): "
            f"{time.perf_counter() - t0:.1f} s, {len(lines)} lines, PIL never imported")
    torch.cuda.empty_cache()
    figures.update(launches=total, steps=steps, parity_counts=figures["parity"]["counts"])
    return figures


SAM_SMALL = dict(img_size=256, patch_size=16, embed_dim=64, depth=2, num_heads=2, window_size=14,
                 global_attn_indexes=(1,), out_chans=64, decoder_mlp_dim=128)
SAM_TOL = 1e-4  # rtol, and atol as a share of the output's range: fp32 on both sides
SAM_SIDE = 1792  # the seeded image's side (phase_runtime's one-region image)
SPEC = (4, 4)  # (gamma, draft_layers): JAX's defaults


def sam_close(got: torch.Tensor, ref: torch.Tensor, name: str) -> float:
    """got (the card) within SAM_TOL of ref (the CPU): rtol SAM_TOL and atol
    SAM_TOL x max |ref|; returns max |got - ref| / max |ref|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item()
    rel = (got - ref).abs().max().item() / scale
    if got.shape != ref.shape or not torch.isfinite(got).all() or not torch.allclose(
            got, ref, rtol=SAM_TOL, atol=SAM_TOL * scale):
        raise AssertionError(f"[sam] {name}: card and CPU differ, max |diff| / max |cpu| "
                             f"{rel:.3e} (rtol {SAM_TOL}, atol {SAM_TOL} x {scale:.3e})")
    return rel


def sam_prompts(side: int) -> dict:
    """A point prompt and a box prompt on a side x side image (pixels)."""
    return {"point": dict(points=[(side / 2, side / 2)], point_labels=[1]),
            "box": dict(box=(side / 6, side / 8, 2 * side / 3, side / 2))}


@torch.inference_mode()
def phase_sam_cross_check():
    """The small SAM config of tests/test_torch_sam.py (grid 16, window 14)
    on the card against the CPU, the same seeded fp32 weights and inputs:
    `encode_image` and `decode_masks` within SAM_TOL."""
    from grasp_any_region_tpu_torch.sam import model as sm

    cfg = sm.SAMConfig(**SAM_SMALL)
    p_cpu = sm.init_sam_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    rng = np.random.default_rng(SEED)
    pix = torch.from_numpy(rng.standard_normal((2, 3, 256, 256)).astype(np.float32))
    pts = torch.tensor([[[0.3, 0.4], [0.8, 0.1], [0.2, 0.3], [0.7, 0.6]]] * 2)
    labs = torch.tensor([[1, 0, 2, 3]] * 2, dtype=torch.int32)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        emb = sm.encode_image(p, cfg, pix.to(dev))
        masks, iou = sm.decode_masks(p, cfg, emb, sm.encode_points(p, pts.to(dev), labs.to(dev)))
        out[dev] = (emb, masks, iou)
    errs = [sam_close(a, b, name) for a, b, name in zip(
        out["cuda"], out["cpu"], ("encode_image", "decode_masks masks", "decode_masks iou"))]
    log(f"[sam cross-check] small config (grid 16, window 14, 2 blocks, 1 global), fp32: "
        f"encode_image {errs[0]:.3e}, decode_masks masks {errs[1]:.3e}, iou {errs[2]:.3e} of "
        f"the CPU's range (<= {SAM_TOL}); matmul precision "
        f"{torch.get_float32_matmul_precision()}, allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")


@torch.inference_mode()
def phase_sam_vit_h(smi: str):
    """SAM ViT-H at full width on the card: seeded fp32 weights, one
    SAM_SIDE² image. Blocks 0 (windowed) and 7 (global) held against the
    same block on the CPU from the card's input; the stages timed; a point
    and a box prompt give non-empty masks; no port kernel launches.
    Returns (the predictor, the image, its figures)."""
    from grasp_any_region_tpu_torch.sam import model as sm
    from grasp_any_region_tpu_torch.sam import pipeline as sp

    cfg = sm.sam_vit_h()
    t0 = time.perf_counter()
    params = sm.init_sam_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pred = sp.SamPredictor(params=params, cfg=cfg)
    if not pred.has_model:
        raise AssertionError("[sam] the ViT-H predictor has no model")
    n_params = sum(p.numel() for p in params.parameters())
    image = np.random.default_rng(SEED).integers(0, 256, (SAM_SIDE, SAM_SIDE, 3), dtype=np.uint8)
    reset_counts()
    t0 = time.perf_counter()
    pix, scale, shp = sp.preprocess_sam(image, cfg.img_size)
    pre_ms = (time.perf_counter() - t0) * 1e3
    pixels = torch.from_numpy(pix).cuda()

    # blocks 0 and 7 against the CPU, on the card's inputs
    enc = params["encoder"]
    b, p, g = 1, cfg.patch_size, cfg.grid
    x = pixels.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g, g, 3 * p * p)
    x = x @ enc["patch_embed"]["kernel"] + enc["patch_embed"]["bias"] + enc["pos_embed"]
    errs = {}
    for i in range(8):
        glob = i in cfg.global_attn_indexes
        y = sm.encoder_block(enc["blocks"][i], cfg, x, glob)
        if i in (0, 7):
            bp_cpu = copy.deepcopy(enc["blocks"][i]).to("cpu")
            t1 = time.perf_counter()
            ref = sm.encoder_block(bp_cpu, cfg, x.cpu(), glob)
            cpu_s = time.perf_counter() - t1
            errs[i] = (sam_close(y, ref, f"block {i}"), cpu_s)
            del bp_cpu, ref
        x = y
    del x, y

    # the stages: encoder, prompt + decoder, postprocess
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    enc_ms = cuda_ms(lambda: sm.encode_image(params, cfg, pixels), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    emb = sm.encode_image(params, cfg, pixels)
    prompt = sam_prompts(SAM_SIDE)["point"]
    pts = torch.tensor([[[x * scale / cfg.img_size, y * scale / cfg.img_size]
                         for x, y in prompt["points"]]], device="cuda")
    labs = torch.tensor([prompt["point_labels"]], dtype=torch.int32, device="cuda")
    dec_ms = cuda_ms(lambda: sm.decode_masks(params, cfg, emb, sm.encode_points(params, pts, labs)),
                     iters=5, warmup=1)
    masks, iou = sm.decode_masks(params, cfg, emb, sm.encode_points(params, pts, labs))
    best = int(torch.argmax(iou[0, 1:])) + 1
    logits = masks[0, best].float().cpu().numpy()
    t0 = time.perf_counter()
    sp.postprocess_mask(logits, shp, image.shape[:2], cfg.img_size)
    post_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(emb).all() or emb.shape != (1, 256, 64, 64):
        raise AssertionError(f"[sam] embedding {tuple(emb.shape)} or not finite")
    t0 = time.perf_counter()
    pred._embedding(image)  # the predictor's first look: preprocess_sam and the encoder
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    areas = {}
    for name, kw in sam_prompts(SAM_SIDE).items():
        t0 = time.perf_counter()
        mask = pred.predict(image, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        if mask.shape != image.shape[:2] or mask.sum() == 0:
            raise AssertionError(f"[sam] the {name} prompt gave an empty mask")
        areas[name] = (int(mask.sum()), ms)
    torch.cuda.synchronize()
    if read_counts() != expect():
        raise AssertionError(f"[sam] SAM launched port kernels: {read_counts()}")
    figures = dict(preprocess_ms=pre_ms, encoder_ms=enc_ms, decoder_ms=dec_ms,
                   postprocess_ms=post_ms, peak_gib=peak / 2**30,
                   encoder_extra_gib=(peak - base) / 2**30, embedding_ms=first_ms, areas=areas,
                   block_errs=errs)
    log(f"[sam vit-h] {smi}: {n_params / 1e6:.1f} M fp32 parameters (init {init_s:.1f} s), one "
        f"{SAM_SIDE}² image; preprocess_sam {pre_ms:.1f} ms (host), encoder {enc_ms:.2f} ms, "
        f"prompt encoder + mask decoder {dec_ms:.3f} ms, postprocess_mask {post_ms:.1f} ms (host); "
        f"peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over the weights and "
        f"inputs); block 0 (windowed) {errs[0][0]:.3e}, block 7 (global) {errs[7][0]:.3e} of "
        f"the CPU's range (<= {SAM_TOL}; CPU {errs[0][1]:.1f} / {errs[7][1]:.1f} s); the "
        f"predictor's embedding (preprocess_sam + encoder) {first_ms:.1f} ms, then on it: "
        + ", ".join(f"{k} prompt {a} px ({a / image.shape[0] / image.shape[1]:.1%}), predict "
                    f"{ms:.1f} ms" for k, (a, ms) in areas.items())
        + "; launches: none (every counter 0)")
    return pred, image, figures


@contextlib.contextmanager
def patched(*triples):
    """Set (object, attribute, value) for the block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, value in triples:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def first_difference(a, b) -> str:
    a, b = list(a), list(b)
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return "none" if i is None else str(i)


@torch.inference_mode()
def phase_spec_narrow_fp32():
    """The narrow gar_1b at fp32 on the card: `generate_speculative` against
    `generate`'s XLA form, token for token. The prefill's kernels (B, D-G)
    and the decode step's attention (C) take bf16 only, so here the prefill
    runs on the CPU (the plain path, the same weights) and the decode
    attention is the plain version on the card; the products are cuBLAS
    fp32 on both paths."""
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.models import gar, generate as gen_mod, llama
    from grasp_any_region_tpu_torch.models import speculative as spec_mod
    from grasp_any_region_tpu_torch.ops.decode_attention import decode_attention_fused_plain

    cfg = narrow_config()
    p_cpu = init_gar_params(cfg, torch.Generator().manual_seed(SEED), device="cpu",
                            dtype=torch.float32)
    with torch.no_grad():
        p_cpu.mask_embed.kernel.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(p_cpu.llm.blocks, name).mul_(10.0)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    batch, plens = narrow_case("one region")(cfg, "cuda")

    def cpu_prefill(params, cfg_, batch_, **kw):
        hidden, (k, v) = gar.gar_prefill(p_cpu, cfg_, gar.map_batch(lambda t: t.cpu(), batch_),
                                         **kw)
        return hidden.cuda(), (k.cuda(), v.cuda())

    xla_step = functools.partial(gar.gar_decode_step, use_kernel=False)
    reset_counts()
    with patched((gen_mod, "gar_prefill", cpu_prefill), (spec_mod, "gar_prefill", cpu_prefill),
                 (gen_mod, "gar_decode_step", xla_step),
                 (llama, "decode_attention_fused", decode_attention_fused_plain)):
        ref = gen_mod.generate(p_gpu, cfg, batch, plens, max_new_tokens=24, eot_id=-1,
                               compute_dtype=torch.float32)
        outs = {gk: spec_mod.generate_speculative(
                    p_gpu, cfg, batch, plens, max_new_tokens=24, gamma=gk[0], draft_layers=gk[1],
                    eot_id=-1, compute_dtype=torch.float32) for gk in ((4, 1), (3, 2))}
    torch.cuda.synchronize()
    if read_counts() != expect():
        raise AssertionError(f"[spec narrow fp32] kernels launched: {read_counts()}")
    for gk, out in outs.items():
        if not torch.equal(out.tokens, ref.tokens):
            raise AssertionError(f"[spec narrow fp32] gamma, draft_layers {gk}: tokens "
                                 f"{out.tokens.tolist()} against generate's XLA form "
                                 f"{ref.tokens.tolist()}")
    log("[spec narrow fp32] narrow gar_1b, fp32 on the card (prefill on the CPU, plain decode "
        "attention): generate_speculative's 24 tokens equal generate's XLA form at (gamma, "
        "draft_layers) " + ", ".join(f"{gk}: {o.stats.rounds} rounds, {o.stats.accepted} / "
                                      f"{o.stats.drafted} accepted" for gk, o in outs.items())
        + f"; tokens {ref.tokens[0].tolist()}")


@torch.inference_mode()
def phase_sam_speculative(smi: str) -> dict:
    """Point and box prompts to captions, and self-speculative decoding, at
    full width (SAM ViT-H, GAR-1B): the SAM cross-check at the small
    config; ViT-H (`phase_sam_vit_h`); the caption of the point prompt's
    mask through `GARServer.describe_array` over `GARRuntime.load(gar_1b,
    random_init)` and the ViT-H predictor (launches D = E = F = G = 23,
    B = 16, C = I = J = 16 x steps, H = 32 x steps); then
    `GARRuntime.caption(speculative=(4, 4))` on phase_runtime's one-region
    case (launches D-G = 23, B = 16, no decode kernel), its first round's
    verify logits at row 0 held to one XLA-form decode step, its host syncs
    counted, its tokens' first departure from generate's fused and XLA
    forms printed; then the mechanism's bound (wo and w_down zeroed past the
    draft depth: the draft is the whole model), timed against generate on
    the same weights; last the narrow fp32 token check
    (`phase_spec_narrow_fp32`). Returns the figures."""
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.models import generate as gen_mod
    from grasp_any_region_tpu_torch.models.gar import (gar_decode_step, gar_prefill,
                                                       seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.models.speculative import _forward_chunk
    from grasp_any_region_tpu_torch.serve.server import GARServer

    t_phase = time.perf_counter()
    phase_sam_cross_check()
    pred, image, figures = phase_sam_vit_h(smi)

    # the caption of the point prompt's mask, through the server's body
    rt = GARRuntime.load(None, "gar_1b", random_init=True, seed=SEED, device="cuda")
    L, depth = rt.cfg.text.num_layers, rt.cfg.vision.depth
    srv = GARServer(rt, pred, max_new_tokens=RUNTIME_NEW_TOKENS)
    req = {"points": [list(sam_prompts(SAM_SIDE)["point"]["points"][0])]}
    srv.describe_array(image, req)  # warm-up
    seen = {}
    batch_fn, answer_fn = rt.batch, rt.answer

    def timed_batch(samples):
        t0 = time.perf_counter()
        out = batch_fn(samples)
        torch.cuda.synchronize()
        seen["host_ms"] = (time.perf_counter() - t0) * 1e3
        seen["batch"] = out
        return out

    def timed_answer(*a, **k):
        t0 = time.perf_counter()
        out = answer_fn(*a, **k)
        torch.cuda.synchronize()
        seen["caption_ms"] = (time.perf_counter() - t0) * 1e3
        seen["result"] = out[1]
        return out

    reset_counts()
    t0 = time.perf_counter()
    with patched((rt, "batch", timed_batch), (rt, "answer", timed_answer)):
        reply = srv.describe_array(image, req)
    torch.cuda.synchronize()
    describe_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    steps = seen["result"].steps
    n = L * steps
    want = expect(B=L, D=depth, E=depth, F=depth, G=depth, C=n, H=2 * n, I=n, J=n)
    if counts != want:
        raise AssertionError(f"[sam caption] launch counts {counts}, expected {want}")
    if not isinstance(reply.get("text"), str) or seen["result"].tokens.shape != (
            1, RUNTIME_NEW_TOKENS):
        raise AssertionError(f"[sam caption] reply {reply}")
    batch, plens = seen["batch"]
    prefill_ms = cuda_ms(lambda: gar_prefill(rt.params, rt.cfg, batch), iters=3, warmup=1)
    sam_ms = describe_ms - seen["host_ms"] - seen["caption_ms"]
    figures["caption"] = dict(describe_ms=describe_ms, sam_ms=sam_ms, host_ms=seen["host_ms"],
                              caption_ms=seen["caption_ms"], prefill_ms=prefill_ms,
                              decode_ms=seen["caption_ms"] - prefill_ms, steps=steps,
                              prompt=int(plens[0]), tiles=batch.pixel_values.shape[1])
    f = figures["caption"]
    log(f"[sam caption] {smi}: GARServer.describe_array (point prompt, ViT-H embedding cached) "
        f"{describe_ms:.1f} ms = SAM predict {sam_ms:.1f} + host preprocessing {f['host_ms']:.1f} "
        f"(builder and collate) + caption {f['caption_ms']:.1f} = prefill {prefill_ms:.1f} + "
        f"decode {f['decode_ms']:.1f} ({steps} decode steps, {f['decode_ms'] / max(steps, 1):.2f} "
        f"ms a step); {f['tiles']} tile rows, prompt {f['prompt']} tokens; launches "
        f"{dict((k, v) for k, v in counts.items() if v)} (every other kernel 0)")
    del batch, seen

    # self-speculative decoding at GAR-1B on phase_runtime's one-region case
    batch, plens = rt.batch(runtime_samples()["one region"])
    s = batch.input_ids.shape[1]
    gamma, k = SPEC
    kw = dict(max_new_tokens=RUNTIME_NEW_TOKENS)
    # first round's verify logits at row 0 against one XLA-form decode step
    hidden, kv = gar_prefill(rt.params, rt.cfg, batch)
    last = hidden[:, int(plens[0]) - 1]
    tok0 = torch.argmax(lm_logits(rt.params.llm, rt.cfg.text, last,
                                  valid_vocab=rt.cfg.extended_vocab_size), -1).to(torch.int32)
    cols = ((s + RUNTIME_NEW_TOKENS + gamma + 511) // 512) * 512
    caches = [seed_cache_from_prefill(rt.cfg, kv, plens, cols) for _ in range(2)]
    del hidden, kv
    llm, tc = rt.params.llm, rt.cfg.text
    ckw = dict(prompt_lens=caches[0].prompt_lens, prompt_pad=s)
    tok, chunk = tok0, [tok0]
    for j in range(gamma):
        h, _, _ = _forward_chunk(llm, tc, tok[:, None], caches[0].k, caches[0].v, write_pos=s + j,
                                 num_layers=k, **ckw)
        tok = torch.argmax(lm_logits(llm, tc, h[:, 0], valid_vocab=rt.cfg.extended_vocab_size),
                           -1).to(torch.int32)
        chunk.append(tok)
    h, _, _ = _forward_chunk(llm, tc, torch.stack(chunk, 1), caches[0].k, caches[0].v,
                             write_pos=s, num_layers=tc.num_layers, **ckw)
    verify = lm_logits(llm, tc, h[:, 0], valid_vocab=rt.cfg.extended_vocab_size).float()
    step, _ = gar_decode_step(rt.params, rt.cfg, tok0, caches[1], s, use_kernel=False)
    valid = slice(0, rt.cfg.extended_vocab_size)
    gap = ((verify[:, valid] - step[:, valid].float()).abs().max()
           / step[:, valid].float().abs().max()).item()
    if not gap <= E2E_TOL:
        raise AssertionError(f"[spec] first verify row and the XLA-form step differ by {gap:.3e} "
                             f"> {E2E_TOL} of the logit range")
    del caches, h

    times = {"generate": [], "speculative": []}
    results = {}
    for _ in range(2):  # in turns: generate (fused), then speculative
        for name, extra in (("generate", {}), ("speculative", {"speculative": SPEC})):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts, out = rt.answer(batch, plens, **kw, **extra)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            results[name] = (out, read_counts())
    spec_out, spec_counts = results["speculative"]
    want = expect(B=L, D=depth, E=depth, F=depth, G=depth)
    if spec_counts != want:
        raise AssertionError(f"[spec] launch counts {spec_counts}, expected {want}")
    st = spec_out.stats
    ids = spec_out.tokens
    if ids.shape != (1, RUNTIME_NEW_TOKENS) or not ((ids >= 0) & (
            ids < rt.cfg.extended_vocab_size)).all() or st.rounds < 1:
        raise AssertionError(f"[spec] tokens {ids.shape} outside the vocab, or {st.rounds} rounds")
    n_syncs, where = serving_syncs(lambda: rt.answer(batch, plens, **kw, speculative=SPEC))
    in_spec = sum(v for key, v in where.items() if key.startswith("speculative.py"))
    if in_spec != st.rounds + 1:
        raise AssertionError(f"[spec] {in_spec} host syncs in models/speculative.py, expected "
                             f"rounds + 1 = {st.rounds + 1}: {where}")
    with patched((gen_mod, "gar_decode_step",
                  functools.partial(gar_decode_step, use_kernel=False))):
        xla_out = rt.answer(batch, plens, **kw)[1]
    fused_tokens = results["generate"][0].tokens[0].tolist()
    spec_tokens = ids[0].tolist()
    emitted = int(spec_out.num_generated[0])
    figures["speculative"] = dict(
        rounds=st.rounds, drafted=st.drafted, accepted=st.accepted,
        accept_rate=st.accepted / max(st.drafted, 1),
        tokens_per_verify=(emitted - 1) / st.rounds,
        spec_ms=times["speculative"], generate_ms=times["generate"], syncs=n_syncs,
        spec_syncs=in_spec, verify_gap=gap)
    f = figures["speculative"]
    log(f"[spec] {smi}: GARRuntime.caption(speculative=(gamma {gamma}, draft_layers {k})), one "
        f"region, prompt {int(plens[0])} tokens, {RUNTIME_NEW_TOKENS} new: {st.rounds} rounds, "
        f"{st.accepted} / {st.drafted} drafts accepted ({f['accept_rate']:.1%}), "
        f"{f['tokens_per_verify']:.2f} tokens a verify pass; ms a caption "
        + ", ".join(f"{v:.1f}" for v in times["speculative"]) + " against generate's (fused) "
        + ", ".join(f"{v:.1f}" for v in times["generate"]) + f" in turns; host syncs "
        f"{n_syncs} ({in_spec} in models/speculative.py = rounds + 1; where: {where}); first "
        f"verify row against one XLA-form decode step {gap:.3e} of the logit range (<= "
        f"{E2E_TOL}); first token index leaving generate's fused tokens: "
        f"{first_difference(spec_tokens, fused_tokens)}, its XLA-form tokens: "
        f"{first_difference(spec_tokens, xla_out.tokens[0].tolist())} (bf16: not bounded); "
        f"launches {dict((k, v) for k, v in spec_counts.items() if v)} (every other kernel 0)")
    # the mechanism's upper bound at full width: wo and w_down zeroed past
    # the draft depth make those layers residual passthroughs, so the draft
    # is the whole model (up to the rounding of one row against a chunk)
    with torch.no_grad():
        llm.blocks.wo[k:] = 0
        llm.blocks.w_down[k:] = 0
    bound = {}
    for name, extra in (("generate", {}), ("speculative", {"speculative": SPEC})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bound[name] = rt.answer(batch, plens, **kw, **extra)[1]
        torch.cuda.synchronize()
        bound[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    ub = bound["speculative"].stats
    if ub.accepted < ub.drafted / 2:
        raise AssertionError(f"[spec bound] the whole-model draft kept {ub.accepted} of "
                             f"{ub.drafted} drafts")
    figures["speculative"].update(bound_ms=bound["speculative_ms"],
                                  bound_generate_ms=bound["generate_ms"], bound_rounds=ub.rounds,
                                  bound_accepted=ub.accepted, bound_drafted=ub.drafted)
    log(f"[spec bound] {smi}: wo and w_down zeroed in layers {k}-{L - 1} (the draft is the "
        f"whole model): {ub.rounds} rounds, {ub.accepted} / {ub.drafted} drafts accepted, "
        f"{(int(bound['speculative'].num_generated[0]) - 1) / max(ub.rounds, 1):.2f} tokens a "
        f"verify pass; ms a caption {bound['speculative_ms']:.1f} against generate's (fused) "
        f"{bound['generate_ms']:.1f}; first token index leaving generate's: "
        + first_difference(bound["speculative"].tokens[0].tolist(),
                           bound["generate"].tokens[0].tolist()))
    del rt, srv, pred, batch, bound
    torch.cuda.empty_cache()
    phase_spec_narrow_fp32()
    log(f"[sam + spec] phase {time.perf_counter() - t_phase:.1f} s")
    return figures


SERVING_NEW_TOKENS = 256
SERVING_S_BASE = 4864  # a window's column budget at the 4662-token prompt: 4662 rounded up to 256
SERVING_KEYS = ("B", "C", "C8", "D", "E", "F", "G", "H", "I", "J", "H8", "I8", "J8")


def serving_attention_rows(rnd) -> dict:
    """Kernels B, C and C8 at the serving engine's shapes. B: a chunk of
    the prompt against its prefix, right-aligned causal (Sq = 1024 at Sk =
    3072: the third chunk of `prefill_chunk=1024`; Sq = 566 at Sk = 4662:
    the ragged last chunk), 32 query heads over 8 kv heads, its output at
    `sized_tol` and its LSE at LSE_TOL; library: SDPA with the right-aligned
    boolean mask (enable_gqa). C and C8: layer 7 of a window's dense cache
    at B = 8 slots, (16, 8, 8, 5120, 64), each row's own prompt_lens
    4662 - 64 r (its cached tokens), prompt_pad = the window base 4864 and
    write_pos = base + 17 (the window's 18th step), at TOL16 with the
    interval probe (C8's `q8_probe`), the written column and the rest of
    the cache checked; C8's scales one per (layer, slot, kv-head pair), as
    the int8 window quantizes them; C8 also at B = 16 (prompt_lens down to
    3702), the int8 16-slot run's. B also at an admission group's prefill:
    8 and 16 rows of the 4662-token prompt, causal, held row by row against
    the plain version at `sized_tol` (a row's fp32 scores are 2.8 GB);
    library SDPA with is_causal. Returns {key: {shape: figures}}."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import decode_attention as dec
    from grasp_any_region_tpu_torch.ops import flash_attention as fa

    rows = {"B": {}, "C": {}, "C8": {}}
    for sq, sk in ((1024, 3072), (566, 4662)):
        q, k, v = rnd(1, sq, 32, 64), rnd(1, sk, 8, 64), rnd(1, sk, 8, 64)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                                return_lse=True)
        label = f"B (chunk Sq = {sq} against Sk = {sk})"
        err = max_err(out, ref, label, **sized_tol(ref))
        max_err(lse, ref_lse, f"{label} LSE", atol=LSE_TOL, rtol=1e-4)
        mask = fa.attention_mask(sq, sk, True, None, q.device)[0, 0]  # (1, Sq, Sk)
        pairs = sq * (sk - sq) + sq * (sq + 1) // 2
        r = dict(max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
                 plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                                  iters=3),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)),
                 **bound(nbytes(q, k, v, out), 4 * 32 * 64 * pairs))
        rows["B"][f"Sq {sq}, Sk {sk}"] = r
        log(f"[kernels serving] {label}, causal right-aligned (library: SDPA, boolean mask): "
            f"{share_line(r)}; plain {r['plain_ms']:.4f} ms; max |kernel - plain| {err:.3e}")
        del q, k, v, out, ref, lse, ref_lse
    for b in (8, 16):  # an admission group's batched prefill
        s = 4662
        q, k, v = rnd(b, s, 32, 64), rnd(b, s, 8, 64), rnd(b, s, 8, 64)
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        label = f"B (admission group, {b} rows of {s})"
        err = 0.0
        for row in range(b):  # one row at a time: (32, S, S) fp32 scores a row
            one = slice(row, row + 1)
            ref = fa.flash_attention_plain(q[one].float(), k[one].float(), v[one].float(),
                                           causal=True)
            err = max(err, max_err(out[one], ref, f"{label}, row {row}", **sized_tol(ref)))
            del ref

        def plain_rows():
            for row in range(b):
                one = slice(row, row + 1)
                fa.flash_attention_plain(q[one], k[one], v[one], causal=True)

        r = dict(max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
                 plain_ms=cuda_ms(plain_rows, iters=2, warmup=1),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
                 **bound(nbytes(q, k, v, out), 4 * b * 32 * 64 * s * (s + 1) // 2))
        rows["B"][f"B = {b}, S {s}"] = r
        log(f"[kernels serving] {label}, causal (library: SDPA, is_causal): {share_line(r)}; "
            f"plain {r['plain_ms']:.4f} ms (row by row); max |kernel - plain| {err:.3e}")
        del q, k, v, out
    torch.cuda.empty_cache()

    layer, pad, s = 7, SERVING_S_BASE, 5120
    wpos = pad + 17
    wp = torch.tensor(wpos, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    # C at the bf16 run's 8 slots; C8 at the int8 runs' 8 and 16
    for key, b in (("C", 8), ("C8", 8), ("C8", 16)):
        q8 = key == "C8"
        plens = [4662 - 64 * r for r in range(b)]
        kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
                  write_pos=wp, prompt_pad=pad)
        q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
        if q8:
            k_all, v_all = (torch.randint(-127, 128, (16, b, 8, s, 64), generator=gen,
                                          device="cuda", dtype=torch.int8) for _ in range(2))
            scales = dict(zip(("k_scale", "v_scale"), (
                (torch.rand((16, b, 4, 1, 1), generator=gen, device="cuda") + 0.5) / 73.3
                for _ in range(2))))
        else:
            k_all, v_all, scales = rnd(16, b, 8, s, 64), rnd(16, b, 8, s, 64), {}
        kwk = {**kw, **scales}
        err = 0.0
        for probe in (False, True):
            if probe and q8:
                k_new, v_new = q8_probe("interval", k_all, v_all, scales["k_scale"],
                                        scales["v_scale"], q, k_new, v_new, layer, plens, pad,
                                        wpos)
            elif probe:
                k0, vp = interval_probe(v_all[layer], plens, pad, wpos)
                k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
                del k0, vp
            label = f"{key} (window, B = {b}{', interval probe' if probe else ''})"
            k_ref, v_ref = k_all[layer].clone(), v_all[layer].clone()
            out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kwk)
            torch.cuda.synchronize()
            if q8:
                ref = dec.decode_attention_fused_q8_plain(
                    q.float(), k_ref[None], v_ref[None], k_new, v_new, 0,
                    **{**kw, **{n: t[layer:layer + 1] for n, t in scales.items()}})
            else:
                ref = dec.decode_attention_fused_plain(
                    q.float(), k_ref[None].float(), v_ref[None].float(), k_new.float(),
                    v_new.float(), 0, **kw)
            err = max(err, max_err(out, ref, label, **TOL16))
            for got, want, new in ((k_all[layer], k_ref, k_new), (v_all[layer], v_ref, v_new)):
                if not q8:  # C writes the new K/V as they are; C8's plain version wrote want's
                    want[:, :, wpos] = new
                col = (got[:, :, wpos].float() - want[:, :, wpos].float()).abs().max().item()
                if col > (1 if q8 else 0) or not (
                        torch.equal(got[:, :, :wpos], want[:, :, :wpos])
                        and torch.equal(got[:, :, wpos + 1:], want[:, :, wpos + 1:])):
                    raise AssertionError(f"{label}: the written column is off by {col} "
                                         f"{'steps' if q8 else ''} or other cache entries changed")
            del k_ref, v_ref, ref
        args = (q, k_all, v_all, k_new, v_new, layer)
        plain = dec.decode_attention_fused_q8_plain if q8 else dec.decode_attention_fused_plain
        lib_ms = None
        if not q8:
            ids = torch.arange(s, device="cuda")
            mask = ((ids < kw["prompt_lens"][:, None]) | ((ids >= pad) & (ids <= wpos)))
            k_lay, v_lay, q4 = k_all[layer], v_all[layer], q[:, :, None, :]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k_lay, v_lay, attn_mask=mask[:, None, None, :], scale=64 ** -0.5,
                enable_gqa=True))
        r = dict(max_abs_err=err, ms=cuda_ms(lambda: dec.decode_attention_fused(*args, **kwk)),
                 plain_ms=cuda_ms(lambda: plain(*args, **kwk), iters=5), library_ms=lib_ms,
                 **decode_bound(q, k_all, plens, pad, wpos))
        rows[key][f"window B = {b}"] = r
        log(f"[kernels serving] {key} over a window cache, B = {b}, prompt_lens "
            f"{plens[0]}..{plens[-1]}, prompt_pad {pad}, write_pos {wpos}: {share_line(r)}; "
            f"plain {r['plain_ms']:.4f} ms; max |kernel - plain| {err:.3e} (TOL16, interval "
            "probe)")
        del k_all, v_all
    torch.cuda.empty_cache()
    return rows


def serving_tower_rows(rnd, gen) -> dict:
    """Kernels D, E, F and G over an admission group's tiles: 8 and 16
    requests of 17 tiles in one tower pass, T = 136 and 272 tiles of 1025
    tokens at gar_1b's widths (at 272, G's (T x 1025, 4096) hidden is 2.28
    GB and D's output 1.71 GB: byte offsets past 2^31). Each is held
    against its plain version on the same inputs, 34 tiles at a time (its
    rows are independent; a whole fp32 reference would take tens of GB), at
    TOL (not E: its outputs are small, as in vit_block_kernels) and at
    `sized_tol` of each block; plain ms times the same blocks in turn.
    Library: SDPA without rope for E, torch.addmm for F, none for D and G.
    Returns {key: {shape: figures}}."""
    from grasp_any_region_tpu_torch.ops import vit_attention as va
    from grasp_any_region_tpu_torch.ops import vit_block as vb
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    s, d, m, h, block = 1025, 1024, 4096, 16, 34

    def w(*shape, scale):
        return (rnd(*shape).float() * scale).to(torch.bfloat16)

    ln = (1.0 + w(d, scale=0.2), w(d, scale=0.2))
    wqkv, bqkv = w(d, 3 * d, scale=d ** -0.5), w(3 * d, scale=0.1)
    wo, bo, ls1 = w(d, d, scale=d ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    fc1, b1 = w(d, m, scale=d ** -0.5), w(m, scale=0.1)
    fc2, b2, ls2 = w(m, d, scale=m ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    ang = torch.rand((h, s - 1, 32), generator=gen, device="cuda") * 40.0
    cos, sin = rope_head_tables(ang, h, 1)
    rows = {}
    for t in (136, 272):
        n = t * s
        x, attn, qkv = rnd(t, s, d), rnd(t, s, d), rnd(t, s, 3 * d)
        heads = [qkv[..., i * d:(i + 1) * d].unflatten(-1, (h, 64)).transpose(1, 2)
                 for i in range(3)]
        cases = {  # name: (kernel, plain, tiled args, other args, kwargs, operations, library)
            "D": (vb.vit_ln_qkv, vb.vit_ln_qkv_plain, (x,), (*ln, wqkv, bqkv), {},
                  2 * n * d * 3 * d, None),
            "E": (va.vit_attention_fused_qkv, va.vit_attention_fused_qkv_plain, (qkv,),
                  (cos, sin, h, 64), {}, 4 * t * h * s * s * 64,
                  lambda: torch.nn.functional.scaled_dot_product_attention(*heads)),
            "F": (vb.vit_wo_residual, vb.vit_wo_residual_plain, (attn, x), (wo, bo, ls1), {},
                  2 * n * d * d, lambda: torch.addmm(x.view(n, d), attn.view(n, d), wo)),
            "G": (vb.vit_mlp_residual, vb.vit_mlp_residual_plain, (x,),
                  (*ln, fc1, b1, fc2, b2, ls2), dict(fast_gelu=True), 4 * n * d * m, None),
        }
        for name, (kernel, plain, tiled, rest, kw, ops, library) in cases.items():
            out = kernel(*tiled, *rest, **kw)
            torch.cuda.synchronize()
            label = f"{name} ({t} tiles, an admission group of {t // 17})"
            err = 0.0
            for i in range(0, t, block):
                part = f"{label}, tiles {i}-{i + block - 1}"
                ref = plain(*(a[i:i + block].float() for a in tiled),
                            *(a.float() if name != "E" else a for a in rest), **kw)
                got = out[i:i + block]
                if name != "E":
                    max_err(got, ref, part)
                err = max(err, max_err(got, ref, part, **sized_tol(ref)))
                del ref

            def plain_blocks():
                for i in range(0, t, block):
                    plain(*(a[i:i + block] for a in tiled), *rest, **kw)

            r = dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*tiled, *rest, **kw)),
                     plain_ms=cuda_ms(plain_blocks, iters=2, warmup=1),
                     library_ms=cuda_ms(library) if library else None,
                     **bound(nbytes(*tiled, *(a for a in rest if torch.is_tensor(a)), out), ops))
            rows.setdefault(name, {})[f"T = {t}"] = r
            log(f"[kernels serving] {label}: {share_line(r)}; plain {r['plain_ms']:.4f} ms "
                f"({block} tiles at a time); max |kernel - plain| {err:.3e}")
            del out
        del x, attn, qkv, heads
        torch.cuda.empty_cache()
    return rows


def serving_stream_rows(rnd) -> dict:
    """The weight stream at the engine's slot counts: J, I, H (at wo and at
    w_down) and J8, I8, H8 at B = 8 and 16, GAR-1B's widths, layer 7 of 16
    stacked layers (int8: the same weights quantized), against their plain
    versions at TOL; the bound is the layer's weights read once plus x and
    the output; library: torch.mm for H, torch._weight_int8pack_mm for H8
    (None where it refuses), None for the products that no one call gives.
    Returns {key: {shape: figures}}."""
    from grasp_any_region_tpu_torch.models.quantize import quantize_int8
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm

    d, m, hq, hk = GAR1B_WIDTHS
    layer = 7

    def stack(din, n):
        return (rnd(16, din, n).float() * din ** -0.5).to(torch.bfloat16)

    w = dict(wq=stack(d, hq), wk=stack(d, hk), wv=stack(d, hk), wo=stack(hq, d), wg=stack(d, m),
             wu=stack(d, m), wd=stack(m, d))
    q8 = {name: quantize_int8(t) for name, t in w.items()}
    specs = {  # label: (key, kernel, plain, weights, Din)
        "J": ("J", lm.layer_qkv, lm.layer_qkv_plain, (w["wq"], w["wk"], w["wv"]), d),
        "I": ("I", lm.layer_swiglu, lm.layer_swiglu_plain, (w["wg"], w["wu"]), d),
        "H wo": ("H", lm.layer_matmul, lm.layer_matmul_plain, (w["wo"],), hq),
        "H w_down": ("H", lm.layer_matmul, lm.layer_matmul_plain, (w["wd"],), m),
        "J8": ("J8", lm.layer_qkv_q8, lm.layer_qkv_q8_plain, (*q8["wq"], *q8["wk"], *q8["wv"]), d),
        "I8": ("I8", lm.layer_swiglu_q8, lm.layer_swiglu_q8_plain, (*q8["wg"], *q8["wu"]), d),
        "H8 wo": ("H8", lm.layer_matmul_q8, lm.layer_matmul_q8_plain, q8["wo"], hq),
        "H8 w_down": ("H8", lm.layer_matmul_q8, lm.layer_matmul_q8_plain, q8["wd"], m),
    }
    rows = {}
    for b in (8, 16):
        for label, (key, kernel, plain, ws, din) in specs.items():
            x = rnd(b, din)
            out = kernel(x, *ws, layer)
            torch.cuda.synchronize()
            ref = plain(x.float(), *(t[layer:layer + 1].float() for t in ws), 0)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            err = max(max_err(o, r, f"{label} (B = {b})") for o, r in zip(outs, refs))
            douts = [t.shape[2] for t in ws if t.dtype != torch.float32]
            n_out = douts[0] if key.startswith("I") else sum(douts)
            lib_ms = None
            if key == "H":
                lib_ms = cuda_ms(lambda: torch.mm(x, ws[0][layer]))
            elif key == "H8":
                w_nk, s_n = ws[0][layer].t().contiguous(), ws[1][layer].reshape(-1).to(x.dtype)
                try:
                    lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s_n))
                except RuntimeError as e:
                    log(f"[kernels serving] {label} (B = {b}): torch._weight_int8pack_mm "
                        f"refused: {e}")
            r = dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(x, *ws, layer)),
                     plain_ms=cuda_ms(lambda: plain(x, *ws, layer), iters=5), library_ms=lib_ms,
                     **bound(nbytes(*(t[layer] for t in ws)) + 2 * b * (din + n_out),
                             2 * b * din * sum(douts)))
            rows.setdefault(key, {})[f"{label.split(' ', 1)[1] + ', ' if ' ' in label else ''}"
                                     f"B = {b}"] = r
            log(f"[kernels serving] {label}, B = {b}: {share_line(r)}; plain "
                f"{r['plain_ms']:.4f} ms; max |kernel - plain| {err:.3e}")
    del w, q8
    torch.cuda.empty_cache()
    return rows


def serving_requests(cfg, n: int, seed0: int = 0):
    """n one-region requests of the bench workload (17 tiles, the
    4662-token prompt), each from its own seed: (batch, prompt length)."""
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch

    reqs = []
    for i in range(n):
        batch, _, plens = synthetic_batch(cfg, batch=1, grid=(4, 4), regions=1, seed=seed0 + i,
                                          device="cuda")
        reqs.append((batch, int(plens[0])))
    return reqs


def serving_syncs(run) -> tuple:
    """Run `run()` under torch.cuda.set_sync_debug_mode("warn") and return
    (the host syncs the port made, where each was made: the innermost frame
    in the port's package and, after it, the innermost frame of all). A
    sync with no frame of the port on its stack is the harness's own (the
    mode switch back makes one) and is listed apart, not counted."""
    import traceback
    import warnings

    import grasp_any_region_tpu_torch

    where, port = {}, os.path.dirname(os.path.abspath(grasp_any_region_tpu_torch.__file__))

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(port)]
        key = (f"{os.path.basename(ours[-1].filename)}:{ours[-1].lineno}" if ours
               else "outside the port") + f" -> {os.path.basename(filename)}:{lineno}"
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(n for key, n in where.items() if not key.startswith("outside")), where


@torch.inference_mode()
def phase_serving_cross_check():
    """The serving path's pieces on the card, on the narrow config with 2 kv
    heads and 3 slots (slots != kv heads), bf16: each within E2E_TOL of its
    range. (1) `llama_decode_step_paged_fused` (J, H, I, H a layer, plain
    paged attention) against `llama_decode_step_paged` (cuBLAS products) on
    the same pools: hidden and the written page entries; (2) one window
    step (the fused `llama_decode_step` on the pages gathered dense: J, C,
    H, I, H) against the paged XLA step over the same pages, hidden and
    written K/V of the active slots; (3) `llama_prefill_chunk` over 1500
    tokens in chunks of 512 (a ragged last 476; kernel B at Sq < Sk) against
    one `llama_prefill`: the last chunk's hidden and all K/V; (4) the bf16
    engine's burst window against its gather path: the same tokens bit for
    bit, and a run of the gather path under set_sync_debug_mode("warn"):
    one host sync a window (its fetch) plus its eot looks."""
    from grasp_any_region_tpu_torch.models.llama import (
        KVCache, llama_decode_step, llama_decode_step_paged, llama_decode_step_paged_fused,
        llama_prefill, llama_prefill_chunk)
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig
    from grasp_any_region_tpu_torch.serve.paged_cache import gather_pages_dense

    cfg = narrow_config(kv_heads=2)
    tc = cfg.text
    L, kh, dh = tc.num_layers, tc.num_kv_heads, tc.head_dim
    params = random_params(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    slots, ps, n_pages, mp = 3, 64, 64, 16
    pools = [torch.randn((L, kh, n_pages, ps, dh), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2)]
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[: slots * mp] + 1) \
        .reshape(slots, mp).to(torch.int32)
    seq_lens = torch.tensor([900, 517, 64], dtype=torch.int32, device="cuda")
    active = torch.tensor([True, True, False], device="cuda")
    emb = torch.randn((slots, 1, tc.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    worst = 0.0

    def rel(label, got, want):
        nonlocal worst
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"[serving cross-check] {label}: {tuple(got.shape)} against "
                                 f"{tuple(want.shape)} or non-finite")
        r = ((got - want).abs().max() / want.abs().max()).item()
        worst = max(worst, r)
        log(f"[serving cross-check] {label}: max |diff| / max |ref| = {r:.3e}")
        if r > E2E_TOL:
            raise AssertionError(f"[serving cross-check] {label} differs by {r:.3e} > {E2E_TOL}")

    runs = {}
    for form, step in (("xla", llama_decode_step_paged), ("fused", llama_decode_step_paged_fused)):
        kp, vp = (p.clone() for p in pools)
        reset_counts()
        hidden, kp, vp = step(params.llm, tc, emb, kp, vp, bt, seq_lens, active)
        torch.cuda.synchronize()
        want = expect(**({} if form == "xla" else dict(J=L, I=L, H=2 * L)))
        if read_counts() != want:
            raise AssertionError(f"[serving cross-check] paged {form} launches {read_counts()}, "
                                 f"expected {want}")
        runs[form] = (hidden, kp, vp)
    rows = torch.arange(2, device="cuda")
    pid = bt[rows, (seq_lens[:2] // ps).long()].long()
    off = (seq_lens[:2] % ps).long()
    rel("paged fused step against the paged XLA step, hidden", runs["fused"][0][:2],
        runs["xla"][0][:2])
    for i, name in ((1, "K"), (2, "V")):
        rel(f"paged fused step against the paged XLA step, written {name}",
            runs["fused"][i][:, :, pid, off], runs["xla"][i][:, :, pid, off])

    # (2) the window's first step on the same pages, gathered dense
    s_base = 1024
    kd, vd = gather_pages_dense(pools[0], pools[1], bt, s_base, 8)
    cache = KVCache(k=kd, v=vd, prompt_lens=seq_lens,
                    write_pos=torch.full((), s_base, dtype=torch.int32, device="cuda"))
    reset_counts()
    hidden, cache = llama_decode_step(params.llm, tc, emb, cache, s_base)
    torch.cuda.synchronize()
    want = expect(C=L, J=L, I=L, H=2 * L)
    if read_counts() != want:
        raise AssertionError(f"[serving cross-check] window step launches {read_counts()}, "
                             f"expected {want}")
    rel("window step (fused, dense) against the paged XLA step, hidden", hidden[:2],
        runs["xla"][0][:2])
    for i, name, dense in ((1, "K", cache.k), (2, "V", cache.v)):
        rel(f"window step against the paged XLA step, written {name}",
            dense[:, :2, :, s_base].transpose(0, 1), runs["xla"][i][:, :, pid, off].permute(2, 0, 1, 3))
    del runs, pools, kd, vd, cache

    # (3) chunked prefill against one prefill
    s, chunk = 1500, 512
    embeds = torch.randn((1, s, tc.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, device="cuda", dtype=torch.int32)[None]
    whole, (k_whole, v_whole) = llama_prefill(params.llm, tc, embeds, pos)
    kv, n_chunks = None, 0
    reset_counts()
    for c0 in range(0, s, chunk):
        hidden, kv = llama_prefill_chunk(params.llm, tc, embeds[:, c0:c0 + chunk],
                                         pos[:, c0:c0 + chunk], kv)
        n_chunks += 1
    torch.cuda.synchronize()
    if read_counts() != expect(B=L * n_chunks):
        raise AssertionError(f"[serving cross-check] chunked prefill launches {read_counts()}, "
                             f"expected B = {L * n_chunks}")
    rel(f"llama_prefill_chunk ({n_chunks} chunks, the last {s - chunk * (n_chunks - 1)}) "
        "against llama_prefill, last chunk's hidden", hidden, whole[:, chunk * (n_chunks - 1):])
    rel("llama_prefill_chunk against llama_prefill, K", kv[0], k_whole)
    rel("llama_prefill_chunk against llama_prefill, V", kv[1], v_whole)
    del embeds, whole, k_whole, v_whole, kv

    # (4) the engine's burst window against its gather path, bit for bit; then
    # the host syncs of a run of the gather path
    reqs = serving_requests(cfg, 2)
    ecfg = EngineConfig(slots=slots, page_size=64, num_pages=slots * 80 + 1,
                        max_pages_per_slot=80, max_new_tokens=24, eot_id=-1, mask_compat=False, decode_chunk=8)
    tokens, counts = [], []
    for burst in (True, False):
        eng = ContinuousBatchingEngine(params, cfg, ecfg)
        if not burst:
            eng._burst = lambda live: False
        ids = [eng.submit(*r) for r in reqs]
        out = eng.run()
        tokens.append([out[i] for i in ids])
        counts.append(dict(eng.counts))
    if tokens[0] != tokens[1] or counts[0].get("fresh_windows") != 1 \
            or counts[1].get("fresh_windows"):
        raise AssertionError(f"[serving cross-check] burst path tokens {tokens[0]} and gather "
                             f"path tokens {tokens[1]} differ, or the paths were not taken "
                             f"({counts})")
    log(f"[serving cross-check] engine burst path = gather path, bit for bit: 2 requests x "
        f"24 tokens over windows of 8 (burst: {counts[0]}; gather: {counts[1]}); first tokens "
        f"{tokens[0][0][:8]}")
    eot = cfg.extended_vocab_size - 1  # an id the looks watch for
    eng = ContinuousBatchingEngine(params, cfg, dataclasses.replace(
        ecfg, eot_id=eot, decode_chunk=40, max_new_tokens=80))
    for r in reqs:
        eng.submit(*r)
    eng.run()  # warm-up
    eng.counts = {}
    for r in reqs:
        eng.submit(*r)
    n_syncs, where = serving_syncs(eng.run)
    want = eng.counts["windows"] + eng.counts.get("eot_looks", 0)
    log(f"[serving cross-check] host syncs of a windowed run (2 requests x 80 tokens, windows "
        f"of 40, eot watched): {n_syncs} = {eng.counts['windows']} window fetches + "
        f"{eng.counts.get('eot_looks', 0)} eot looks? at {where}")
    if n_syncs != want:
        raise AssertionError(f"[serving cross-check] {n_syncs} host syncs, expected {want} "
                             f"(one fetch a window and the eot looks): {where}")
    log(f"[serving cross-check] worst relative error {worst:.3e} <= {E2E_TOL}")


def serving_launches(eng, cfg, int8: bool) -> dict:
    """The launches a run of `eng` must make, from its own schedule: D-G a
    tower pass, B a layer per admission group and per prefill chunk; the
    window steps the fused step (J, C, H, I, H a layer; with an int8
    window cache and int8 weights J8, C8, H8, I8, H8), the per-token steps
    the weight-stream paged step (J, H, I, H a layer; no C: paged
    attention is plain torch, as in JAX)."""
    c, L, depth = eng.counts, cfg.text.num_layers, cfg.vision.depth
    steps, tokens = c.get("window_steps", 0), c.get("token_steps", 0)
    sfx = "8" if int8 else ""
    want = dict(B=L * (c.get("prefill_groups", 0) + c.get("prefill_chunks", 0)),
                **dict.fromkeys("DEFG", depth * c.get("tower_passes", 0)))
    want[f"C{sfx}"] = L * steps
    want[f"J{sfx}"] = want[f"I{sfx}"] = L * (steps + tokens)
    want[f"H{sfx}"] = 2 * L * (steps + tokens)
    return expect(**{k: v for k, v in want.items() if v})


@torch.inference_mode()
def run_serving(cfg, params, label, n_requests=8, slots=8, window=SERVING_NEW_TOKENS,
                int8=False, staggered=False, prefill_chunk=None, schedule=None) -> dict:
    """One serving run at full width, as bench.py:run_serving: the engine
    over `slots` slots (80 pages of 64 tokens each, num_pages = slots * 80
    + 1), n_requests 17-tile requests, 256 greedy tokens each (eot -1); a
    warm-up run of the same requests, then the timed run. staggered: half
    the requests up front, the rest submitted at the first window's fetch.
    Asserts 256 tokens a request in the valid vocab, every page back at the
    end, and the launches of the timed run (`serving_launches`), with
    `schedule` (the engine's counts the table predicts) where given; the
    warm-up and the timed run must give the same tokens. Returns the timed
    run's launches and figures."""
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig

    ecfg = EngineConfig(slots=slots, page_size=64, num_pages=slots * 80 + 1,
                        max_pages_per_slot=80, max_new_tokens=SERVING_NEW_TOKENS, eot_id=-1,
                        mask_compat=False, decode_chunk=window, quantize_kv=int8,
                        prefill_chunk=prefill_chunk)
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    reqs = serving_requests(cfg, n_requests)
    first = n_requests // 2 if staggered else n_requests
    tag = f"[serving {label}]"

    def serve():
        ids = [eng.submit(*r) for r in reqs[:first]]

        def on_event(ev):
            if len(ids) < n_requests:
                ids.extend(eng.submit(*r) for r in reqs[first:])

        out = eng.run(on_event if staggered else None)
        torch.cuda.synchronize()
        return [out[i] for i in ids]

    warm = serve()
    eng.latency_stats()  # drops the warm-up's requests
    eng.counts, eng.timing = {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = serve()
    dt = time.perf_counter() - t0
    counts = read_counts()
    stats = eng.latency_stats()
    vocab = cfg.extended_vocab_size
    if len(toks) != n_requests or any(len(t) != SERVING_NEW_TOKENS for t in toks) or \
            not all(0 <= x < vocab for t in toks for x in t):
        raise AssertionError(f"{tag} not {SERVING_NEW_TOKENS} valid tokens for each of "
                             f"{n_requests} requests: {[len(t) for t in toks]}")
    if eng.allocator.free_pages != ecfg.num_pages - 1:
        raise AssertionError(f"{tag} {eng.allocator.free_pages} free pages at the end, "
                             f"expected {ecfg.num_pages - 1}")
    if toks != warm:
        diff = [i for i, (a, b) in enumerate(zip(toks, warm)) if a != b]
        raise AssertionError(f"{tag} the timed run's tokens differ from the warm-up's on the "
                             f"same requests (requests {diff})")
    if schedule is not None and any(eng.counts.get(k, 0) != v for k, v in schedule.items()):
        raise AssertionError(f"{tag} schedule {eng.counts}, expected {schedule}")
    want = serving_launches(eng, cfg, int8)
    if counts != want:
        raise AssertionError(f"{tag} launch counts {counts}, expected {want} from the "
                             f"schedule {eng.counts}")
    t, windows = eng.timing, eng.counts["windows"]
    outside = sum(t.get(k, 0.0) for k in ("window_setup", "window_gather", "window_flush",
                                          "window_host"))
    steps = eng.counts["window_steps"]
    n_tok = n_requests * SERVING_NEW_TOKENS
    log(f"{tag} {slots} slots, {n_requests} requests x {SERVING_NEW_TOKENS} tokens, window "
        f"{window}{', prefill_chunk ' + str(prefill_chunk) if prefill_chunk else ''}"
        f"{', int8 weights and window cache' if int8 else ''}: {dt:.3f} s -> "
        f"{n_requests / dt:.3f} requests/s, {n_tok / dt:.1f} tok/s; TTFT p50 "
        f"{stats['ttft_p50_s']:.3f} s p95 {stats['ttft_p95_s']:.3f} s; latency p50 "
        f"{stats['latency_p50_s']:.3f} s p95 {stats['latency_p95_s']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"{tag} schedule {eng.counts}; host ms: "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(t.items()))
        + f"; a window outside its steps {outside / windows * 1e3:.1f} ms (setup, gather, "
        f"flush, bookkeeping), its steps {t.get('window_steps', 0.0) / max(steps, 1) * 1e3:.2f} "
        f"ms of host a step; launches {dict((k, v) for k, v in counts.items() if v)}; "
        f"the warm-up's tokens equal the timed run's")
    del eng
    torch.cuda.empty_cache()
    return {**stats, "counts": counts, "requests_per_s": n_requests / dt, "tok_per_s": n_tok / dt}


@torch.inference_mode()
def run_serving_per_token(cfg, params, n_steps: int = 4) -> dict:
    """decode_chunk = 1 with use_fused: 8 requests, 8 slots, n_steps
    `step()`s (the first admits all 8 in one group and fetches their tok0):
    J, H, I a layer a step and no C (paged attention is plain, as in JAX);
    the host ms of a step (synchronized) after the first."""
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig

    ecfg = EngineConfig(slots=8, page_size=64, num_pages=8 * 80 + 1, max_pages_per_slot=80,
                        max_new_tokens=SERVING_NEW_TOKENS, eot_id=-1, mask_compat=False,
                        use_fused=True)
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    for r in serving_requests(cfg, 8):
        eng.submit(*r)
    reset_counts()
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        events = eng.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    want = serving_launches(eng, cfg, int8=False)
    if counts != want or eng.counts["token_steps"] != n_steps or counts["C"]:
        raise AssertionError(f"[serving per-token] launches {counts}, expected {want}")
    if len(events) != 8 or not all(0 <= e.token < cfg.extended_vocab_size for e in events):
        raise AssertionError(f"[serving per-token] events of the last step {events}")
    log(f"[serving per-token] 8 slots, use_fused, {n_steps} steps: host ms a step (synchronized) "
        f"{', '.join(f'{x:.1f}' for x in times)} (the first admits 8 requests and prefills "
        f"them); launches {dict((k, v) for k, v in counts.items() if v)}")
    del eng
    torch.cuda.empty_cache()
    return counts


def phase_serving(cfg, params) -> dict:
    """The continuous-batching engine at GAR-1B's full width (bench.py's
    serving lines): bf16 8 slots one window of 256; int8 (serving_weights,
    quantize_kv) 16 slots; int8 low-TTFT windows of 32; staggered bf16
    arrivals with chunked prefill; per-token steps. Returns each run's
    figures."""
    from grasp_any_region_tpu_torch.models.quantize import serving_weights

    runs = {"bf16": run_serving(cfg, params, "bf16", schedule=dict(
        prefill_groups=1, tower_passes=1, windows=1, fresh_windows=1, window_steps=255))}
    serving = serving_weights(params)
    runs["int8 16-slot"] = run_serving(cfg, serving, "int8 16-slot", n_requests=16, slots=16,
                                       int8=True, schedule=dict(
        prefill_groups=1, tower_passes=1, windows=1, fresh_windows=1, window_steps=255))
    # 255 steps in windows of 32: the first a burst, seven through the pages
    # (gather and flush), the burst's survivors flushed after its fetch
    runs["int8 low-TTFT"] = run_serving(cfg, serving, "int8 low-TTFT", window=32, int8=True,
                                        schedule=dict(prefill_groups=1, windows=8,
                                                      fresh_windows=1, gathers=7, flushes=8,
                                                      window_steps=255))
    del serving
    torch.cuda.empty_cache()
    # 4 requests up front (one group), 4 more at the first fetch: each of
    # those a tower pass and ceil(4662 / 1024) = 5 chunks of kernel B
    runs["staggered"] = run_serving(cfg, params, "staggered", window=32, staggered=True,
                                    prefill_chunk=1024, schedule=dict(
        prefill_groups=1, tower_passes=5, prefill_chunks=20, fresh_windows=1))
    runs["per-token"] = dict(counts=run_serving_per_token(cfg, params))
    return runs


GAR8B_NEW_TOKENS = 64


def phase_gar8b(int8: bool):
    """GAR-8B's caption at full width on one card (the JAX package's 8B
    caption bench, bench.py:394-450): seeded random weights, bf16
    (`init_gar_params`) or born in the serving-only int8 layout
    (`init_gar_serving_int8`: int8 decoder matmuls and head, bf16 tower,
    projector and embedding), a bf16 cache either way; one image of 9 tiles
    (thumbnail + 2 x 4), one region, the 2614-token prompt and 64 greedy
    tokens through `generate` on the default paths: the tower unfused at
    head dim 96 (kernel A, 47 layers), prefill through kernel B at 128 (32
    layers), the fused decode step (J, C, H, I, H a layer; J8, C, H8, I8,
    H8 with int8 weights), the untied head. A warm-up, then two timed
    captions (median), split into vision, prefill and decode; decode tok/s,
    the weights' bytes and the peak memory of a caption; one decode step's
    device and host ms and device ops; the launch counts of a caption, which
    must be exactly those. Returns the launches."""
    from grasp_any_region_tpu_torch.core.config import gar_8b
    from grasp_any_region_tpu_torch.models.gar import (
        encode_images, gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.generate import generate
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.models.quantize import init_gar_serving_int8

    cfg = gar_8b()
    tag = "[gar8b int8]" if int8 else "[gar8b]"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if int8:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = init_gar_serving_int8(cfg, gen)
        with torch.no_grad():  # zero at init, which would leave the mask path idle
            params.mask_embed.kernel.normal_(0.0, 0.02, generator=gen)
    else:
        params = random_params(cfg, "cuda")
    torch.cuda.synchronize()
    weight_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    init_s = time.perf_counter() - t0
    batch, plens = bench_batch(cfg, "cuda")
    b, s = batch.input_ids.shape
    n_new = GAR8B_NEW_TOKENS
    steps = cfg.text.num_layers * (n_new - 1)
    dec = (dict(C=steps, H8=2 * steps, I8=steps, J8=steps) if int8 else
           dict(C=steps, H=2 * steps, I=steps, J=steps))
    expected = expect(A=cfg.vision.depth, B=cfg.text.num_layers, **dec)
    log(f"{tag} B={b}, {batch.pixel_values.shape[1]} tiles, prompt {s} tokens, {n_new} new "
        f"tokens; weights {weight_gb:.2f} GB ({'int8 decoder and head' if int8 else 'bf16'}), "
        f"built in {init_s:.1f} s")

    def run():
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = generate(params, cfg, batch, plens, max_new_tokens=n_new, eot_id=-1,
                       mask_compat=False)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), read_counts()

    path = os.environ.pop("GAR_DECODE_PATH", None)
    try:
        torch.cuda.reset_peak_memory_stats()
        run()  # warm-up
        times = []
        for _ in range(2):
            out, ms, counts = run()
            times.append(ms)
            if counts != expected:
                raise AssertionError(f"{tag} launch counts {counts}, expected {expected}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        if path is not None:
            os.environ["GAR_DECODE_PATH"] = path
    toks = out.tokens
    if toks.shape != (b, n_new) or not ((toks >= 0) & (toks < cfg.extended_vocab_size)).all():
        raise AssertionError(f"{tag} tokens {tuple(toks.shape)} or outside the valid vocab")
    pix = batch.pixel_values.reshape((-1,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((-1,) + batch.mask_values.shape[2:])
    with torch.inference_mode():
        vision_ms = cuda_ms(lambda: encode_images(params, cfg, pix, msk, mask_compat=False),
                            iters=3, warmup=1, sleep_cycles=20_000_000)
        prefill_total_ms = cuda_ms(lambda: gar_prefill(params, cfg, batch, mask_compat=False),
                                   iters=3, warmup=1, sleep_cycles=20_000_000)
        hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
        logits = lm_logits(params.llm, cfg.text, hidden[:, -1],
                           valid_vocab=cfg.extended_vocab_size)
        if logits.shape != (b, cfg.padded_vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} prefill logits {tuple(logits.shape)} or non-finite")
        # one decode step (the head included) over the seeded cache: device
        # and host ms, and the device ops the profiler sees
        cache = seed_cache_from_prefill(cfg, kv, plens, GAR8B_COLUMNS)
        tok = logits.argmax(-1).to(torch.int32)
        del hidden, kv, logits

        def step():
            return gar_decode_step(params, cfg, tok, cache, s)

        step_dev_ms, step_host_ms = step_times(step)
        ops = device_ops(step)
        del cache
    total_ms = statistics.median(times)
    decode_ms = total_ms - prefill_total_ms
    log(f"{tag} ms/caption {total_ms:.1f} (runs {', '.join(f'{t:.1f}' for t in times)}): "
        f"vision {vision_ms:.1f}, prefill {prefill_total_ms - vision_ms:.1f}, decode "
        f"{decode_ms:.1f}; decode {b * (n_new - 1) / (decode_ms / 1e3):.1f} tok/s; "
        f"{b / (total_ms / 1e3):.3f} captions/s; peak memory {peak_gb:.2f} GB")
    log(f"{tag} one decode step: {step_dev_ms:.3f} ms device, {step_host_ms:.3f} ms host, "
        f"{ops} device ops (torch.profiler)")
    log(f"{tag} launches per caption {dict((k, v) for k, v in counts.items() if v)} (every "
        f"other kernel 0, as expected); first tokens {toks[0, :8].tolist()}")
    del params, out
    torch.cuda.empty_cache()
    return counts


def phase_gar8b_train():
    """GAR-8B's train step at full width on one card, in the reference's
    single-device regime, LoRA (`train/lora.py`: rank 16, alpha 32 on wq,
    wk, wv, wo; A from a seeded generator, B = 0): seeded random bf16 base
    weights (`random_params`), fp32 adapters, `OptimizerConfig(lora_only=
    True)` (the adapters, the mask embed, llm/embed, llm/lm_head and
    vision/pos_embed train; every float leaf is differentiated and
    grad_norm covers every gradient, as in JAX); the 8B caption's batch
    (9 tiles, one region, the 2614-token prompt). The tower runs unfused
    (kernel A with its LSE, kernel 5 at head dim 96), the decoder through
    B, 17 and 18 at 128. Two warm-up steps, then three timed by CUDA
    events: the losses (finite), ms a step, tok/s, peak memory, grad_norm,
    and the launches of each step, which must be exactly A = 2 x 47, 5 =
    47, B = 2 x 32, 17 = 18 = 32 + 47 (kernel 5 is one call of 17's prep,
    18 and 17's cast), every other kernel 0. Then `merge_lora`: the merged
    tree's last-64-position prefill logits against the unmerged tree's on
    the card, within E2E_TOL of their range. Returns the launches a step."""
    from grasp_any_region_tpu_torch.core.config import gar_8b
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.models.gar import gar_prefill
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.train import OptimizerConfig, init_state, make_train_step
    from grasp_any_region_tpu_torch.train.lora import LoRAConfig, add_lora_params, merge_lora
    from grasp_any_region_tpu_torch.utils.flops import gar_flops

    cfg, lora = gar_8b(), LoRAConfig()
    tag = "[gar8b train]"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = random_params(cfg, "cuda")
    params = add_lora_params(base, cfg.text, lora, torch.Generator().manual_seed(SEED))
    del base
    state, tx = init_state(params, OptimizerConfig(lr=1e-4, total_steps=100, lora_only=True))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    named = dict(state.params.named_parameters())
    n_all = sum(p.numel() for p in named.values())
    n_train = sum(named[n].numel() for n in tx.names)
    batch, labels, _ = synthetic_batch(cfg, grid=(2, 4), regions=1, seed=SEED)
    b, s = batch.input_ids.shape
    tiles = batch.pixel_values.shape[1]
    supervised = int((labels != -100).sum())
    depth, layers = cfg.vision.depth, cfg.text.num_layers
    expected = expect(**{"A": 2 * depth, "5": depth, "B": 2 * layers, "17": layers + depth,
                         "18": layers + depth})
    log(f"{tag} B={b}, {tiles} tiles, prompt {s} tokens ({supervised} supervised); "
        f"{n_all / 1e9:.3f} B parameters, {n_train / 1e9:.4f} B trained "
        f"({len(tx.names)} leaves: {', '.join(sorted(tx.names)[:4])}, ...); LoRA rank "
        f"{lora.rank}, alpha {lora.alpha} on {', '.join(lora.targets)}; built in {init_s:.1f} s")
    step = make_train_step(cfg, tx, mask_compat=False)
    for _ in range(2):  # warm-up
        state, metrics = step(state, batch, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 3
    events, losses, norms, per_step = event_pairs(n + 1), [], [], []
    events[0].record()
    for i in range(n):
        reset_counts()
        state, metrics = step(state, batch, labels)
        events[i + 1].record()
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        per_step.append(read_counts())
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = [x.elapsed_time(y) for x, y in zip(events, events[1:])]
    losses, norms = torch.stack(losses).tolist(), torch.stack(norms).tolist()
    if any(c != expected for c in per_step):
        raise AssertionError(f"{tag} launches a step {per_step}, expected {expected}")
    if segmented_counts() != {"B": 0, "18": 0}:
        raise AssertionError(f"{tag} right-padded rows launched with segment ids: "
                             f"{segmented_counts()}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{tag} losses {losses}, grad norms {norms}: not finite")
    if any(p.grad is not None for p in state.params.parameters()):
        raise AssertionError(f"{tag} a gradient outlived its step")
    ms = statistics.median(times)
    flops = gar_flops(cfg, batch=1, seq=s, tiles=tiles, train=True)["total"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"{tag} ms/step {ms:.1f} (median of {n}; steps {', '.join(f'{x:.1f}' for x in times)}), "
        f"{s / (ms / 1e3):.0f} tok/s ({supervised / (ms / 1e3):.0f} supervised labels/s), "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s of {flops / 1e12:.1f} TFLOP a step (gar_flops, "
        f"full fine-tuning's count), peak memory {peak_gb:.2f} GB; {smi}")
    log(f"{tag} losses {[round(x, 4) for x in losses]}, grad_norm (every gradient) "
        f"{[round(x, 4) for x in norms]}; launches a step "
        f"{dict((k, v) for k, v in per_step[0].items() if v)} (every other kernel 0, as expected)")

    # merge the adapters (B moved by the five steps) and hold the merged
    # tree's prefill against the unmerged one's
    for p in state.params.parameters():
        p.requires_grad_(False)
    del state.opt_state.mu[:], state.opt_state.nu[:]
    torch.cuda.empty_cache()
    merged = merge_lora(state.params, lora)
    with torch.inference_mode():
        def last_logits(p):
            hidden, _ = gar_prefill(p, cfg, batch, mask_compat=False)
            return lm_logits(p.llm, cfg.text, hidden[:, -64:],
                             valid_vocab=cfg.extended_vocab_size)[..., :cfg.extended_vocab_size]

        adapted, folded = last_logits(state.params), last_logits(merged)
    if not (torch.isfinite(adapted).all() and torch.isfinite(folded).all()):
        raise AssertionError(f"{tag} non-finite prefill logits")
    span = (adapted.max() - adapted.min()).item()
    gap = (folded - adapted).abs().max().item() / span
    b_norm = max(getattr(state.params.llm.blocks, f"{t}_lora_b").abs().max().item()
                 for t in lora.targets)
    log(f"{tag} merge_lora: the merged tree's prefill logits (last 64 positions) against the "
        f"unmerged tree's: max |merged - unmerged| / range {gap:.3e} (bound {E2E_TOL}); the "
        f"adapters' max |B| after {n + 2} steps {b_norm:.3e}")
    if gap > E2E_TOL or b_norm == 0:
        raise AssertionError(f"{tag} merged logits differ by {gap:.3e} of the range, or the "
                             f"adapters never moved (max |B| {b_norm})")
    del merged, state, tx, params, adapted, folded
    torch.cuda.empty_cache()
    return per_step[0]


def _head_backward_rounding_first(ctx, g):
    """The CE head's backward in the port's earlier form: the fp32 logit
    gradient rounded to the working dtype before both products (JAX
    contracts it in fp32 and rounds once). Timed and compared only."""
    x, head = ctx.saved_tensors
    g, w = g.to(x.dtype), head.to(x.dtype)
    dx, dhead = (g @ w, g.t() @ x) if ctx.tied else (g @ w.t(), x.t() @ g)
    return dx, dhead.to(head.dtype), None


class head_backward:
    """Context: `_HeadLogits.backward` replaced by `fn` (None: as it is)."""

    def __init__(self, fn):
        from grasp_any_region_tpu_torch.train.losses import _HeadLogits

        self.cls, self.fn, self.saved = _HeadLogits, fn, _HeadLogits.backward

    def __enter__(self):
        if self.fn is not None:
            self.cls.backward = staticmethod(self.fn)

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.saved)


def phase_train_cross_check(cfg):
    """One loss and backward at the narrow gar_1b, the card's kernel path
    (A with its LSE, 5, B, 17, 18) against the CPU's plain path, from the
    same seeded bf16 params; on the card once more with the CE head's
    backward in its earlier form (the logit gradient rounded to bf16 first),
    to show the gap that form left."""
    from grasp_any_region_tpu_torch.core.weights import flat_grads
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.train import loss_fn

    p_cpu = random_params(cfg, "cpu")
    runs, counts = {}, None
    for run, dev, fn in (("card, rounded first", "cuda", _head_backward_rounding_first),
                         ("card", "cuda", None), ("cpu", "cpu", None)):
        params = copy.deepcopy(p_cpu).to(dev) if dev == "cuda" else p_cpu
        for p in params.parameters():
            p.requires_grad_(True)
        batch, labels, _ = synthetic_batch(cfg, grid=(4, 4), regions=1, seed=SEED, device=dev)
        reset_counts()
        with head_backward(fn):
            loss = loss_fn(params, cfg, batch, labels, mask_compat=False)
            loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        runs[run] = (loss.item(), flat_grads(params))
    # kernel 5 is one call of 17's prep, 18's pass and 17's cast a ViT layer:
    # 17 and 18 count the decoder's layers and the tower's
    depth, layers = cfg.vision.depth, cfg.text.num_layers
    expected = expect(**{"A": 2 * depth, "5": depth, "B": 2 * layers, "17": layers + depth,
                         "18": layers + depth})
    if counts != expected:
        raise AssertionError(f"train cross-check: launch counts {counts}, expected {expected}")
    loss_cpu, g_cpu = runs["cpu"]
    rel = {run: {} for run in runs if run != "cpu"}
    for run, gaps in rel.items():
        loss_card, g_card = runs[run]
        if not np.isfinite(loss_card) or abs(loss_card - loss_cpu) > E2E_TOL * abs(loss_cpu):
            raise AssertionError(f"train cross-check ({run}): loss card {loss_card}, "
                                 f"cpu {loss_cpu}")
        for name, ref in g_cpu.items():
            got = g_card[name]
            if not np.isfinite(got).all():
                raise AssertionError(f"train cross-check ({run}): non-finite gradient {name}")
            scale = float(np.abs(ref).max())
            gaps[name] = float(np.abs(got - ref).max()) / scale if scale else float(
                np.abs(got).max())
    after, before = rel["card"], rel["card, rounded first"]
    worst, worst_before = max(after, key=after.get), max(before, key=before.get)
    log(f"[train cross-check] loss card {runs['card'][0]:.6f}, cpu {loss_cpu:.6f}; "
        f"{len(after)} gradient leaves, worst {worst}: max |card - cpu| / max |cpu| = "
        f"{after[worst]:.3e}; launches {dict((k, v) for k, v in counts.items() if v)}")
    log(f"[train cross-check] CE head backward: worst leaf with the logit gradient rounded to "
        f"bf16 first {worst_before} {before[worst_before]:.3e}, as JAX (fp32, one rounding) "
        f"{worst} {after[worst]:.3e}; llm/embed {before['llm/embed']:.3e} -> "
        f"{after['llm/embed']:.3e}")
    if after[worst] > E2E_TOL:
        raise AssertionError(f"train cross-check: gradient {worst} differs by {after[worst]:.3e} "
                             f"> {E2E_TOL} of its range")


def ce_backward_ms(cfg, params, hidden, labels) -> dict:
    """The chunked CE's backward at the train step's shape, with the head's
    backward as it is and in its earlier form (the gradient rounded first):
    forward + backward (torch.autograd.grad to the hidden) minus the
    forward, CUDA events."""
    from grasp_any_region_tpu_torch.train.losses import chunked_cross_entropy

    def fwd():
        return chunked_cross_entropy(params.llm, cfg.text, hidden, labels,
                                     valid_vocab=cfg.extended_vocab_size)

    out = {}
    for name, fn in (("as JAX", None), ("rounded first", _head_backward_rounding_first)):
        with head_backward(fn):
            both = cuda_ms(lambda: torch.autograd.grad(fwd(), (hidden,)), iters=3, warmup=1,
                           sleep_cycles=40_000_000)
        out[name] = both - cuda_ms(fwd, iters=3, warmup=1, sleep_cycles=40_000_000)
    return out


def event_pairs(n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def train_split(cfg, params, batch, labels, tx, opt_state) -> dict:
    """One train step composed as `loss_fn` composes it, with CUDA events at
    the phase boundaries (the backward's via hooks on the embeddings and
    the decoder output): ms per phase, host dispatch gaps included."""
    from grasp_any_region_tpu_torch.models.gar import build_prefill_embeds
    from grasp_any_region_tpu_torch.models.llama import llama_prefill
    from grasp_any_region_tpu_torch.train.losses import chunked_cross_entropy, shift_labels

    ev = dict(zip(("start", "vision", "decoder", "ce", "ce_bwd", "decoder_bwd", "vision_bwd",
                   "optimizer"), event_pairs(8)))
    torch.cuda.synchronize()
    ev["start"].record()
    embeds = build_prefill_embeds(params, cfg, batch, mask_compat=False, remat=True)
    ev["vision"].record()
    hidden, _ = llama_prefill(params.llm, cfg.text, embeds, batch.positions,
                              segment_ids=batch.segment_ids, remat=True, return_kv=False)
    ev["decoder"].record()
    loss = chunked_cross_entropy(params.llm, cfg.text, hidden, shift_labels(labels),
                                 valid_vocab=cfg.extended_vocab_size)
    ev["ce"].record()
    hidden.register_hook(lambda grad: ev["ce_bwd"].record())
    embeds.register_hook(lambda grad: ev["decoder_bwd"].record())
    loss.backward()
    ev["vision_bwd"].record()
    tx.apply(params, opt_state)
    ev["optimizer"].record()
    torch.cuda.synchronize()
    for p in params.parameters():
        p.grad = None
    names = list(ev)
    return {b: ev[a].elapsed_time(ev[b]) for a, b in zip(names, names[1:])}


def phase_train_step(cfg, params):
    """The GAR-1B train step (bench.py:128-226) on the card: the main path
    of training. Returns (launches a step, state, optimizer)."""
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.train import (OptimizerConfig, init_state, make_train_loop,
                                                  make_train_step)
    from grasp_any_region_tpu_torch.utils.flops import gar_flops

    batch, labels, _ = synthetic_batch(cfg, grid=(4, 4), regions=1, seed=SEED)
    s = batch.input_ids.shape[1]
    state, tx = init_state(params, OptimizerConfig(lr=1e-4, total_steps=100))
    n = 8
    t0 = time.perf_counter()
    state, warm = make_train_loop(cfg, tx, n, mask_compat=False)(state, batch, labels)
    log(f"[train] B=1, S={s}, 17 tiles, bf16 params and moments, remat: warm-up window of {n} "
        f"steps {time.perf_counter() - t0:.1f} s, losses {[round(x, 4) for x in warm.tolist()]}")
    step = make_train_step(cfg, tx, mask_compat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = event_pairs(n + 1), []
    reset_counts()
    events[0].record()
    for i in range(n):
        state, metrics = step(state, batch, labels)
        events[i + 1].record()
        losses.append(metrics["loss"])
        if i == 0:
            per_step = read_counts()
    torch.cuda.synchronize()
    window = read_counts()
    times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = torch.stack(losses).tolist()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    depth, layers = cfg.vision.depth, cfg.text.num_layers
    expected = expect(**{"A": 2 * depth, "5": depth, "B": 2 * layers, "17": layers + depth,
                         "18": layers + depth})
    if per_step != expected or window != {key: n * c for key, c in expected.items()}:
        raise AssertionError(f"[train] launches a step {per_step} (window of {n}: {window}), "
                             f"expected {expected}")
    if segmented_counts() != {"B": 0, "18": 0}:
        raise AssertionError(f"[train] right-padded rows launched with segment ids: "
                             f"{segmented_counts()}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] losses {losses}: not finite or not falling")
    ms = statistics.median(times)
    flops = gar_flops(cfg, batch=1, seq=s, tiles=17, train=True)["total"]
    log(f"[train] ms/step {ms:.1f} (median of {n}; steps "
        f"{', '.join(f'{x:.1f}' for x in times)}), {s / (ms / 1e3):.0f} supervised tok/s, "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s of {flops / 1e12:.1f} TFLOP a step "
        f"(gar_flops), peak memory {peak_gib:.2f} GiB")
    log(f"[train] losses {[round(x, 4) for x in losses]}; launches a step {per_step}")
    split = train_split(cfg, params, batch, labels, tx, state.opt_state)
    log("[train] one step split (ms, CUDA events, host gaps included): "
        + ", ".join(f"{name} {t:.1f}" for name, t in split.items())
        + f"; sum {sum(split.values()):.1f}")
    from grasp_any_region_tpu_torch.train.losses import shift_labels

    hidden = torch.randn((1, s, cfg.text.hidden_size), device="cuda").to(torch.bfloat16)
    ce = ce_backward_ms(cfg, params, hidden.requires_grad_(), shift_labels(labels))
    for p in params.parameters():
        p.grad = None
    log(f"[train] CE backward alone (S = {s}, ms, CUDA events): head backward as JAX (two bf16 "
        f"halves of the logit gradient) {ce['as JAX']:.2f}, gradient rounded first "
        f"{ce['rounded first']:.2f}")
    profile_step(lambda: step(state, batch, labels))
    return per_step, state, tx


def profile_step(run, top: int = 12) -> None:
    """torch.profiler over one call: device time by kernel (the top few),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages() if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    log(f"[train] profile of one step: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%), {sum(r.count for r in rows)} "
        f"device ops; top by device time:")
    for r in rows[:top]:
        log(f"[train]   {r.self_device_time_total / 1e3:8.2f} ms {r.count:6d}x  {r.key[:100]}")


def phase_packed_step(cfg, state, tx):
    """The packed text-only step at GAR-1B (bench.py:229-277): 2 rows of
    4096 tokens, documents of 300-1200 tokens, every token supervised."""
    from grasp_any_region_tpu_torch.data.builders import PackedTextBatch, pack_text_batch
    from grasp_any_region_tpu_torch.train import make_packed_train_step

    rows, seq = 2, 4096
    rng = np.random.default_rng(SEED)
    docs, total = [], 0
    while total < rows * seq:
        n = int(rng.integers(300, 1200))
        docs.append(rng.integers(10, 1000, size=n).astype(np.int32))
        total += n
    packed = pack_text_batch(docs, seq_len=seq, labels=docs)
    packed = PackedTextBatch(*(x[:rows] for x in packed))
    n_docs = [int(r.max()) for r in packed.segment_ids.cpu()]
    step = make_packed_train_step(cfg, tx)
    for _ in range(2):
        state, _ = step(state, packed)
    n = 4
    events, losses = event_pairs(n + 1), []
    torch.cuda.synchronize()
    reset_counts()
    events[0].record()
    for i in range(n):
        state, metrics = step(state, packed)
        events[i + 1].record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    window, segs = read_counts(), segmented_counts()
    layers = cfg.text.num_layers
    expected = expect(**{"B": 2 * n * layers, "17": n * layers, "18": n * layers})
    if window != expected or segs != {"B": 2 * n * layers, "18": n * layers}:
        raise AssertionError(f"[packed] launches over {n} steps {window} (with segment ids "
                             f"{segs}), expected {expected}, B and 18 with segment ids")
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[packed] non-finite losses {losses}")
    times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    ms = statistics.median(times)
    log(f"[packed] {rows} rows x {seq} tokens ({n_docs} documents a row, then padding): "
        f"ms/step {ms:.1f} (median of {n}; steps {', '.join(f'{x:.1f}' for x in times)}), "
        f"{rows * seq / (ms / 1e3):.0f} tok/s; losses {[round(x, 4) for x in losses]}; "
        f"launches a step B = {2 * layers}, 17 = 18 = {layers}, B and 18 with segment ids")


def resize_native_vs_numpy(side: int = 1792) -> dict:
    """Host ms of the image processor's two bicubic resizes of a side^2
    uint8 image (the 448^2 thumbnail and the side^2 canvas), native (the
    default) against the numpy body; the outputs within 1e-9."""
    from grasp_any_region_tpu_torch.data.resize import resize_bicubic

    img = np.random.default_rng(SEED).integers(0, 256, (side, side, 3), dtype=np.uint8)
    out = {}
    for name, native in (("native", True), ("numpy", False)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = [resize_bicubic(img, n, n, use_native=native) for n in (448, side)]
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = (statistics.median(times), got)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(out["native"][1], out["numpy"][1]))
    if gap > 1e-9:
        raise AssertionError(f"[trainer] native resize leaves the numpy one by {gap:.3e}")
    return {"native_ms": out["native"][0], "numpy_ms": out["numpy"][0], "max_gap": gap}


def state_bits_equal(a, b, label: str) -> None:
    """Two TrainStates hold the same bits: every parameter, Adam moment and
    accumulated gradient, the update count, window position and step."""
    oa, ob = a.opt_state, b.opt_state
    if (a.step, oa.count, oa.mini_step) != (b.step, ob.count, ob.mini_step):
        raise AssertionError(f"{label}: step / count / mini_step {(a.step, oa.count, oa.mini_step)}"
                             f" vs {(b.step, ob.count, ob.mini_step)}")
    pairs = [(n, p, q) for (n, p), q in zip(a.params.named_parameters(), b.params.parameters())]
    pairs += [(f"{kind}/{i}", x, y) for kind in ("mu", "nu", "acc")
              for i, (x, y) in enumerate(zip(getattr(oa, kind), getattr(ob, kind)))]
    bad = [n for n, x, y in pairs if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} tensors differ, first {bad[:3]}")


def phase_trainer(smi: str) -> dict:
    """Training from an annotation file at GAR-1B: `cli.train.main` on 8
    synthetic items of 1344 x 1008 (base64 PNGs, RLE masks, the three item
    styles), bf16 params and moments, batch 1, accumulation 2: 4 steps,
    then a second `main` in the same work dir resumes at step 4 and runs to
    6, exports HF safetensors, and the export is read back through
    `convert_hf_state_dict`. Asserts the launches of every step (A = 46,
    5 = 23, B = 32, 17 = 18 = 39, every other kernel 0, no segment ids),
    finite losses, the restored state equal bit for bit to the state the
    first run saved, and the export equal to the trained params. Prints
    each step's loss, host ms, device ms (CUDA events) and host wait on the
    loader, tokens, peak memory, each checkpoint's bytes and seconds, the
    export's seconds, and native against numpy resize at 1792^2."""
    import shutil
    import tempfile

    from grasp_any_region_tpu_torch.cli import train as cli_train
    from grasp_any_region_tpu_torch.core.weights import (convert_hf_state_dict, flatten_params,
                                                         read_safetensors)
    from grasp_any_region_tpu_torch.data.dataset import DatasetConfig, GraspAnyRegionDataset
    from grasp_any_region_tpu_torch.data.synthetic import write_synthetic_annotations
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.train import export as export_mod
    from grasp_any_region_tpu_torch.train import trainer as trainer_mod

    from grasp_any_region_tpu_torch.core.config import gar_1b
    from grasp_any_region_tpu_torch.models.gar import GARParams

    cfg = gar_1b()
    n_params = sum(p.numel() for p in GARParams(cfg, device="meta").parameters())
    ckpt_bytes = 3 * 2 * n_params  # bf16 params and two moments
    root = tempfile.mkdtemp(prefix="gar_trainer_")
    free = shutil.disk_usage(root).free
    # steps 1 (mid-window: the accumulated gradient too), 4 and 6 on disk at
    # once, the fp32 export and the data
    need = ckpt_bytes * 10 // 3 + 4 * n_params + (1 << 30)
    log(f"[trainer] on {smi}: {n_params / 1e9:.3f} B params: a checkpoint is {ckpt_bytes / 2 ** 30:.2f} GiB; "
        f"{free / 2 ** 30:.1f} GiB free under {root}, {need / 2 ** 30:.1f} GiB needed")
    if free < need:
        shutil.rmtree(root)
        raise AssertionError(f"[trainer] {free / 2 ** 30:.1f} GiB free, "
                             f"{need / 2 ** 30:.1f} needed")
    try:
        rs = resize_native_vs_numpy()
        log(f"[trainer] resize of a 1792^2 uint8 image to 448^2 and 1792^2 (host ms, median of 3): "
            f"native {rs['native_ms']:.1f}, numpy {rs['numpy_ms']:.1f} "
            f"({rs['numpy_ms'] / rs['native_ms']:.1f}x); max gap {rs['max_gap']:.2e}")
        t0 = time.perf_counter()
        ann = write_synthetic_annotations(os.path.join(root, "ann.json"), n_items=8,
                                          image_size=(1344, 1008), seed=SEED)
        write_s = time.perf_counter() - t0
        ds = GraspAnyRegionDataset(cfg, GARTokenizer.synthetic(cfg.prompt_numbers),
                                   DatasetConfig(annotation_paths=[ann]))
        t0 = time.perf_counter()
        items = [ds.build_item(i) for i in range(len(ds))]
        build_ms = (time.perf_counter() - t0) * 1e3 / len(items)
        tiles = [int(it["num_tiles"]) for it in items]
        tokens = [len(it["input_ids"]) for it in items]
        log(f"[trainer] {len(items)} items of 1344 x 1008 written in {write_s:.1f} s "
            f"({os.path.getsize(ann) / 2 ** 20:.1f} MiB); tiles {tiles}, tokens {tokens}, "
            f"regions {[len(it['replay_pos']) for it in items]}; {build_ms:.0f} host ms an item "
            "(PNG decode, RLE decode, tiling, template)")
        del items, ds

        records = []
        real_make_step = trainer_mod.make_train_step
        real_export = export_mod.export_hf_checkpoint
        check_first = {}

        def make_step(*a, **k):
            step = real_make_step(*a, **k)

            def counted(state, batch, labels):
                if "saved" in check_first:  # the resumed state, before its first step
                    state_bits_equal(state, check_first.pop("saved"), "[trainer] restored state")
                    log(f"[trainer] the restored step-{state.step} state equals the saved one "
                        "bit for bit (params, mu, nu, acc, count, mini_step)")
                start, end = event_pairs(2)
                reset_counts()
                start.record()
                out = step(state, batch, labels)
                end.record()
                records.append(dict(counts=read_counts(), segs=segmented_counts(),
                                    events=(start, end), tokens=int(batch.segment_ids.sum()),
                                    padded=batch.input_ids.shape[1],
                                    tiles=int(batch.num_tiles.sum())))
                return out

            return counted

        export_s = []

        def timed_export(*a, **k):
            t0 = time.perf_counter()
            real_export(*a, **k)
            export_s.append(time.perf_counter() - t0)

        work, export = os.path.join(root, "work"), os.path.join(root, "hf")
        args = ["--preset", "gar_1b", "--data", ann, "--work-dir", work, "--dtype", "bfloat16",
                "--batch-size", "1", "--accumulation", "2", "--log-interval", "1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with patched((trainer_mod, "make_train_step", make_step),
                     (export_mod, "export_hf_checkpoint", timed_export)):
            t0 = time.perf_counter()
            first = cli_train.main(args + ["--max-steps", "4"])
            first_s = time.perf_counter() - t0
            check_first["saved"] = first.state
            t0 = time.perf_counter()
            second = cli_train.main(args + ["--max-steps", "6", "--export-hf", export])
            second_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if "saved" in check_first or [h["step"] for h in second.history] != [5, 6]:
            raise AssertionError(f"[trainer] the second run did not resume at step 4: steps "
                                 f"{[h['step'] for h in second.history]}")
        history = first.history + second.history
        depth, layers = cfg.vision.depth, cfg.text.num_layers
        want = expect(**{"A": 2 * depth, "5": depth, "B": 2 * layers, "17": layers + depth,
                         "18": layers + depth})
        for h, r in zip(history, records):
            if r["counts"] != want or r["segs"] != {"B": 0, "18": 0}:
                raise AssertionError(f"[trainer] step {h['step']} launched {r['counts']} "
                                     f"(segment ids {r['segs']}), expected {want}")
        losses = [h["loss"].item() for h in history]
        if len(records) != 6 or not all(np.isfinite(losses)):
            raise AssertionError(f"[trainer] {len(records)} steps, losses {losses}")
        for h, r in zip(history, records):
            dev_ms = r["events"][0].elapsed_time(r["events"][1])
            log(f"[trainer] step {h['step']}: loss {h['loss'].item():.4f}, iteration "
                f"{h['iter_s'] * 1e3:.0f} host ms, device step {dev_ms:.0f} ms (CUDA events), "
                f"host wait on the loader {h['wait_s'] * 1e3:.1f} ms; {r['tiles']} tiles, "
                f"{r['tokens']} tokens ({r['padded']} padded)")
        log(f"[trainer] launches a step {want}; peak memory {peak_gib:.2f} GiB; runs "
            f"{first_s:.1f} s (init, 4 steps, 2 checkpoints) and {second_s:.1f} s (init, "
            f"restore, 2 steps, 1 checkpoint, export)")
        for run, tr in (("first", first), ("second", second)):
            for rec in tr.ckpt.saves:
                log(f"[trainer] {run} run's checkpoint of step {rec['step']}: "
                    f"{rec['bytes'] / 2 ** 30:.2f} GiB, host copy {rec['copy_s']:.2f} s, "
                    f"write {rec['write_s']:.2f} s (a background thread)")
        t0 = time.perf_counter()
        back = flatten_params(convert_hf_state_dict(cfg, read_safetensors(
            os.path.join(export, "model.safetensors"))))
        read_s = time.perf_counter() - t0
        vocab = cfg.extended_vocab_size
        named = dict(second.state.params.named_parameters())
        if sorted(back) != sorted(n.replace(".", "/") for n in named):
            raise AssertionError("[trainer] the export holds other names than the params")
        for name, p in named.items():
            got = torch.from_numpy(back[name.replace(".", "/")]).to(p.device)
            want_p = p.detach().float()
            if name == "llm.embed":  # the export holds the vocabulary's rows only
                if got[vocab:].any():
                    raise AssertionError("[trainer] the export's padding rows read back non-zero")
                got, want_p = got[:vocab], want_p[:vocab]
            if not torch.equal(got, want_p):
                raise AssertionError(f"[trainer] {name}: the export does not read back to it")
        export_gib = os.path.getsize(os.path.join(export, "model.safetensors")) / 2 ** 30
        log(f"[trainer] export {export_s[0]:.2f} s ({export_gib:.2f} GiB fp32), read back "
            f"through convert_hf_state_dict in {read_s:.2f} s: every tensor equals the trained "
            "params")
        return dict(losses=losses, resize=rs, peak_gib=peak_gib)
    finally:
        shutil.rmtree(root, ignore_errors=True)


KERNELS = {
    "A": ("vit_attention", "grasp_any_region_tpu_torch/csrc/flash_forward_sm90.cu",
          "grasp_any_region_tpu/ops/vit_attention.py:350"),
    "B": ("flash_attention", "grasp_any_region_tpu_torch/csrc/flash_forward_sm90.cu",
          "grasp_any_region_tpu/ops/flash_attention.py:247"),
    "C": ("decode_attention_fused", "grasp_any_region_tpu_torch/csrc/decode_split.cuh",
          "grasp_any_region_tpu/ops/decode_attention.py:373"),
    "D": ("vit_ln_qkv", "grasp_any_region_tpu_torch/csrc/vit_block.cu",
          "grasp_any_region_tpu/ops/vit_block.py:122"),
    "E": ("vit_attention_fused_qkv", "grasp_any_region_tpu_torch/csrc/flash_forward_sm90.cu",
          "grasp_any_region_tpu/ops/vit_attention.py:301"),
    "F": ("vit_wo_residual", "grasp_any_region_tpu_torch/csrc/gemm_sm90.cu",
          "grasp_any_region_tpu/ops/vit_block.py:172"),
    "G": ("vit_mlp_residual", "grasp_any_region_tpu_torch/csrc/vit_block.cu",
          "grasp_any_region_tpu/ops/vit_block.py:245"),
    "H": ("layer_matmul", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:58"),
    "I": ("layer_swiglu", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:97"),
    "J": ("layer_qkv", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:142"),
    "C8": ("decode_attention_fused_q8", "grasp_any_region_tpu_torch/csrc/decode_split.cuh",
           "grasp_any_region_tpu/ops/decode_attention.py:477"),
    "H8": ("layer_matmul_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:190"),
    "I8": ("layer_swiglu_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:234"),
    "J8": ("layer_qkv_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:282"),
    "5": ("vit_attention_bwd", "grasp_any_region_tpu_torch/csrc/flash_backward_sm90.cu",
          "grasp_any_region_tpu/ops/vit_attention.py:185"),
    "16": ("decode_attention_stacked", "grasp_any_region_tpu_torch/csrc/decode_split.cuh",
           "grasp_any_region_tpu/ops/decode_attention.py:598"),
    "17": ("flash_attention_bwd_prep_cast",
           "grasp_any_region_tpu_torch/csrc/flash_backward_sm90.cu",
           "grasp_any_region_tpu/ops/flash_backward.py:369"),
    "18": ("flash_attention_bwd_dkv", "grasp_any_region_tpu_torch/csrc/flash_backward_sm90.cu",
           "grasp_any_region_tpu/ops/flash_backward.py:403"),
    "19": ("layer_qkv_norm_rope", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
           "grasp_any_region_tpu/ops/decode_megakernel.py:126"),
    "20": ("layer_qkv_norm_rope_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu",
           "grasp_any_region_tpu/ops/decode_megakernel.py:194"),
    "21": ("layer_mlp_residual_q8", "grasp_any_region_tpu_torch/csrc/decode_mlp_sm90.cu",
           "grasp_any_region_tpu/ops/decode_megakernel.py:272"),
    "22": ("decode_attention_wo", "grasp_any_region_tpu_torch/csrc/decode_attn_wo_sm90.cu",
           "grasp_any_region_tpu/ops/decode_megakernel.py:478"),
    "23": ("layer_mlp_residual", "grasp_any_region_tpu_torch/csrc/decode_mlp_sm90.cu",
           "grasp_any_region_tpu/ops/decode_megakernel.py:569"),
    "24": ("layer_norm_fused", "grasp_any_region_tpu_torch/csrc/layer_norm.cu",
           "grasp_any_region_tpu/ops/norms.py:66"),
}


def main() -> int:
    smi = phase_environment()
    log(smi)
    from grasp_any_region_tpu_torch.core.config import gar_1b

    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    kernels = phase_kernels()
    phase_cross_check(narrow_config())
    phase_cross_check(narrow_config(kv_heads=2), int8=True)
    phase_cross_check(narrow_config(), mega=True)
    phase_cross_check(narrow_config(kv_heads=2), int8=True, mega=True)
    phase_train_cross_check(narrow_config(kv_heads=2))
    phase_serving_cross_check()
    cfg = gar_1b()
    params = random_params(cfg, "cuda")
    params_q8 = quantize_decode_weights(params)
    unfused_counts = phase_vision_forms(cfg, params)
    phase_decode_forms(cfg, params, params_q8)
    main_counts, tokens = phase_main_path(cfg, params)
    int8_counts, tokens_q8 = phase_main_path(cfg, params, params_q8)
    mega_caption, _ = phase_main_path(cfg, params, mega=True, fused_tokens=tokens)
    mega_q8_caption, _ = phase_main_path(cfg, params, params_q8, mega=True,
                                         fused_tokens=tokens_q8)
    del params_q8
    torch.cuda.empty_cache()
    phase_runtime(smi)
    eval_fig = phase_eval(smi)
    phase_sam_speculative(smi)
    serving_runs = phase_serving(cfg, params)
    torch.cuda.empty_cache()
    train_counts, state, tx = phase_train_step(cfg, params)
    phase_packed_step(cfg, state, tx)
    del state, tx, params
    torch.cuda.empty_cache()
    phase_trainer(smi)
    torch.cuda.empty_cache()
    # GAR-8B: the narrow cross-checks (bf16, then int8 weights on a bf16
    # cache: C8 has no head-dim-128 instance), then the caption at full width
    phase_cross_check(narrow_8b_config())
    phase_cross_check(narrow_8b_config(), int8=True, int8_cache=False)
    gar8b_counts = phase_gar8b(int8=False)
    gar8b_q8_counts = phase_gar8b(int8=True)
    gar8b_train_counts = phase_gar8b_train()
    # the path whose run reports each kernel's launches: kernel A the
    # unfused tower's, the backward kernels the train step's, the mega
    # kernels their generate(GAR_DECODE_PATH=mega)'s, the int8 kernels the
    # int8 path's generate, the others generate's; 16 and 24 lie on no JAX
    # path, so generate's run reports their 0
    paths = {"A": ("vision_forward(fused_blocks=False)", unfused_counts),
             **dict.fromkeys(("16", "24"), ("phase 2 only: no JAX path dispatches it",
                                            main_counts)),
             **dict.fromkeys(("5", "17", "18"), ("train_step", train_counts)),
             **dict.fromkeys(("19", "22", "23"), ("generate(mega)", mega_caption)),
             **dict.fromkeys(("20", "21"), ("generate(mega, int8 weights)", mega_q8_caption)),
             **dict.fromkeys(("C8", "H8", "I8", "J8"), ("generate(int8)", int8_counts))}
    paths = {key: paths.get(key, ("generate", main_counts)) for key in KERNELS}
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, path=paths[key][0],
             launches=paths[key][1][key], **{f: kernels[key][f] for f in fields})
        for key, (name, src, rep) in KERNELS.items()
    ]
    # the kernels on GAR-8B's paths also carry their figures at its shapes
    # and their launches per 8B caption (the int8 ones on the int8 caption;
    # 5, 17 and 18 per 8B LoRA train step)
    for row, key in zip(table, KERNELS):
        if "gar8b" in kernels[key]:
            if key in ("5", "17", "18"):  # per 8B LoRA train step
                g8_path, g8_counts = "train_step(gar_8b, lora_only)", gar8b_train_counts
            elif key.endswith("8"):
                g8_path, g8_counts = "generate(gar_8b, init_gar_serving_int8)", gar8b_q8_counts
            else:
                g8_path, g8_counts = "generate(gar_8b)", gar8b_counts
            row["path"] += f"; gar8b: {g8_path}"
            row["gar8b"] = dict(path=g8_path, launches=g8_counts[key],
                                **{f: kernels[key]["gar8b"][f] for f in fields})
    # the kernels on the serving path also name it, with their launches per
    # served batch (the bf16 run's; the int8 kernels the int8 16-slot run's)
    # and their figures at its shapes (phase 2)
    for row, key in zip(table, KERNELS):
        if key in SERVING_KEYS:
            run = "int8 16-slot" if key.endswith("8") else "bf16"
            s_path = f"ContinuousBatchingEngine (serving {run})"
            row["path"] += f"; serving: {s_path}"
            row["serving"] = dict(path=s_path, launches=serving_runs[run]["counts"][key],
                                  shapes=kernels[key].get("serving", {}))
    # the eval path's kernels name it with their launches over all eval
    # batches (B and C also their rows at an eval batch's shapes), the int8
    # kernels parity's int8 repeat with its launches
    for row, key in zip(table, KERNELS):
        if key in EVAL_KEYS:
            row["path"] += f"; eval: {EVAL_PATH}"
            row["eval"] = dict(path=EVAL_PATH, launches=eval_fig["launches"][key],
                               batches=len(eval_fig["steps"]), decode_steps=eval_fig["steps"])
            if key in eval_fig["rows"]:
                row["eval"]["shapes"] = eval_fig["rows"][key]
        if key in PARITY_KEYS:
            row["path"] += f"; parity: {PARITY_PATH}"
            row["parity"] = dict(path=PARITY_PATH, launches=eval_fig["parity_counts"][key])
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
