"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Imports no jax. Phases, each printing its own lines; any failure raises and
the script exits non-zero (there is no CPU fallback):

1. Environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions; builds the CUDA kernels from csrc/ and prints the
   build time.
2. Each kernel against its plain PyTorch version at GAR-1B shapes, on
   seeded bf16 inputs (the plain version in fp32 from the same inputs),
   atol = rtol = 2e-2 (bf16 p before PV, bf16 LayerNorm and GELU outputs
   before their products, bf16 output); median times of kernel and plain
   version from CUDA events. E also at a ragged S = 200. The decode
   matmuls H, I, J also at B = 24 (with their GB/s, cuBLAS's bf16 product
   and the card's copy rate on the same bytes) and at the narrow config's
   ragged widths.
3. End-to-end cross-check on a narrow gar_1b (ViT width 256, decoder
   hidden 256, 2 layers each, head dim 64): the same seeded bf16 params on
   the card (kernel path: the fused ViT and the fused decode step) and on
   the CPU (plain path: the unfused ViT, the XLA-form decode step);
   prefill logits and the first 4 decode-step logits must agree.
4. Vision forms: the gar_1b tower over 17 tiles in the fused form (kernels
   D, E, F, G) and the unfused form (kernel A) on the same params and
   inputs; their outputs must agree to 5e-2 of the output range, and each
   form must launch its kernels once per layer.
5. Decode forms: one gar_1b decode step over the main path's seeded cache
   in the fused form (kernels J, C, H, I, H a layer) and in the XLA form
   (cuBLAS products around C), from the same input embedding; hidden and
   written K/V must agree to 5e-2 of their range; device and host ms per
   step of each form.
6. Main path: gar_1b with seeded random weights, one 17-tile image, one
   region, a 4662-token prompt and 256 greedy tokens through `generate`;
   ms per caption split into vision, prefill and decode, and the kernel
   launch counts of one caption, which must be D = E = F = G = 23 (the
   fused ViT), A = 0, B = 16, C = I = J = 16 * 255, H = 2 * 16 * 255 (the
   fused decode step).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

TOL = 2e-2  # atol = rtol for kernel vs plain at bf16
E2E_TOL = 5e-2  # max |logit difference| / max |logit|, kernel path vs plain path
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-call device times (CUDA events) after warm-up. The L2
    cache (50 MB on an H100) is flushed before each timed call: on the main
    path every decode layer reads its own cache slab, so the kernels find
    their inputs cold, and a warm repeat would flatter them. The card then
    sleeps for ~0.5 ms, so the host has queued the call before the card
    reaches it: a call of a few microseconds would otherwise be timed at
    the host's pace of issuing it."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(out: torch.Tensor, ref: torch.Tensor, name: str) -> float:
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, atol=TOL, rtol=TOL):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |diff| {err:.3e} (atol = rtol = {TOL})")
    return err


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_kernels():
    from grasp_any_region_tpu_torch.ops import decode_attention as dec
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import vit_attention as va

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    results = {}

    # A: ViT attention, 17 tiles x 1025 tokens x 16 heads
    q, k, v = rnd(17, 1025, 16, 64), rnd(17, 1025, 16, 64), rnd(17, 1025, 16, 64)
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    err = max_err(out, va.vit_attention_plain(q.float(), k.float(), v.float()), "A")
    results["A"] = dict(max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention(q, k, v)),
                        plain_ms=cuda_ms(lambda: va.vit_attention_plain(q, k, v), iters=5))
    del q, k, v, out

    # B: causal prefill, 4662 tokens, 32 query heads over 8 kv heads
    q, k, v = rnd(1, 4662, 32, 64), rnd(1, 4662, 8, 64), rnd(1, 4662, 8, 64)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    err = max_err(out, ref, "B")
    results["B"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5))
    del q, k, v, out, ref

    # C: decode step over layer 7 of a (16, 2, 8, 5120, 64) cache
    layer, pad, wpos = 7, 4662, 4700
    k_all, v_all = rnd(16, 2, 8, 5120, 64), rnd(16, 2, 8, 5120, 64)
    q, k_new, v_new = rnd(2, 32, 64), rnd(2, 8, 64), rnd(2, 8, 64)
    plens = torch.tensor([4662, 4000], dtype=torch.int32, device="cuda")
    wp = torch.tensor(wpos, dtype=torch.int32, device="cuda")
    k_ref, v_ref = k_all.clone(), v_all.clone()
    kw = dict(prompt_lens=plens, write_pos=wp, prompt_pad=pad)
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    torch.cuda.synchronize()
    ref = dec.decode_attention_fused_plain(
        q.float(), k_ref[layer:layer + 1].float(), v_ref[layer:layer + 1].float(),
        k_new.float(), v_new.float(), 0, **kw)
    err = max_err(out, ref, "C")
    if not (torch.equal(k_all[layer, :, :, wpos], k_new)
            and torch.equal(v_all[layer, :, :, wpos], v_new)):
        raise AssertionError("C: column write_pos does not hold the new K/V")
    k_ref[layer, :, :, wpos], v_ref[layer, :, :, wpos] = k_new, v_new
    if not (torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)):
        raise AssertionError("C: the kernel changed cache entries other than column write_pos")
    results["C"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)),
        plain_ms=cuda_ms(lambda: dec.decode_attention_fused_plain(
            q, k_all, v_all, k_new, v_new, layer, **kw)))
    del k_all, v_all, k_ref, v_ref
    results.update(vit_block_kernels(rnd, gen))
    results.update(decode_matmul_kernels(rnd))
    for name, r in results.items():
        log(f"[kernels] {name}: max |kernel - plain| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return results


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
        err = max_err(out, va.vit_attention_fused_qkv_plain(qkv.float(), cos, sin, h, 64),
                      f"E (S = {seq})")
    results["E"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)),
        plain_ms=cuda_ms(lambda: va.vit_attention_fused_qkv_plain(qkv, cos, sin, h, 64),
                         iters=5))
    del qkv, cos, sin, out

    x, attn = rnd(t, s, d), rnd(t, s, d)
    ln = (1.0 + w(d, scale=0.2), w(d, scale=0.2))
    wqkv, bqkv = w(d, 3 * d, scale=d ** -0.5), w(3 * d, scale=0.1)
    wo, bo, ls1 = w(d, d, scale=d ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    fc1, b1 = w(d, m, scale=d ** -0.5), w(m, scale=0.1)
    fc2, b2, ls2 = w(m, d, scale=m ** -0.5), w(d, scale=0.1), w(d, scale=0.5)
    cases = {
        "D": (vb.vit_ln_qkv, vb.vit_ln_qkv_plain, (x, *ln, wqkv, bqkv), {}),
        "F": (vb.vit_wo_residual, vb.vit_wo_residual_plain, (attn, x, wo, bo, ls1), {}),
        "G": (vb.vit_mlp_residual, vb.vit_mlp_residual_plain,
              (x, *ln, fc1, b1, fc2, b2, ls2), dict(fast_gelu=True)),
    }
    for name, (kernel, plain, args, kw) in cases.items():
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = max_err(out, plain(*(a.float() for a in args), **kw), name)
        results[name] = dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*args, **kw)),
                             plain_ms=cuda_ms(lambda: plain(*args, **kw), iters=5))
        del out
    return results


def decode_matmul_kernels(rnd):
    """Kernels H, I, J at the gar_1b decode shapes (hidden 2048, q 2048, kv
    512, MLP 8192), the weights stacked (16, Din, Dout) and read at layer 7.
    H runs at both the wo and the w_down width; its entry carries w_down.
    Checked against the plain version at B = 24 and B = 1 (the kernels
    line carries B = 1), and at the narrow config's ragged widths (hidden
    256, q 256, kv 64, MLP 1024) at B = 1 and 5. Beside each time: the
    weight bytes over it, cuBLAS's bf16 product of the same layer (the
    XLA form's ops), and a device-to-device copy of the same bytes."""
    import torch.nn.functional as F
    from grasp_any_region_tpu_torch.ops import layer_matmul as lm

    def calls(d, m, hq, hk, n_layers):
        def stack(din, n):
            return (rnd(n_layers, din, n).float() * din ** -0.5).to(torch.bfloat16)

        wq, wk, wv, wo = stack(d, hq), stack(d, hk), stack(d, hk), stack(hq, d)
        wg, wu, wd = stack(d, m), stack(d, m), stack(m, d)
        return {  # label: (key, kernel, plain, cuBLAS form, weights, Din)
            "H wo": ("H", lm.layer_matmul, lm.layer_matmul_plain,
                     lambda x, w, i: x @ w[i], (wo,), hq),
            "I": ("I", lm.layer_swiglu, lm.layer_swiglu_plain,
                  lambda x, g, u, i: F.silu(x @ g[i]) * (x @ u[i]), (wg, wu), d),
            "J": ("J", lm.layer_qkv, lm.layer_qkv_plain,
                  lambda x, a, b, c, i: (x @ a[i], x @ b[i], x @ c[i]), (wq, wk, wv), d),
            "H w_down": ("H", lm.layer_matmul, lm.layer_matmul_plain,
                         lambda x, w, i: x @ w[i], (wd,), m),
        }

    def check(label, kernel, plain, ws, layer, x):
        out = kernel(x, *ws, layer)
        torch.cuda.synchronize()
        ref = plain(x.float(), *(w[layer:layer + 1].float() for w in ws), 0)
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        return max(max_err(o, r, f"{label} (B = {x.shape[0]})") for o, r in zip(outs, refs))

    for label, (_, kernel, plain, _, ws, din) in calls(256, 1024, 256, 64, 2).items():
        for b in (1, 5):
            check(f"{label}, narrow", kernel, plain, ws, 1, rnd(b, din))

    layer, results = 7, {}
    for label, (key, kernel, plain, cublas, ws, din) in calls(2048, 8192, 2048, 512, 16).items():
        n_bytes = sum(w[layer].numel() * w.element_size() for w in ws)
        src = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(lambda: dst.copy_(src))
        for b in (24, 1):
            x = rnd(b, din)
            err = check(label, kernel, plain, ws, layer, x)
            ms = cuda_ms(lambda: kernel(x, *ws, layer))
            blas_ms = cuda_ms(lambda: cublas(x, *ws, layer))
            plain_ms = cuda_ms(lambda: plain(x, *ws, layer), iters=5)
            log(f"[kernels] {label}, B = {b}: {ms:.4f} ms = {n_bytes / ms / 1e6:.0f} GB/s of "
                f"weights ({n_bytes / 1e6:.1f} MB); cuBLAS bf16 {blas_ms:.4f} ms "
                f"({n_bytes / blas_ms / 1e6:.0f} GB/s); plain fp32 {plain_ms:.4f} ms; copy of "
                f"the same bytes {copy_ms:.4f} ms (moves 2x: {2 * n_bytes / copy_ms / 1e6:.0f} "
                f"GB/s); max |kernel - plain| {err:.3e}")
        if label != "H wo":  # B = 1 at the last width of each kernel goes in the line
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del src, dst
    return results


def narrow_config():
    from grasp_any_region_tpu_torch.core.config import gar_1b

    cfg = gar_1b()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, width=256, num_heads=4, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=256, num_heads=4, num_kv_heads=1,
                                 head_dim=64, num_layers=2, intermediate_size=1024),
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
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch

    batch, _, prompt_lens = synthetic_batch(cfg, batch=1, grid=(4, 4), regions=1,
                                            seed=SEED, device=device)
    return batch, prompt_lens


@torch.inference_mode()
def phase_cross_check(cfg):
    from grasp_any_region_tpu_torch.models.gar import (
        gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.llama import lm_logits

    p_cpu = random_params(cfg, "cpu")
    runs = []  # logits per path: prefill, then 4 decode steps
    tokens = None
    for dev, params in (("cuda", copy.deepcopy(p_cpu).to("cuda")), ("cpu", p_cpu)):
        batch, plens = bench_batch(cfg, dev)
        s = batch.input_ids.shape[1]
        hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
        logits = [lm_logits(params.llm, cfg.text, hidden[:, -1],
                            valid_vocab=cfg.extended_vocab_size).float().cpu()]
        cache = seed_cache_from_prefill(cfg, kv, plens, ((s + 4 + 511) // 512) * 512)
        # both paths decode the card's greedy tokens, so the steps stay comparable
        feed = tokens if tokens is not None else [int(logits[0].argmax())]
        for step in range(4):
            tok = torch.tensor([feed[step]], dtype=torch.int32, device=dev)
            lg, cache = gar_decode_step(params, cfg, tok, cache, s)
            logits.append(lg.float().cpu())
            if tokens is None:
                feed.append(int(lg.argmax()))
        tokens = feed
        runs.append(logits)
    worst = 0.0
    for i, (a, b) in enumerate(zip(*runs)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"cross-check: non-finite logits at step {i}")
        valid = slice(0, cfg.extended_vocab_size)
        rel = ((a[..., valid] - b[..., valid]).abs().max() / b[..., valid].abs().max()).item()
        worst = max(worst, rel)
        log(f"[cross-check] step {i}: max |card - cpu| / max |cpu| = {rel:.3e}, "
            f"greedy card {int(a.argmax())}, cpu {int(b.argmax())}")
    if worst > E2E_TOL:
        raise AssertionError(f"cross-check: kernel path and plain path differ by {worst:.3e} "
                             f"> {E2E_TOL} of the logit range")
    log(f"[cross-check] fed tokens {tokens}; worst relative logit error {worst:.3e} "
        f"<= {E2E_TOL}")


def counter_modules():
    """The wrapper modules whose launch counters the phases read."""
    from grasp_any_region_tpu_torch.ops import decode_attention, flash_attention, layer_matmul
    from grasp_any_region_tpu_torch.ops import vit_attention, vit_block

    return decode_attention, flash_attention, vit_attention, vit_block, layer_matmul


def reset_counts():
    dec, fa, va, vb, lm = counter_modules()
    va.launches = va.launches_fused = fa.launches = dec.launches = 0
    vb.launches.update(D=0, F=0, G=0)
    lm.launches.update(H=0, I=0, J=0)


def read_counts():
    dec, fa, va, vb, lm = counter_modules()
    return dict(A=va.launches, B=fa.launches, C=dec.launches, D=vb.launches["D"],
                E=va.launches_fused, F=vb.launches["F"], G=vb.launches["G"], **lm.launches)


def expect(**counts):
    """Launch counts of kernels A-J: the given ones, 0 for the rest."""
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


@torch.inference_mode()
def phase_decode_forms(cfg, params):
    """One gar_1b decode step in each form from one seeded cache (the main
    path's: B = 1, the 4662-token prompt, 5120 columns) and the same input
    embedding, each form on its own copy of the cache."""
    from grasp_any_region_tpu_torch.models.gar import gar_prefill, seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.llama import (
        KVCache, embed_tokens, llama_decode_step, lm_logits)

    batch, plens = bench_batch(cfg, "cuda")
    s = batch.input_ids.shape[1]
    hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
    first = lm_logits(params.llm, cfg.text, hidden[:, -1],
                      valid_vocab=cfg.extended_vocab_size).argmax(-1)
    seeded = seed_cache_from_prefill(cfg, kv, plens, ((s + 256 + 511) // 512) * 512)
    del hidden, kv
    emb = embed_tokens(params.llm, first[:, None])
    n_layers = cfg.text.num_layers
    expected = dict(fused=expect(C=n_layers, H=2 * n_layers, I=n_layers, J=n_layers),
                    xla=expect(C=n_layers))
    outs, counts, times = {}, {}, {}
    for form, use_kernel in (("fused", "fused"), ("xla", False)):
        cache = KVCache(seeded.k.clone(), seeded.v.clone(), seeded.prompt_lens,
                        seeded.write_pos.clone())

        def step():
            return llama_decode_step(params.llm, cfg.text, emb, cache, s, use_kernel=use_kernel)

        reset_counts()
        hidden, _ = step()
        torch.cuda.synchronize()
        counts[form] = read_counts()
        outs[form] = (hidden.float(), cache.k[:, :, :, s].float(), cache.v[:, :, :, s].float())
        times[form] = step_times(step)
    if counts != expected:
        raise AssertionError(f"decode forms: launch counts per step {counts}, "
                             f"expected {expected}")
    worst = 0.0
    for name, fused, xla in zip(("hidden", "K column", "V column"), outs["fused"], outs["xla"]):
        if fused.shape != xla.shape or not torch.isfinite(fused).all():
            raise AssertionError(f"decode forms: fused {name} {tuple(fused.shape)} "
                                 "or non-finite")
        rel = ((fused - xla).abs().max() / xla.abs().max()).item()
        worst = max(worst, rel)
        log(f"[decode] max |fused - xla| / max |xla| over the {name}: {rel:.3e}")
    for form, (dev_ms, host_ms) in times.items():
        log(f"[decode] {form} form: {dev_ms:.3f} ms device, {host_ms:.3f} ms host per step; "
            f"launches per step {counts[form]}")
    if worst > E2E_TOL:
        raise AssertionError(f"decode forms differ by {worst:.3e} > {E2E_TOL} of the range")


def phase_main_path(cfg, params):
    from grasp_any_region_tpu_torch.models.gar import encode_images, gar_prefill
    from grasp_any_region_tpu_torch.models.generate import generate
    from grasp_any_region_tpu_torch.models.llama import lm_logits

    new_tokens = 256
    batch, plens = bench_batch(cfg, "cuda")
    b, s = batch.input_ids.shape
    log(f"[main] B={b}, {batch.pixel_values.shape[1]} tiles, prompt {s} tokens, "
        f"{new_tokens} new tokens")

    def run():
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = generate(params, cfg, batch, plens, max_new_tokens=new_tokens, eot_id=-1,
                       mask_compat=False)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), read_counts()

    depth, steps = cfg.vision.depth, cfg.text.num_layers * (new_tokens - 1)
    expected = expect(B=cfg.text.num_layers, C=steps, D=depth, E=depth, F=depth, G=depth,
                      H=2 * steps, I=steps, J=steps)
    run()  # warm-up
    times, counts, out = [], None, None
    for _ in range(3):
        out, ms, counts = run()
        times.append(ms)
        if counts != expected:
            raise AssertionError(f"launch counts {counts}, expected {expected}")
    toks = out.tokens
    if toks.shape != (b, new_tokens):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if not ((toks >= 0) & (toks < cfg.extended_vocab_size)).all():
        raise AssertionError("a generated token is outside the valid vocab")

    # the split, timed on the same inputs: vision (the tower, projector
    # included), prefill (gar_prefill without the vision part), decode (the rest)
    pix = batch.pixel_values.reshape((-1,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((-1,) + batch.mask_values.shape[2:])
    with torch.inference_mode():
        vision_ms = cuda_ms(lambda: encode_images(params, cfg, pix, msk, mask_compat=False),
                            iters=3, warmup=1)
        prefill_total_ms = cuda_ms(lambda: gar_prefill(params, cfg, batch, mask_compat=False),
                                   iters=3, warmup=1)
        hidden, _ = gar_prefill(params, cfg, batch, mask_compat=False)
        logits = lm_logits(params.llm, cfg.text, hidden[:, -1],
                           valid_vocab=cfg.extended_vocab_size)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    total_ms = statistics.median(times)
    decode_ms = total_ms - prefill_total_ms
    log(f"[main] ms/caption {total_ms:.1f} (runs {', '.join(f'{t:.1f}' for t in times)}): "
        f"vision {vision_ms:.1f}, prefill {prefill_total_ms - vision_ms:.1f}, "
        f"decode {decode_ms:.1f}")
    log(f"[main] decode {b * (new_tokens - 1) / (decode_ms / 1e3):.1f} tok/s; "
        f"{b / (total_ms / 1e3):.3f} captions/s")
    log(f"[main] launches per caption {counts} (expected {expected}); "
        f"first tokens {toks[0, :8].tolist()}")
    return counts


KERNELS = {
    "A": ("vit_attention", "grasp_any_region_tpu_torch/csrc/vit_attention.cu",
          "grasp_any_region_tpu/ops/vit_attention.py:350"),
    "B": ("flash_attention", "grasp_any_region_tpu_torch/csrc/flash_attention.cu",
          "grasp_any_region_tpu/ops/flash_attention.py:247"),
    "C": ("decode_attention_fused", "grasp_any_region_tpu_torch/csrc/decode_attention.cu",
          "grasp_any_region_tpu/ops/decode_attention.py:373"),
    "D": ("vit_ln_qkv", "grasp_any_region_tpu_torch/csrc/vit_block.cu",
          "grasp_any_region_tpu/ops/vit_block.py:122"),
    "E": ("vit_attention_fused_qkv", "grasp_any_region_tpu_torch/csrc/vit_attention.cu",
          "grasp_any_region_tpu/ops/vit_attention.py:301"),
    "F": ("vit_wo_residual", "grasp_any_region_tpu_torch/csrc/vit_block.cu",
          "grasp_any_region_tpu/ops/vit_block.py:172"),
    "G": ("vit_mlp_residual", "grasp_any_region_tpu_torch/csrc/vit_block.cu",
          "grasp_any_region_tpu/ops/vit_block.py:245"),
    "H": ("layer_matmul", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:58"),
    "I": ("layer_swiglu", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:97"),
    "J": ("layer_qkv", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
          "grasp_any_region_tpu/ops/layer_matmul.py:142"),
}


def main() -> int:
    smi = phase_environment()
    log(smi)
    from grasp_any_region_tpu_torch.core.config import gar_1b

    kernels = phase_kernels()
    phase_cross_check(narrow_config())
    cfg = gar_1b()
    params = random_params(cfg, "cuda")
    unfused_counts = phase_vision_forms(cfg, params)
    phase_decode_forms(cfg, params)
    main_counts = phase_main_path(cfg, params)
    # kernel A runs on the unfused tower's path, the others on generate's
    paths = {key: ("vision_forward(fused_blocks=False)", unfused_counts) if key == "A"
             else ("generate", main_counts) for key in KERNELS}
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, path=paths[key][0],
             launches=paths[key][1][key], max_abs_err=kernels[key]["max_abs_err"],
             ms=kernels[key]["ms"], plain_ms=kernels[key]["plain_ms"])
        for key, (name, src, rep) in KERNELS.items()
    ]
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
