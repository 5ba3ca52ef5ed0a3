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
   torch._weight_int8pack_mm for H8), that call's time. E
   also at a ragged S = 200. The decode matmuls H, I, J and their int8
   forms H8, I8, J8 also at B = 24 (with their GB/s of weights, cuBLAS's
   bf16 product of the same layer and the card's copy rate on the same
   bytes) and at the narrow config's ragged widths. C8 (int8 KV) at the
   main path's cache, B = 1 and 5120 columns, and at B = 24; its written
   column within one quantization step of the plain version's.
3. End-to-end cross-check on a narrow gar_1b (ViT width 256, decoder
   hidden 256, 2 layers each, head dim 64): the same seeded bf16 params on
   the card (kernel path: the fused ViT and the fused decode step) and on
   the CPU (plain path: the unfused ViT, the XLA-form decode step);
   prefill logits and the first 4 decode-step logits must agree. Then once
   more with int8 decode weights and an int8 cache (2 kv heads, so the
   heads pair), the card's H8, I8, J8, C8 against their plain versions.
4. Vision forms: the gar_1b tower over 17 tiles in the fused form (kernels
   D, E, F, G) and the unfused form (kernel A) on the same params and
   inputs; their outputs must agree to 5e-2 of the output range, and each
   form must launch its kernels once per layer.
5. Decode forms: one gar_1b decode step over the main path's seeded cache
   in the fused form (kernels J, C, H, I, H a layer) and in the XLA form
   (cuBLAS products around C), from the same input embedding; hidden and
   written K/V must agree to 5e-2 of their range; device and host ms per
   step of each form. Then the int8 fused step (J8, C8, H8, I8, H8 a layer)
   from the same cache seeded int8, its ms and its gap to the bf16 step,
   and the LM head's device time, bf16 against int8.
6. Main path: gar_1b with seeded random weights, one 17-tile image, one
   region, a 4662-token prompt and 256 greedy tokens through `generate`;
   ms per caption split into vision, prefill and decode, and the kernel
   launch counts of one caption, which must be D = E = F = G = 23 (the
   fused ViT), A = 0, B = 16, C = I = J = 16 * 255, H = 2 * 16 * 255 (the
   fused decode step). Then the int8 main path, `generate` with
   `quantize_decode_weights(params)` and `quantize_kv=True`: the same
   split, launch counts C8 = I8 = J8 = 16 * 255, H8 = 2 * 16 * 255 and no
   C, H, I, J, and the relative gap of the first decode step's logits to
   the bf16 path's (printed, not bounded).

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

    import torch.nn.functional as F

    def sdpa(q, k, v, **kw):  # (B, S, H, D) views as SDPA's (B, H, S, D)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), **kw)

    results = {}

    # A: ViT attention, 17 tiles x 1025 tokens x 16 heads
    q, k, v = rnd(17, 1025, 16, 64), rnd(17, 1025, 16, 64), rnd(17, 1025, 16, 64)
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    err = max_err(out, va.vit_attention_plain(q.float(), k.float(), v.float()), "A")
    results["A"] = dict(max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention(q, k, v)),
                        plain_ms=cuda_ms(lambda: va.vit_attention_plain(q, k, v), iters=5),
                        library_ms=cuda_ms(lambda: sdpa(q, k, v)),
                        **bound(nbytes(q, k, v, out), 4 * 17 * 16 * 1025 ** 2 * 64))
    del q, k, v, out

    # B: causal prefill, 4662 tokens, 32 query heads over 8 kv heads
    q, k, v = rnd(1, 4662, 32, 64), rnd(1, 4662, 8, 64), rnd(1, 4662, 8, 64)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    err = max_err(out, ref, "B")
    results["B"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5),
        library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
        **bound(nbytes(q, k, v, out), 4 * 32 * 64 * 4662 * 4663 // 2))
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
            q, k_all, v_all, k_new, v_new, layer, **kw)),
        library_ms=None, **decode_bound(q, k_all, plens.tolist(), pad, wpos))
    del k_all, v_all, k_ref, v_ref
    results["C8"] = decode_attention_q8_kernel(rnd)
    results.update(vit_block_kernels(rnd, gen))
    results.update(decode_matmul_kernels(rnd))
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernels] {name}: max |kernel - plain| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {lib}")
    torch.cuda.empty_cache()
    return results


def decode_bound(q, k_all, plens, pad, wpos):
    """Kernel C's (C8's) bound at one layer: the valid K and V columns of
    each row read, the new column written, q read and the output written;
    4 operations per query head, column and dim (QK and PV)."""
    _, _, kh, _, d = k_all.shape
    cols = sum(min(p, pad, wpos) + max(wpos - pad, 0) + 1 for p in plens)
    n_bytes = 2 * cols * kh * d * k_all.element_size() + 2 * nbytes(q)
    return bound(n_bytes, 4 * q.shape[1] * d * cols)


def decode_attention_q8_kernel(rnd):
    """Kernel C8 over layer 7 of the main path's int8 cache, (16, B, 8,
    5120, 64) with the 4662-token prompt, mid-decode: at B = 24 (ragged
    prompt lengths, so the (layer, row, pair) scale indexing is exercised)
    and at B = 1, which the kernels line carries, beside kernel C on a bf16
    cache of the same shape. The output within TOL of the plain version's,
    the written column within one quantization step of it, the rest of the
    cache unchanged."""
    from grasp_any_region_tpu_torch.ops import decode_attention as dec

    layer, pad, wpos = 7, 4662, 4662 + 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for b in (24, 1):
        k_all, v_all = (torch.randint(-127, 128, (16, b, 8, 5120, 64), generator=gen,
                                      device="cuda", dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((16, b, 4, 1, 1), generator=gen, device="cuda") + 0.5)
                            * 0.03 for _ in range(2))
        plens = [pad] + torch.randint(3000, pad + 1, (b - 1,), generator=gen,
                                            device="cuda").tolist()
        q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
        kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
                  write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad,
                  k_scale=k_scale, v_scale=v_scale)
        k_ref, v_ref = k_all.clone(), v_all.clone()
        out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
        torch.cuda.synchronize()
        ref = dec.decode_attention_fused_q8_plain(q.float(), k_ref, v_ref, k_new, v_new, layer,
                                                  **kw)
        err = max_err(out, ref, f"C8 (B = {b})")
        for got, want in ((k_all, k_ref), (v_all, v_ref)):
            col = (got[layer, :, :, wpos].int() - want[layer, :, :, wpos].int()).abs().max()
            if col > 1:
                raise AssertionError(f"C8 (B = {b}): written column off by {int(col)} steps")
            got[layer, :, :, wpos] = want[layer, :, :, wpos]
            if not torch.equal(got, want):
                raise AssertionError(f"C8 (B = {b}): entries other than column write_pos changed")
        args = (q, k_all, v_all, k_new, v_new, layer)
        ms = cuda_ms(lambda: dec.decode_attention_fused(*args, **kw))
        plain_ms = cuda_ms(lambda: dec.decode_attention_fused_q8_plain(*args, **kw), iters=5)
        lim = decode_bound(q, k_all, plens, pad, wpos)
        k16, v16 = (rnd(16, b, 8, 5120, 64) for _ in range(2))
        kw16 = {key: val for key, val in kw.items() if not key.endswith("scale")}
        c_ms = cuda_ms(lambda: dec.decode_attention_fused(q, k16, v16, k_new, v_new, layer,
                                                          **kw16))
        log(f"[kernels] C8, B = {b}: {ms:.4f} ms (bound {lim['bound_ms']:.4f} ms of "
            f"{lim['bound_by']}); kernel C on a bf16 cache of the same shape {c_ms:.4f} ms; "
            f"plain {plain_ms:.4f} ms; max |kernel - plain| {err:.3e}")
        del k_all, v_all, k_ref, v_ref, k16, v16
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
        err = max_err(out, va.vit_attention_fused_qkv_plain(qkv.float(), cos, sin, h, 64),
                      f"E (S = {seq})")
    results["E"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)),
        plain_ms=cuda_ms(lambda: va.vit_attention_fused_qkv_plain(qkv, cos, sin, h, 64),
                         iters=5),
        library_ms=None, **bound(nbytes(qkv, cos, sin, out), 4 * t * h * s * s * 64))
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
    for name, (kernel, plain, args, kw, ops) in cases.items():
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = max_err(out, plain(*(a.float() for a in args), **kw), name)
        results[name] = dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*args, **kw)),
                             plain_ms=cuda_ms(lambda: plain(*args, **kw), iters=5),
                             library_ms=None, **bound(nbytes(*args, out), ops))
        del out
    return results


def decode_matmul_kernels(rnd):
    """Kernels H, I, J and their int8 forms H8, I8, J8 at the gar_1b decode
    shapes (hidden 2048, q 2048, kv 512, MLP 8192), the weights stacked
    (16, Din, Dout) and read at layer 7; the int8 weights are the bf16 ones
    quantized (`quantize_int8`). H runs at both the wo and the w_down
    width; its entry carries w_down. Checked against the plain version at
    B = 24 and B = 1 (the kernels line carries B = 1), and at the narrow
    config's ragged widths (hidden 256, q 256, kv 64, MLP 1024) at B = 1 and
    5. Beside each time: the weight bytes over it, cuBLAS's bf16 product of
    the same layer (the XLA form's ops; torch.mm is H's library call), for
    H8 torch._weight_int8pack_mm (the library's W8A16 product, timed only),
    and a device-to-device copy of the same bytes."""
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

    for label, (_, kernel, plain, kernel8, plain8, _, ws, din) in calls(256, 1024, 256, 64,
                                                                         2).items():
        for b in (1, 5):
            check(f"{label}, narrow", kernel, plain, ws, 1, rnd(b, din))
            check(f"{label} int8, narrow", kernel8, plain8, int8(ws), 1, rnd(b, din))

    def copy_ms(n_bytes):
        src = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        return cuda_ms(lambda: dst.copy_(src))

    layer, results = 7, {}
    for label, (key, kernel, plain, kernel8, plain8, cublas, ws, din) in calls(
            2048, 8192, 2048, 512, 16).items():
        qs = int8(ws)
        n_bytes = nbytes(*(w[layer] for w in ws))
        n8 = nbytes(*(t[layer] for t in qs))
        copies = copy_ms(n_bytes), copy_ms(n8)
        n_out = ws[0].shape[2] if key == "I" else sum(w.shape[2] for w in ws)
        if key == "H":  # H8's library call takes the weight as (N, K) and bf16 scales
            w_nk, s_n = qs[0][layer].t().contiguous(), qs[1][layer].reshape(-1).to(torch.bfloat16)
        for b in (24, 1):
            x = rnd(b, din)
            err, err8 = (check(label, kernel, plain, ws, layer, x),
                         check(f"{label} int8", kernel8, plain8, qs, layer, x))
            lib8_ms = None
            if key == "H":
                try:
                    lib_out = torch._weight_int8pack_mm(x, w_nk, s_n)
                    lib8_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s_n))
                    lib_err = (lib_out.float() - plain8(x.float(), *qs, layer)).abs().max().item()
                    log(f"[kernels] {label} int8, B = {b}: library torch._weight_int8pack_mm "
                        f"{lib8_ms:.4f} ms (bf16 scales, bf16 out; max |library - plain| "
                        f"{lib_err:.3e})")
                except RuntimeError as e:
                    log(f"[kernels] {label} int8, B = {b}: library torch._weight_int8pack_mm "
                        f"refused: {e}")
            ms, ms8 = cuda_ms(lambda: kernel(x, *ws, layer)), cuda_ms(lambda: kernel8(x, *qs, layer))
            # every layer once, back to back, as a decode step calls them (the
            # 16 layers' weights exceed the L2, so each call finds its own cold)
            n_layers = ws[0].shape[0]
            seq_ms = cuda_ms(lambda: [kernel(x, *ws, i) for i in range(n_layers)],
                             iters=5, sleep_cycles=20_000_000) / n_layers
            seq8_ms = cuda_ms(lambda: [kernel8(x, *qs, i) for i in range(n_layers)],
                              iters=5, sleep_cycles=20_000_000) / n_layers
            blas_ms = cuda_ms(lambda: cublas(x, *ws, layer))
            plain_ms = cuda_ms(lambda: plain(x, *ws, layer), iters=5)
            plain8_ms = cuda_ms(lambda: plain8(x, *qs, layer), iters=5)
            io = 2 * b * (din + n_out)
            ops = 2 * b * din * sum(w.shape[2] for w in ws)
            lim, lim8 = bound(n_bytes + io, ops), bound(n8 + io, ops)
            log(f"[kernels] {label}, B = {b}: {ms:.4f} ms = {n_bytes / ms / 1e6:.0f} GB/s of "
                f"weights ({n_bytes / 1e6:.1f} MB, bound {lim['bound_ms']:.4f} ms); cuBLAS bf16 "
                f"{blas_ms:.4f} ms ({n_bytes / blas_ms / 1e6:.0f} GB/s); plain fp32 "
                f"{plain_ms:.4f} ms; copy of the same bytes {copies[0]:.4f} ms (moves 2x: "
                f"{2 * n_bytes / copies[0] / 1e6:.0f} GB/s); {n_layers} layers back to back "
                f"{seq_ms:.4f} ms a layer = {n_bytes / seq_ms / 1e6:.0f} GB/s; "
                f"max |kernel - plain| {err:.3e}")
            log(f"[kernels] {label} int8 ({key}8), B = {b}: {ms8:.4f} ms = "
                f"{n8 / ms8 / 1e6:.0f} GB/s of int8 weights and scales ({n8 / 1e6:.1f} MB, bound "
                f"{lim8['bound_ms']:.4f} ms); bf16 kernel {ms:.4f} ms, cuBLAS bf16 "
                f"{blas_ms:.4f} ms; plain fp32 {plain8_ms:.4f} ms; copy of the same bytes "
                f"{copies[1]:.4f} ms; {n_layers} layers back to back {seq8_ms:.4f} ms a layer "
                f"= {n8 / seq8_ms / 1e6:.0f} GB/s; max |kernel - plain| {err8:.3e}")
        if label != "H wo":  # B = 1 at the last width of each kernel goes in the line
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=blas_ms if key == "H" else None, **lim)
            results[f"{key}8"] = dict(max_abs_err=err8, ms=ms8, plain_ms=plain8_ms,
                                      library_ms=lib8_ms, **lim8)
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
def phase_cross_check(cfg, int8: bool = False):
    """The kernel path on the card against the plain path on the CPU, from
    the same params (int8: quantized once, on the CPU, and copied)."""
    from grasp_any_region_tpu_torch.models.gar import (
        gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    p_cpu = random_params(cfg, "cpu")
    if int8:
        p_cpu = quantize_decode_weights(p_cpu)
    tag = "[cross-check int8]" if int8 else "[cross-check]"
    runs = []  # logits per path: prefill, then 4 decode steps
    tokens = None
    for dev, params in (("cuda", copy.deepcopy(p_cpu).to("cuda")), ("cpu", p_cpu)):
        batch, plens = bench_batch(cfg, dev)
        s = batch.input_ids.shape[1]
        hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
        logits = [lm_logits(params.llm, cfg.text, hidden[:, -1],
                            valid_vocab=cfg.extended_vocab_size).float().cpu()]
        cache = seed_cache_from_prefill(cfg, kv, plens, ((s + 4 + 511) // 512) * 512,
                                        quantize_kv=int8)
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
        log(f"{tag} step {i}: max |card - cpu| / max |cpu| = {rel:.3e}, "
            f"greedy card {int(a.argmax())}, cpu {int(b.argmax())}")
    if worst > E2E_TOL:
        raise AssertionError(f"{tag} kernel path and plain path differ by {worst:.3e} "
                             f"> {E2E_TOL} of the logit range")
    log(f"{tag} fed tokens {tokens}; worst relative logit error {worst:.3e} <= {E2E_TOL}")


def counter_modules():
    """The wrapper modules whose launch counters the phases read."""
    from grasp_any_region_tpu_torch.ops import decode_attention, flash_attention, layer_matmul
    from grasp_any_region_tpu_torch.ops import vit_attention, vit_block

    return decode_attention, flash_attention, vit_attention, vit_block, layer_matmul


def reset_counts():
    dec, fa, va, vb, lm = counter_modules()
    va.launches = va.launches_fused = fa.launches = dec.launches = dec.launches_q8 = 0
    vb.launches.update(D=0, F=0, G=0)
    lm.launches.update(dict.fromkeys(lm.launches, 0))


def read_counts():
    dec, fa, va, vb, lm = counter_modules()
    return dict(A=va.launches, B=fa.launches, C=dec.launches, C8=dec.launches_q8,
                D=vb.launches["D"], E=va.launches_fused, F=vb.launches["F"], G=vb.launches["G"],
                **lm.launches)


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


@torch.inference_mode()
def phase_decode_forms(cfg, params, params_q8):
    """One gar_1b decode step in each form from one seeded cache (the main
    path's: B = 1, the 4662-token prompt, 5120 columns) and the same input
    embedding, each form on its own copy of the cache; then the int8 step
    (params_q8: `quantize_decode_weights(params)`) from the same prefill
    seeded into an int8 cache, and the LM head in bf16 and in int8."""
    from grasp_any_region_tpu_torch.models.gar import gar_prefill, seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.llama import embed_tokens, llama_decode_step, lm_logits

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
    n_layers = cfg.text.num_layers
    expected = dict(fused=expect(C=n_layers, H=2 * n_layers, I=n_layers, J=n_layers),
                    xla=expect(C=n_layers),
                    int8=expect(C8=n_layers, H8=2 * n_layers, I8=n_layers, J8=n_layers))
    outs, counts, times = {}, {}, {}
    for form, use_kernel in (("fused", "fused"), ("xla", False), ("int8", None)):
        src, llm = (seeded_q8, params_q8.llm) if form == "int8" else (seeded, params.llm)
        cache = src._replace(k=src.k.clone(), v=src.v.clone(), write_pos=src.write_pos.clone())

        def step():
            return llama_decode_step(llm, cfg.text, emb, cache, s, use_kernel=use_kernel)

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
    h8, h16 = outs["int8"][0], outs["fused"][0]
    if h8.shape != h16.shape or not torch.isfinite(h8).all():
        raise AssertionError(f"decode forms: int8 hidden {tuple(h8.shape)} or non-finite")
    log(f"[decode] max |int8 - fused| / max |fused| over the hidden: "
        f"{((h8 - h16).abs().max() / h16.abs().max()).item():.3e} (int8 weights and cache; "
        "not bounded)")
    for form, (dev_ms, host_ms) in times.items():
        log(f"[decode] {form} form: {dev_ms:.3f} ms device, {host_ms:.3f} ms host per step; "
            f"launches per step {counts[form]}")
    x = h16[:, 0].to(torch.bfloat16)
    # the int8 head issues a few ops a chunk: sleep ~10 ms so the host has queued them
    head_ms = {name: cuda_ms(lambda: lm_logits(tree.llm, cfg.text, x), sleep_cycles=20_000_000)
               for name, tree in (("bf16", params), ("int8", params_q8))}
    log(f"[decode] LM head per step (B = 1, {cfg.padded_vocab_size} rows, L2 flushed): "
        f"bf16 {head_ms['bf16']:.4f} ms, int8 {head_ms['int8']:.4f} ms")
    if worst > E2E_TOL:
        raise AssertionError(f"decode forms differ by {worst:.3e} > {E2E_TOL} of the range")


def phase_main_path(cfg, params, params_q8=None):
    """generate at B = 1 on the bench workload: one warm-up and three timed
    runs, launch counts per caption, the vision / prefill / decode split.
    With params_q8 (`quantize_decode_weights(params)`) the int8 path:
    int8 decode weights and `quantize_kv=True`, and the gap of its first
    decode step's logits to the bf16 path's."""
    from grasp_any_region_tpu_torch.models.gar import (
        encode_images, gar_decode_step, gar_prefill, seed_cache_from_prefill)
    from grasp_any_region_tpu_torch.models.generate import generate
    from grasp_any_region_tpu_torch.models.llama import lm_logits

    int8 = params_q8 is not None
    run_params, tag = (params_q8, "[main int8]") if int8 else (params, "[main]")
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
                       mask_compat=False, quantize_kv=int8)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), read_counts()

    depth, steps = cfg.vision.depth, cfg.text.num_layers * (new_tokens - 1)
    dec = (dict(C8=steps, H8=2 * steps, I8=steps, J8=steps) if int8 else
           dict(C=steps, H=2 * steps, I=steps, J=steps))
    expected = expect(B=cfg.text.num_layers, D=depth, E=depth, F=depth, G=depth, **dec)
    run()  # warm-up
    times, counts, out = [], None, None
    for _ in range(3):
        out, ms, counts = run()
        times.append(ms)
        if counts != expected:
            raise AssertionError(f"{tag} launch counts {counts}, expected {expected}")
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
        if int8:  # the first decode step from the same prefill, int8 against bf16
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
    log(f"{tag} launches per caption {counts} (expected {expected}); "
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
    "C8": ("decode_attention_fused_q8", "grasp_any_region_tpu_torch/csrc/decode_attention.cu",
           "grasp_any_region_tpu/ops/decode_attention.py:477"),
    "H8": ("layer_matmul_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:190"),
    "I8": ("layer_swiglu_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:234"),
    "J8": ("layer_qkv_q8", "grasp_any_region_tpu_torch/csrc/layer_matmul.cu",
           "grasp_any_region_tpu/ops/layer_matmul.py:282"),
}


def main() -> int:
    smi = phase_environment()
    log(smi)
    from grasp_any_region_tpu_torch.core.config import gar_1b

    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    kernels = phase_kernels()
    phase_cross_check(narrow_config())
    phase_cross_check(narrow_config(kv_heads=2), int8=True)
    cfg = gar_1b()
    params = random_params(cfg, "cuda")
    params_q8 = quantize_decode_weights(params)
    unfused_counts = phase_vision_forms(cfg, params)
    phase_decode_forms(cfg, params, params_q8)
    main_counts = phase_main_path(cfg, params)
    int8_counts = phase_main_path(cfg, params, params_q8)
    # kernel A runs on the unfused tower's path, the int8 kernels on the
    # int8 path's generate, the others on generate's
    paths = {key: ("vision_forward(fused_blocks=False)", unfused_counts) if key == "A"
             else ("generate(int8)", int8_counts) if key.endswith("8")
             else ("generate", main_counts) for key in KERNELS}
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, path=paths[key][0],
             launches=paths[key][1][key], **{f: kernels[key][f] for f in fields})
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
