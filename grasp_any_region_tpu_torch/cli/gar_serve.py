"""CLI: continuous-batching serving over many image + mask requests, with
the PyTorch package (`grasp_any_region_tpu/cli/gar_serve.py`'s arguments
and engine sizing, and --device; a slot's pages are sized by the padded
prompt, which the prefill writes, not by the true one).

Drives `serve/engine.ContinuousBatchingEngine` (paged KV cache, slot ring,
windows of decode steps): requests are admitted as slots and pages free
up, decode runs for all active requests together, and each caption prints
the moment its request finishes (not in submission order). The
requests/s line goes to stderr. Reading the files needs PIL.

Usage:
  python -m grasp_any_region_tpu_torch.cli.gar_serve \\
      --model-path /path/to/ckpt \\
      --image a.png --mask a_mask.png --image b.png --mask b_mask.png \\
      --slots 4 --max-new-tokens 256
  add `--int8-serving --slots 16` for serving-only int8 decoder weights and
  the quantized window cache, `--device cpu` for the plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..data.builders import RegionSample
from .runtime import GARRuntime, load_image, load_mask


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default=None)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--image", action="append", required=True)
    p.add_argument("--mask", action="append", required=True)
    p.add_argument("--instruction", default="Describe this masked region in detail.")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--decode-chunk", type=int, default=64,
                   help="decode window (tokens per window and host fetch); 0 for "
                        "window = max-new-tokens (the most throughput)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="TTFT fairness: chunk new prompts' decoder sweep so "
                        "active streams aren't stalled a whole prefill")
    p.add_argument("--repeat", type=int, default=1,
                   help="submit each image/mask pair this many times")
    p.add_argument("--random-init", action="store_true",
                   help="allow random weights (smoke tests)")
    p.add_argument("--int8-serving", action="store_true",
                   help="serving-only int8 decoder weights + quantized window KV "
                        "(quality against bf16 unvalidated on real checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if len(args.image) != len(args.mask):
        p.error(f"--image given {len(args.image)} times but --mask {len(args.mask)}")

    from ..serve.engine import ContinuousBatchingEngine, EngineConfig

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init,
                         int8_serving=args.int8_serving, device=args.device)

    # each request its own B = 1 batch (per-request admission)
    requests = []
    for img, msk in zip(args.image, args.mask):
        sample = RegionSample(image=load_image(img), masks={1: load_mask(msk)},
                              instruction=args.instruction)
        batch, plens = rt.batch([sample])
        for _ in range(args.repeat):
            requests.append((img, batch, int(plens[0])))

    # the padded length (the collate's bucket): the prefill writes every
    # padded column into the slot's pages
    max_prompt = max(batch.input_ids.shape[1] for _, batch, _ in requests)
    pages_per_slot = -(-(max_prompt + args.max_new_tokens + args.decode_chunk)
                       // args.page_size)
    ecfg = EngineConfig(
        slots=args.slots,
        page_size=args.page_size,
        num_pages=args.slots * pages_per_slot + 1,
        max_pages_per_slot=pages_per_slot,
        max_new_tokens=args.max_new_tokens,
        eot_id=rt.tok.eot_id,
        decode_chunk=args.decode_chunk or args.max_new_tokens,
        prefill_chunk=args.prefill_chunk,
        quantize_kv=args.int8_serving,
    )
    eng = ContinuousBatchingEngine(rt.params, rt.cfg, ecfg, dtype=rt.compute_dtype,
                                   device=rt.device)
    names = {}
    for img, batch, plen in requests:
        names[eng.submit(batch, plen)] = img
    print(f"[serve] {len(requests)} request(s), {args.slots} slots, "
          f"{ecfg.num_pages} pages of {args.page_size} tokens", file=sys.stderr)

    t0 = time.time()
    done = 0
    acc: dict = {}

    def on_event(ev):
        nonlocal done
        acc.setdefault(ev.request_id, []).append(ev.token)
        if ev.done:
            toks = acc.pop(ev.request_id)
            ids = [t for t in toks if t != rt.tok.eot_id]
            text = rt.tok.decode(ids, skip_special_tokens=False)
            dt = time.time() - t0
            done += 1
            print(f"=== {names[ev.request_id]} (request {ev.request_id}, "
                  f"{len(toks)} tok, t+{dt:.1f}s) ===")
            print(text)

    eng.run(on_event)
    dt = time.time() - t0
    print(f"[serve] {done} caption(s) in {dt:.2f}s -> {done/dt:.2f} requests/s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
