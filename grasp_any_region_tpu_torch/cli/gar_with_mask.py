"""CLI: image + binary mask -> region caption, with the PyTorch package
(`grasp_any_region_tpu/cli/gar_with_mask.py`'s arguments, and --device).
Several image / mask pairs are captioned in one batch. Reading the files
needs PIL.

Usage:
  python -m grasp_any_region_tpu_torch.cli.gar_with_mask \
      --model-path /path/to/ckpt --image img.png --mask mask.png
  python -m grasp_any_region_tpu_torch.cli.gar_with_mask \
      --preset gar_1b --random-init --image img.png --mask m.png
"""

from __future__ import annotations

import argparse

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
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--random-init", action="store_true",
                   help="allow random weights (smoke tests)")
    p.add_argument("--speculative", default=None, metavar="GAMMA,K",
                   help="self-speculative draft/verify decoding (single image, temperature 0); "
                        "the same greedy tokens, but on the card each round is bound by host "
                        "dispatch, so it is slower than the default decode unless the draft "
                        "accepts nearly every token (PERF.md sections 5-6)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if len(args.image) != len(args.mask):
        p.error(f"--image given {len(args.image)} times but --mask {len(args.mask)}")
    spec = None
    if args.speculative:
        try:
            gamma, k = (int(x) for x in args.speculative.split(","))
        except ValueError:
            p.error(f"--speculative expects GAMMA,K integers, got {args.speculative!r}")
        if gamma < 1 or k < 1:
            p.error("--speculative GAMMA and K must be >= 1")
        spec = (gamma, k)
        if len(args.image) != 1 or args.temperature != 0.0:
            p.error("--speculative needs exactly one image and temperature 0")

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init, device=args.device)
    samples = [
        RegionSample(image=load_image(img), masks={1: load_mask(msk)},
                     instruction=args.instruction)
        for img, msk in zip(args.image, args.mask)
    ]
    for img, text in zip(args.image, rt.caption(
            samples, max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            speculative=spec)):
        print(f"=== {img} ===")
        print(text)


if __name__ == "__main__":
    main()
