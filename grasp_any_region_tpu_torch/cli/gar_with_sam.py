"""CLI: points / box -> SAM mask -> GAR region caption, with the PyTorch
package (`grasp_any_region_tpu/cli/gar_with_sam.py`'s arguments, and
--device): SAM's best-IoU mask, the single-region caption, and with --viz
the mask's overlay and contour. Reading the image and writing the overlay
need PIL.

Usage:
  python -m grasp_any_region_tpu_torch.cli.gar_with_sam --image img.png \\
      --point 320,200 [--point 350,240] [--neg-point 10,10] [--box x1,y1,x2,y2] \\
      [--sam-path /path/to/hf-sam] [--model-path /path/to/gar] [--viz out.png]
  python -m grasp_any_region_tpu_torch.cli.gar_with_sam --preset gar_1b --random-init \\
      --image img.png --box 40,30,400,300 --device cpu
"""

from __future__ import annotations

import argparse

from ..data.builders import RegionSample
from ..sam.pipeline import SamPredictor, draw_mask_overlay
from .runtime import GARRuntime, load_image


def _parse_xy(s: str):
    parts = [float(v) for v in s.split(",")]
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected x,y — got {s!r}")
    return tuple(parts)


def _parse_box(s: str):
    parts = [float(v) for v in s.split(",")]
    if len(parts) != 4:
        raise argparse.ArgumentTypeError(f"expected x1,y1,x2,y2 — got {s!r}")
    return tuple(parts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default=None)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--sam-path", default=None, help="HF SAM checkpoint dir")
    p.add_argument("--image", required=True)
    p.add_argument("--point", action="append", type=_parse_xy, default=[])
    p.add_argument("--neg-point", action="append", type=_parse_xy, default=[])
    p.add_argument("--box", type=_parse_box, default=None)
    p.add_argument("--instruction", default="Describe this masked region in detail.")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--viz", default=None, help="write mask-overlay PNG here")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if not args.point and args.box is None:
        p.error("need at least one --point or a --box")

    image = load_image(args.image)
    sam = SamPredictor.load(args.sam_path, device=args.device)
    points = list(args.point) + list(args.neg_point)
    labels = [1] * len(args.point) + [0] * len(args.neg_point)
    mask = sam.predict(image, points or None, labels or None, args.box)
    if mask.sum() == 0:
        raise SystemExit("prompt produced an empty mask")

    if args.viz:
        from PIL import Image

        Image.fromarray(draw_mask_overlay(image, mask)).save(args.viz)
        print(f"[sam] wrote visualization to {args.viz}")

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init, device=args.device)
    sample = RegionSample(image=image, masks={1: mask}, instruction=args.instruction)
    print(rt.caption([sample], max_new_tokens=args.max_new_tokens)[0])


if __name__ == "__main__":
    main()
