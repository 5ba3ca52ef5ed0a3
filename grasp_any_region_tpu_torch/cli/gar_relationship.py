"""CLI: multi-region relationship QA with the PyTorch package
(`grasp_any_region_tpu/cli/gar_relationship.py`'s arguments, and
--device): several masks and a question that refers to them as <Prompt0>,
<Prompt1>, ... --mcq appends the multiple-choice answer instruction.
PNG files need no image package (`data/png.py`); other formats need PIL.

Usage:
  python -m grasp_any_region_tpu_torch.cli.gar_relationship \
      --image img.png --mask m0.png --mask m1.png \
      --question "What is the relation between <Prompt0> and <Prompt1>?"
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
    p.add_argument("--image", required=True)
    p.add_argument("--mask", action="append", required=True,
                   help="mask for <Prompt{i}> in the order given")
    p.add_argument("--question", required=True)
    p.add_argument("--mcq", action="store_true",
                   help="append the multiple-choice answer instruction")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    question = args.question
    if args.mcq:
        question += " Answer with the correct option's letter directly."

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init, device=args.device)
    masks = {i: load_mask(m) for i, m in enumerate(args.mask)}
    sample = RegionSample(image=load_image(args.image), masks=masks, question=question)
    print(rt.caption([sample], max_new_tokens=args.max_new_tokens)[0])


if __name__ == "__main__":
    main()
