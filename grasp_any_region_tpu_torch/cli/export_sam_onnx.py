"""CLI: export the SAM mask decoder to ONNX for decoding in the browser,
with the PyTorch package (`grasp_any_region_tpu/cli/export_sam_onnx.py`'s
arguments). The file has the official decoder interface that the
reference's onnxruntime-web frontend feeds. Weights: an HF SAM checkpoint
directory (`sam/weights.load_sam_checkpoint`) or seeded random ViT-B
weights (plumbing tests). The export runs on the CPU and needs no `onnx`
package.

Usage:
  python -m grasp_any_region_tpu_torch.cli.export_sam_onnx \\
      --checkpoint /path/to/hf-sam --out sam_decoder.onnx
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="HF SAM checkpoint dir (vit_b/l/h read from its config.json)")
    p.add_argument("--out", required=True, help="output .onnx path")
    p.add_argument("--multimask", action="store_true",
                   help="emit all 4 mask outputs instead of the best one "
                        "(the browser demo uses single-mask)")
    p.add_argument("--random-init", action="store_true",
                   help="random weights (export-pipeline smoke test)")
    args = p.parse_args(argv)

    from ..sam.onnx_export import export_mask_decoder_onnx

    if args.checkpoint:
        from ..sam.weights import load_sam_checkpoint

        cfg, params = load_sam_checkpoint(args.checkpoint, device="cpu")
    elif args.random_init:
        from ..sam.model import init_sam_params, sam_vit_b

        cfg = sam_vit_b()
        params = init_sam_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    else:
        p.error("--checkpoint or --random-init required")

    path = export_mask_decoder_onnx(params, cfg, args.out,
                                    return_single_mask=not args.multimask)
    print(f"[export] {path} ({os.path.getsize(path) / 1e6:.1f} MB)", file=sys.stderr)


if __name__ == "__main__":
    main()
