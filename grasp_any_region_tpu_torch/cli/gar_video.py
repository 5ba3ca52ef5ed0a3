"""CLI: video region QA with the PyTorch package: sampled frames and
per-frame region masks (`grasp_any_region_tpu/cli/gar_video.py`'s
arguments, and --device). Frames are an ordered list of images, or are
sampled uniformly from a video file (needs cv2); masks mark the region in
some of those frames. PNG images need no image package (`data/png.py`);
other formats need PIL.

Usage:
  python -m grasp_any_region_tpu_torch.cli.gar_video \
      --frame f0.png --frame f1.png --frame f2.png \
      --mask 0:m0.png --mask 2:m2.png \
      --question "What is the masked object doing?"

  python -m grasp_any_region_tpu_torch.cli.gar_video \
      --video clip.mp4 --num-frames 8 --mask 0:m0.png \
      --question "What is the masked object doing?"

With --video, the --mask frame indices are positions among the SAMPLED
frames (0..num_frames-1); the chosen source indices are printed.
"""

from __future__ import annotations

import argparse
import sys

from ..data.builders import VideoRegionSample
from .runtime import GARRuntime, load_image, load_mask


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default=None)
    p.add_argument("--preset", default="gar_8b")
    p.add_argument("--frame", action="append",
                   help="ordered frame image paths (alternative to --video)")
    p.add_argument("--video", default=None,
                   help="video file; frames sampled uniformly (data/video.py)")
    p.add_argument("--num-frames", type=int, default=8, help="frames to sample with --video")
    p.add_argument("--mask", action="append", required=True,
                   help="frame_idx:path pairs, e.g. 0:mask0.png")
    p.add_argument("--question", default="Describe this masked region in detail.")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    if bool(args.frame) == bool(args.video):
        p.error("give exactly one of --frame... or --video")
    if args.video:
        from ..data.video import read_video_frames

        frames, src_idx, fps = read_video_frames(args.video, args.num_frames)
        print(f"[video] sampled {len(frames)} frames {src_idx} (fps {fps:.1f})",
              file=sys.stderr)
    else:
        frames = [load_image(f) for f in args.frame]
    masks = {}
    for spec in args.mask:
        idx, _, path = spec.partition(":")
        if not path:
            p.error(f"--mask expects frame_idx:path, got {spec!r}")
        masks[int(idx)] = load_mask(path)

    rt = GARRuntime.load(args.model_path, args.preset, args.random_init, device=args.device)
    sample = VideoRegionSample(frames=frames, masks=masks, question=args.question)
    print(rt.caption_video([sample], max_new_tokens=args.max_new_tokens)[0])


if __name__ == "__main__":
    main()
