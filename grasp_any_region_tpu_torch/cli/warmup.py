"""Warm the port's build caches and run the demo shapes once
(`grasp_any_region_tpu/cli/warmup.py`'s flags).

JAX's warmup fills the persistent XLA compilation cache. The port compiles
nothing per shape: what a fresh machine pays once is the nvcc build of the
CUDA kernel library (`ops/_build.build()`, keyed by nvcc and the sources,
under `build/torch_kernels/`) and the g++ build of the native host library
(`data/native.py`: the RLE codec and the bicubic resize). `main` builds
both (0.0 s when cached), then captions each requested tile grid once per
--max-new-tokens value on random weights (weight values do not matter:
the kernels and buffers are shaped by the config), and prints each
build's seconds and each shape's first-caption seconds on stderr, and
returns them: {"kernels_s": .. (None on the CPU), "native_s": ..,
"captions": {"4x4/256": seconds, ...}}.

    python -m grasp_any_region_tpu_torch.cli.warmup --preset gar_1b

runs on the card; `main(argv, device="cpu")` runs the plain versions and
builds no CUDA kernel.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _grid(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--model-path", default=None,
                   help="optional; the weights' values do not matter to the build or "
                        "the kernels, so random init warms real checkpoints too")
    p.add_argument("--grids", default="4x4",
                   help="comma-separated tile grids to run (e.g. '4x4,2x2,1x1'); 4x4 is "
                        "the 17-tile demo bucket")
    p.add_argument("--max-new-tokens", default="256,1024",
                   help="comma-separated decode lengths to run")
    p.add_argument("--int8-serving", action="store_true",
                   help="also warm the serving-only int8 weight layout")
    args = p.parse_args(argv)

    from ..core.weights import require_device
    from ..data import native
    from ..data.builders import RegionSample
    from .runtime import GARRuntime

    dev = require_device(device)
    total0 = time.time()
    figures = {"kernels_s": None, "native_s": None, "captions": {}}
    if dev.type == "cuda":
        from ..ops import _build

        lib, figures["kernels_s"] = _build.build()
        print(f"[warmup] CUDA kernels: {lib.parent.name} built in {figures['kernels_s']:.1f}s",
              file=sys.stderr)
    else:
        print("[warmup] CUDA kernels: not built (cpu runs the plain versions)", file=sys.stderr)
    _, figures["native_s"] = native.build()
    print(f"[warmup] native host library: built in {figures['native_s']:.1f}s", file=sys.stderr)

    rt = GARRuntime.load(args.model_path, args.preset, random_init=True,
                         int8_serving=args.int8_serving, device=dev)
    grids = [_grid(g) for g in args.grids.split(",") if g]
    lens = [int(x) for x in args.max_new_tokens.split(",") if x]

    tile = 448
    for ncw, nch in grids:
        # an exactly grid-shaped image selects (ncw, nch) in the processor's
        # canvas fit (data/image_processor.select_tile_grid)
        img = np.zeros((nch * tile, ncw * tile, 3), np.uint8)
        img[::7, ::7] = 255
        mask = np.zeros(img.shape[:2], np.uint8)
        mask[tile // 4 : tile, tile // 4 : tile] = 1
        sample = RegionSample(image=img, masks={1: mask},
                              instruction="Describe the masked region in detail.")
        for n in lens:
            t0 = time.time()
            rt.caption([sample], max_new_tokens=n)
            figures["captions"][f"{ncw}x{nch}/{n}"] = seconds = time.time() - t0
            print(f"[warmup] grid {ncw}x{nch} max_new={n}: first caption in {seconds:.1f}s",
                  file=sys.stderr)
    print(f"[warmup] done in {time.time() - total0:.1f}s", file=sys.stderr)
    return figures


if __name__ == "__main__":
    main()
