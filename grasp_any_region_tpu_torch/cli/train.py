"""Train CLI: an annotation file in, checkpoints and an HF export out
(`grasp_any_region_tpu/cli/train.py`'s arguments, and --device).

One process on one card. The parallel axes (--data-axis, --fsdp, --tensor,
--seq, --pipe) take 0 or 1; more waits for ROADMAP.md item 1.10. The
kernels' build cache (`build/torch_kernels/`) stands where JAX enables its
compilation cache.

  python -m grasp_any_region_tpu_torch.cli.train --preset gar_1b \
      --data data/Seed-Dataset.json --work-dir work_dirs/gar_1b --dtype bfloat16
  python -m grasp_any_region_tpu_torch.cli.train --preset gar_tiny --device cpu \
      --data ann.json --max-steps 2 --export-hf hf_out
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    """Parse the flags, train, export; returns the `Trainer` (its state,
    step history and checkpoint records)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--config", default=None, help="config json overriding preset")
    p.add_argument("--data", action="append", required=True)
    p.add_argument("--work-dir", default="./work_dirs/gar")
    p.add_argument("--init-from", default=None, help="checkpoint dir to start from")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--accumulation", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--freeze-llm", action="store_true")
    p.add_argument("--freeze-vision", action="store_true")
    p.add_argument("--data-axis", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=0, help="0 or 1: one card (ROADMAP.md item 1.10)")
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--pipe", type=int, default=1)
    p.add_argument("--pipe-schedule", default="gpipe", choices=["gpipe", "1f1b"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="param + Adam-moment dtype; bfloat16 is the one-card recipe at GAR-1B")
    p.add_argument("--export-hf", default=None, help="export dir after training")
    p.add_argument("--no-save-optimizer", action="store_true")
    p.add_argument("--log-interval", type=int, default=100, help="steps between loss logs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    from ..core.config import PRESETS, load_config
    from ..core.weights import init_gar_params, load_checkpoint, require_device
    from ..data.dataset import DatasetConfig, GraspAnyRegionDataset
    from ..data.tokenizer import GARTokenizer
    from ..train.optimizer import OptimizerConfig
    from ..train.trainer import MeshSpec, Trainer, TrainerConfig, require_one_card

    axes = dict(data=args.data_axis, fsdp=args.fsdp or 1, tensor=args.tensor, seq=args.seq,
                pipe=args.pipe)
    if min(axes.values()) < 1:
        p.error(f"mesh axes must be at least 1 (--fsdp 0: all devices, here 1), got {axes}")
    require_one_card(MeshSpec(**axes))
    device = require_device(args.device)
    dtype = getattr(torch, args.dtype)
    if args.init_from:
        cfg, params = load_checkpoint(args.init_from, device=device, dtype=dtype)
        tok_file = os.path.join(args.init_from, "tokenizer.json")
        tok = (GARTokenizer.from_file(tok_file, cfg.prompt_numbers) if os.path.exists(tok_file)
               else GARTokenizer.synthetic(cfg.prompt_numbers))
    else:
        cfg = load_config(args.config) if args.config else PRESETS[args.preset]()
        params = init_gar_params(cfg, torch.Generator(device=device).manual_seed(0),
                                 device=device, dtype=dtype)
        tok = GARTokenizer.synthetic(cfg.prompt_numbers)

    dataset = GraspAnyRegionDataset(cfg, tok, DatasetConfig(annotation_paths=args.data))
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_ratio=args.warmup_ratio,
                              total_steps=args.max_steps or len(dataset),
                              accumulation=args.accumulation, freeze_llm=args.freeze_llm,
                              freeze_visual_encoder=args.freeze_vision)
    tcfg = TrainerConfig(work_dir=args.work_dir, max_steps=args.max_steps,
                         batch_size=args.batch_size, save_optimizer=not args.no_save_optimizer,
                         log_interval=args.log_interval, pipe_schedule=args.pipe_schedule,
                         device=str(device))
    trainer = Trainer(cfg, params, dataset, opt_cfg, tcfg)
    state = trainer.train()

    if args.export_hf:
        from ..train.export import export_hf_checkpoint

        export_hf_checkpoint(args.export_hf, cfg, state.params)
        print(f"[trainer] exported HF checkpoint to {args.export_hf}")
    return trainer


if __name__ == "__main__":
    main()
