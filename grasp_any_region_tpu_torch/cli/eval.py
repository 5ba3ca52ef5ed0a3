"""Benchmark evaluation CLI (inference + optional judging) with the PyTorch
package (`grasp_any_region_tpu/cli/eval.py`'s subcommands and flags, and
--device). Inference loads through `GARRuntime.load` on the card unless
--device says otherwise; the judge subcommands call an OpenAI-compatible
judge service and run on a host that reaches it.

  python -m grasp_any_region_tpu_torch.cli.eval garbench-vqa \
      --model-path ckpt --anno evaluation/GAR-Bench/annotations/GAR-Bench-VQA.json \
      --images evaluation/GAR-Bench/annotations/images --out out/vqa.json

Subcommands: garbench-vqa | garbench-simple | garbench-detailed | dlc |
ferret | mdvp | judge-simple | judge-detailed | judge-dlc | judge-ferret |
judge-mdvp

Full Ferret protocol (inference -> pairwise review -> summary,
Ferret-Bench/eval.sh):

  python -m grasp_any_region_tpu_torch.cli.eval ferret --model-path ckpt \
      --anno .../box_refer_caption.json --images .../coco --out out/ferret.json
  python -m grasp_any_region_tpu_torch.cli.eval judge-ferret --pred out/ferret.json \
      --anno .../ferret_gpt4_data --out out/review_refer_desc.jsonl

Full MDVP protocol (inference -> transfer -> painted pairwise review,
MDVP-Bench/eval.sh): run `mdvp` then `judge-mdvp --pred out/mdvp.json
--images <folder> --out out/mdvp_review.jsonl`; alternatively judge a
reference-format `mdvp_for_gpt4v_eval/<phase>/` directory directly with
`judge-mdvp --anno <phase_dir> --images <folder> --out ...`.

`main` returns the inference subcommands' `BatchedCaptioner` (its `timer`
and `batches` hold each batch's host and generate seconds and its decode
steps), and None for the judge subcommands.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("task", choices=[
        "garbench-vqa", "garbench-simple", "garbench-detailed",
        "dlc", "ferret", "mdvp",
        "judge-simple", "judge-detailed", "judge-dlc",
        "judge-ferret", "judge-mdvp",
    ])
    p.add_argument("--model-path", default=None)
    p.add_argument("--preset", default="gar_1b")
    p.add_argument("--anno", default=None)
    p.add_argument("--images", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--pred", default=None, help="predictions file (judge tasks)")
    p.add_argument("--qa", default=None, help="DLC qa.json")
    p.add_argument("--class-names", default=None, help="DLC class_names.json")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--judge-model", default="gpt-4o-2024-11-20")
    p.add_argument("--text-only-judge", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    def require(name):
        if getattr(args, name.replace("-", "_")) is None:
            p.error(f"--{name} is required for {args.task}")
        return getattr(args, name.replace("-", "_"))

    if args.task.startswith("judge-"):
        from ..evaluation.judges import JudgeConfig, judge_detailed, judge_dlc, judge_simple

        jc = JudgeConfig(model=args.judge_model)
        if args.task == "judge-simple":
            judge_simple(require("pred"), args.images, jc)
        elif args.task == "judge-detailed":
            judge_detailed(require("pred"), args.images, jc)
        elif args.task == "judge-dlc":
            judge_dlc(
                require("pred"), require("anno"), args.qa, args.class_names,
                image_folder=args.images, judge_cfg=jc,
                with_images=not args.text_only_judge,
            )
        elif args.task == "judge-ferret":
            # Ferret-Bench/eval.sh: pairwise review vs shipped GPT-4
            # answers, then the summarize_gpt_review ratio.
            from ..evaluation.ferret import load_gpt4_data
            from ..evaluation.judges.pairwise_judge import review_pairs

            with open(require("pred")) as f:
                predictions = json.load(f)
            triplets, rule = load_gpt4_data(require("anno"), predictions)
            out = args.out or "review_refer_desc.jsonl"
            summary = review_pairs(triplets, out, judge_cfg=jc, rule=rule)
            print(json.dumps(summary, indent=2))
        elif args.task == "judge-mdvp":
            # MDVP-Bench/eval.sh: transfer predictions into judge
            # triplets, paint set-of-marks region markup, pairwise
            # review, summarize_gpt_score ratio. --anno may instead
            # point at a reference-format gpt4v_eval phase directory.
            from ..evaluation.mdvp import load_gpt4v_eval_dir, transfer
            from ..evaluation.judges.pairwise_judge import review_pairs

            if args.pred:
                with open(args.pred) as f:
                    triplets = transfer(json.load(f))
            else:
                triplets = load_gpt4v_eval_dir(require("anno"))
            out = args.out or "mdvp_review.jsonl"
            summary = review_pairs(
                triplets, out, judge_cfg=jc, image_folder=args.images
            )
            print(json.dumps(summary, indent=2))
        return

    from .runtime import GARRuntime
    from ..evaluation import BatchedCaptioner, run_dlc, run_ferret, run_garbench, run_mdvp

    anno = require("anno")
    rt = GARRuntime.load(args.model_path, args.preset, args.random_init, device=args.device)
    cap = BatchedCaptioner(rt, batch_size=args.batch_size,
                           max_new_tokens=args.max_new_tokens)
    out = args.out or f"model_outputs/{args.task}.json"
    if args.task.startswith("garbench-"):
        mode = args.task.split("-", 1)[1]
        run_garbench(cap, anno, args.images, mode, out, limit=args.limit)
    elif args.task == "dlc":
        run_dlc(cap, anno, args.images, out, limit=args.limit)
    elif args.task == "ferret":
        run_ferret(cap, anno, args.images, out, limit=args.limit)
    elif args.task == "mdvp":
        run_mdvp(cap, anno, args.images, out, limit=args.limit)
    return cap


if __name__ == "__main__":
    main()
