"""The GAR-1B train step's loss on one repeated batch, through the kernels and
through the plain attention, on one CUDA card.

    python3 loss_spike_probe.py [--steps 16]

`chip_smoke.py`'s train phase runs GAR-1B's step (seeded random bf16
weights, one 17-tile image with one region, 4662 tokens,
`OptimizerConfig(lr=1e-4, total_steps=100)`) eight steps and eight more,
and its thirteenth loss jumps (about 11 between about 2.4 and 1.6). This
script runs the same steps from the same start twice: as the port runs
them (kernels A and 5 in the tower, B, 17 and 18 in the decoder), and with
every attention through its plain PyTorch version (`vit_attention_plain`,
`flash_attention_plain`, autograd through them, fp32 logits), and prints
both curves and their grad norms. A jump on both paths lies in the math
the two share with the JAX package (the model, the CE, AdamW as optax
computes it), not in the attention kernels. Imports no jax.
"""

from __future__ import annotations

import argparse
import sys

import torch


def run(steps: int, plain: bool):
    import chip_smoke as cs
    from grasp_any_region_tpu_torch.core.config import gar_1b
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.models import vision
    from grasp_any_region_tpu_torch.ops import flash_attention as fa
    from grasp_any_region_tpu_torch.ops import vit_attention as va
    from grasp_any_region_tpu_torch.train import OptimizerConfig, init_state, make_train_step

    kept = vision.vit_attention_df, fa.flash_attention_df
    if plain:
        vision.vit_attention_df = va.vit_attention_plain
        fa.flash_attention_df = fa.flash_attention_plain
    try:
        cfg = gar_1b()
        params = cs.random_params(cfg, "cuda")
        batch, labels, _ = synthetic_batch(cfg, grid=(4, 4), regions=1, seed=cs.SEED)
        state, tx = init_state(params, OptimizerConfig(lr=1e-4, total_steps=100))
        step = make_train_step(cfg, tx, mask_compat=False)
        cs.reset_counts()
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, batch, labels)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        counts = {k: v for k, v in cs.read_counts().items() if v}
        losses, norms = torch.stack(losses).tolist(), torch.stack(norms).tolist()
    finally:
        vision.vit_attention_df, fa.flash_attention_df = kept
    del state, tx, params
    torch.cuda.empty_cache()
    return losses, norms, counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    steps = ap.parse_args().steps
    if not torch.cuda.is_available():
        raise SystemExit("loss_spike_probe: needs a CUDA card")
    import chip_smoke as cs

    print(cs.phase_environment(), flush=True)
    for plain in (False, True):
        losses, norms, counts = run(steps, plain)
        name = "plain attention" if plain else "kernels"
        print(f"[{name}] losses {[round(x, 4) for x in losses]}", flush=True)
        print(f"[{name}] grad_norm {[round(x, 4) for x in norms]}; launches {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
