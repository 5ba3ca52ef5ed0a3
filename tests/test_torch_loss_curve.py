"""Sixteen bf16 train steps on one batch, the port against the JAX package at
gar_tiny on the CPU: the record behind ROADMAP section 3's watch item on
the GAR-1B step's loss spike.

Both sides start from the same JAX-initialised bf16 parameters and run
their own train step (JAX's jitted `make_train_step`, its loss at bf16 and
optax's AdamW; the port's `make_train_step` at its bf16 default) on the
same synthetic batch (one 1 x 1 grid, mask plane read as binary) with
chip_smoke.py's schedule, `OptimizerConfig(lr, total_steps=100)` (a
three-step linear warm-up, then cosine), at its lr of 1e-4 and at two
larger ones that make the loss fall as fast as it does at GAR-1B. Each
step's loss is printed and held to JAX's: within 5e-3 at 1e-4 and 3e-3;
at 3e-2, where the loss falls from 11.8 to a plateau near 3.5 in six
steps, within 5e-2 through step 12 (after it the two bf16 runs drift
apart on the plateau). grad_norm differs by design: JAX's `global_norm`
sums bf16 gradients in bf16, the port's metric in fp32.

Marked slow: the port's bf16 step takes 7-15 s on a CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

STEPS = 16
CASES = {1e-4: (5e-3, STEPS), 3e-3: (5e-3, STEPS), 3e-2: (5e-2, 13)}


def _curves(lr):
    from grasp_any_region_tpu.core import config as jcfg
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu.train import OptimizerConfig as JOpt
    from grasp_any_region_tpu.train import init_sharded_state
    from grasp_any_region_tpu.train import make_train_step as jstep
    from grasp_any_region_tpu_torch.core import config as tcfg
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb
    from grasp_any_region_tpu_torch.train import OptimizerConfig as TOpt
    from grasp_any_region_tpu_torch.train import init_state
    from grasp_any_region_tpu_torch.train import make_train_step as tstep

    cj, ct = jcfg.gar_tiny(), tcfg.gar_tiny()
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    init_gar_params(jax.random.PRNGKey(0), cj))
    flat = flatten_params(params)
    kw = dict(lr=lr, total_steps=100)
    jb, jl, _ = jsb(cj, batch=1, grid=(1, 1), seed=0)
    tb, tl, _ = tsb(ct, batch=1, grid=(1, 1), seed=0, device="cpu")
    state, tx = init_sharded_state(params, JOpt(**kw), mesh=None)
    step = jstep(cj, tx, mask_compat=False, use_flash=False, donate=False)
    jax_losses = []
    for _ in range(STEPS):
        state, metrics = step(state, jb, jl)
        jax_losses.append(float(metrics["loss"]))
    tstate, ttx = init_state(load_flat_params(flat, ct, device="cpu", dtype=torch.bfloat16),
                             TOpt(**kw), device="cpu")
    tstep_fn = tstep(ct, ttx, mask_compat=False, device="cpu")
    port_losses = []
    for _ in range(STEPS):
        tstate, metrics = tstep_fn(tstate, tb, tl)
        port_losses.append(metrics["loss"].item())
    return np.array(jax_losses), np.array(port_losses)


@pytest.mark.slow
@pytest.mark.parametrize("lr", list(CASES))
def test_bf16_loss_curve_tracks_jax(lr):
    jax_losses, port_losses = _curves(lr)
    tol, n = CASES[lr]
    for i, (a, b) in enumerate(zip(jax_losses, port_losses)):
        print(f"lr {lr:g} step {i}: jax {a:.4f} port {b:.4f}")
    np.testing.assert_allclose(port_losses[:n], jax_losses[:n], atol=tol, rtol=0)
    # neither side spikes: no step's loss rises by more than 5% over the step before
    for losses in (jax_losses, port_losses):
        assert np.all(losses[1:n] <= losses[:n - 1] * 1.05), losses
