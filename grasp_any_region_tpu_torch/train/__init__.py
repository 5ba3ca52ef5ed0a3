"""Training: the chunked CE loss, AdamW with clipping and accumulation, and
the single-card train step (multimodal and packed text-only)."""

from .optimizer import OptimizerConfig, make_optimizer
from .step import (TrainState, init_state, loss_fn, make_packed_train_step, make_train_loop,
                   make_train_step, packed_loss_fn)

__all__ = ["OptimizerConfig", "TrainState", "init_state", "loss_fn", "make_optimizer",
           "make_packed_train_step", "make_train_loop", "make_train_step", "packed_loss_fn"]
