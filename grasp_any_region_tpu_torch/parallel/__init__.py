"""Data, fsdp, tensor and sequence parallelism over torch.distributed ranks
(`grasp_any_region_tpu/parallel/`; its pipeline schedules are ROADMAP.md
item 1.10 (d))."""

from .sharding import (  # noqa: F401
    batch_pspecs,
    constrain_seq,
    param_pspecs,
    param_shardings,
    shard_params,
)
