"""Data, fsdp, tensor, sequence and pipeline parallelism over
torch.distributed ranks (`grasp_any_region_tpu/parallel/`)."""

from .sharding import (  # noqa: F401
    batch_pspecs,
    constrain_seq,
    param_pspecs,
    param_shardings,
    shard_params,
)
