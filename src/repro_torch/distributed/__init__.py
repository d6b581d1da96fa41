"""Sharding rules, the rank-local model placement and the pipeline
(port of `repro.distributed`)."""

from repro_torch.distributed.sharding import (
    batch_pspec,
    cache_pspecs,
    data_axes,
    guard_pspec,
    param_pspecs,
    param_shardings,
    serving_param_pspecs,
    shard_model,
)

__all__ = [
    "param_pspecs",
    "param_shardings",
    "batch_pspec",
    "guard_pspec",
    "data_axes",
    "cache_pspecs",
    "serving_param_pspecs",
    "shard_model",
]
