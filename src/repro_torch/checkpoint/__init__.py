"""Crash-atomic, checksummed on-disk snapshots (port of `repro.checkpoint`)."""

from repro_torch.checkpoint.manager import CheckpointManager, config_hash

__all__ = ["CheckpointManager", "config_hash"]
