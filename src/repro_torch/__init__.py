"""FastMatch in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package `repro`, module for module: `kernels` holds
the three CUDA kernels (AnyActive marking, histogram ingest, batched
distance) with a plain PyTorch version beside each, `core` the HistSim
statistics and the shared-counts scheduling loop, `data` and `io` the
synthetic datasets, the block layout and the block sources with their
fault layer (retries, validation, quarantine, prefetch) and the token
corpus with its FastMatch domain selection and stream, `checkpoint` the
on-disk snapshots, `train` the activation drift monitor, `configs` and
`models` the LM configurations and the dense / vlm transformer, `serve`
the query server, its supervisor and the LM serving engine, and
`convert` carries data, state and LM weights over from the reference.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise
rather than fall back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only
    when asked for. Raises when no device is given and no GPU exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
