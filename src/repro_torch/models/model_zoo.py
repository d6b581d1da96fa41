"""Unified model interface over the ported architecture families.

Port of `repro.models.model_zoo` for the families ``dense`` and ``vlm``:

    model = get_model(cfg, device=..., generator=...)   # owns its weights
    logits, aux = model.forward(tokens, **extras)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(tokens, max_len)
    logits, cache = model.decode_step(cache, token)
    shapes = model.extra_input_shapes(batch, seq)   # frontend stubs (vlm)

The reference's ``init(rng)`` is the construction here, and no entry
point takes ``params``. The other families raise `NotImplementedError`
naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import TensorSpec

__all__ = ["Model", "TensorSpec", "get_model"]

Model = transformer.Transformer

NOT_PORTED = {
    "moe": "ROADMAP A12c (models/moe.py)",
    "hybrid": "ROADMAP A12d (models/rglru.py)",
    "ssm": "ROADMAP A12d (models/xlstm.py)",
    "audio": "ROADMAP A12d (models/whisper.py)",
}


def get_model(cfg: ModelConfig, *, device=None, generator=None) -> Model:
    """The model for ``cfg`` on ``device`` (the card unless "cpu"), its
    weights drawn from ``generator`` (a `torch.Generator` on that
    device; None draws from the global generator)."""
    return build(cfg, resolve_device(device), generator)


def build(cfg: ModelConfig, device: torch.device, generator=None) -> Model:
    """`get_model` on a resolved device (also "meta": shapes only)."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: {NOT_PORTED[cfg.family]}"
        )
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return transformer.init_params(cfg, device=device, generator=generator)
