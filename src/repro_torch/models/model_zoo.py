"""Unified model interface over all the architecture families.

Port of `repro.models.model_zoo`:

    model = get_model(cfg, device=..., generator=...)   # owns its weights
    logits, aux = model.forward(tokens, **extras)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(tokens, max_len, **extras)
    logits, cache = model.decode_step(cache, token)
    shapes = model.extra_input_shapes(batch, seq)   # frontend stubs (vlm, audio)

The reference's ``init(rng)`` is the construction here, and no entry
point takes ``params``. Every family is a `base.Model`: the transformer
(dense, moe, vlm), the RG-LRU hybrid, xLSTM and whisper.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer, whisper, xlstm
from repro_torch.models.base import Model, TensorSpec

__all__ = ["Model", "TensorSpec", "get_model"]

FAMILIES = {
    "dense": transformer.Transformer,
    "moe": transformer.Transformer,
    "vlm": transformer.Transformer,
    "hybrid": rglru.HybridLM,
    "ssm": xlstm.XLSTM,
    "audio": whisper.Whisper,
}


def get_model(cfg: ModelConfig, *, device=None, generator=None) -> Model:
    """The model for ``cfg`` on ``device`` (the card unless "cpu"), its
    weights drawn from ``generator`` (a `torch.Generator` on that
    device; None draws from the global generator)."""
    return build(cfg, resolve_device(device), generator)


def build(cfg: ModelConfig, device: torch.device, generator=None) -> Model:
    """`get_model` on a resolved device (also "meta": shapes only)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return FAMILIES[cfg.family](cfg, device=device, generator=generator)
