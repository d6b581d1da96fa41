"""Optimizers of the port (`repro.optimizer`): AdamW, Adafactor, global-
norm clipping and gradient compression, over trees of tensors."""

from repro_torch.optimizer.adafactor import adafactor
from repro_torch.optimizer.adamw import adamw
from repro_torch.optimizer.base import Optimizer, clip_by_global_norm
from repro_torch.optimizer.compress import compress_gradients

__all__ = [
    "Optimizer",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "compress_gradients",
    "get_optimizer",
]


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
