"""Gradient compression for the cross-replica all-reduce.

Port of `repro.optimizer.compress`. Two schemes, both commuting with
summation:

* bf16: cast gradients to bf16 before the reduction (half the bytes).
* int8 + error feedback: per-tensor max-abs scaling to int8 with a
  persistent f32 residual (EF-SGD), so quantisation error is fed back
  rather than lost. Rounding is half to even, as ``jnp.round``'s.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optimizer.base import tree_map, tree_unzip

__all__ = ["compress_gradients", "init_error_feedback", "quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_gradients(grads, *, scheme: str = "bf16", error_feedback=None):
    """Returns (compressed_grads, new_error_feedback).

    scheme="bf16": plain cast (residual unused).
    scheme="int8": quantize(g + residual); residual = (g + residual) - dq.
    scheme="none": passthrough.
    """
    if scheme == "none":
        return grads, error_feedback
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), error_feedback
    if scheme == "int8":
        if error_feedback is None:
            error_feedback = init_error_feedback(grads)

        def q(g, r):
            tot = g.to(torch.float32) + r
            qv, scale = quantize_int8(tot)
            dq = dequantize_int8(qv, scale)
            return dq.to(g.dtype), tot - dq

        return tree_unzip(tree_map(q, grads, error_feedback), 2)
    raise ValueError(f"unknown scheme {scheme!r}")
