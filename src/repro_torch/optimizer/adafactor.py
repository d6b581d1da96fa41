"""Adafactor (Shazeer & Stern 2018) with factored second moments.

Port of `repro.optimizer.adafactor`: factored row / column statistics
for leaves with ``ndim >= 2`` (state ``{"row", "col"}``), a full second
moment otherwise (``{"nu"}``); relative step sizes and RMS update
clipping per the paper; momentum off (memory).
"""

from __future__ import annotations

import torch

from repro_torch.optimizer.base import (
    Optimizer, f32, lr_schedule, tree_map, tree_map_, tree_unzip,
)

__all__ = ["adafactor"]


def adafactor(
    lr,
    *,
    decay: float = 0.8,  # beta2 exponent: 1 - step^-decay
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = lr_schedule(lr)

    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(params):
        def per_param(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"row": torch.zeros(p.shape[:-1], **kw),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"nu": torch.zeros(p.shape, **kw)}

        return tree_map(per_param, params)

    def scalars(step):
        """The step's () f32 tensors, made once an update."""
        stepf = step.to(torch.float32) + 1.0
        return (1.0 - torch.pow(stepf, f32(-decay, step.device)), lr_fn(step),
                f32(eps1, step.device))

    def upd(g, st, p, beta2, lr_t, eps1_t):
        g = g.to(torch.float32)
        # each a * b + c as one fused multiply-add, as XLA contracts it
        g2 = torch.addcmul(eps1_t, g, g)
        if _factored(p):
            row = torch.addcmul((1 - beta2) * torch.mean(g2, dim=-1), beta2, st["row"])
            col = torch.addcmul((1 - beta2) * torch.mean(g2, dim=-2), beta2, st["col"])
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            r = row / torch.clamp_min(row_mean, eps1)
            v = r[..., None] * col[..., None, :]
            new_st = {"row": row, "col": col}
        else:
            v = torch.addcmul((1 - beta2) * g2, beta2, st["nu"])
            new_st = {"nu": v}
        u = g * torch.rsqrt(torch.clamp_min(v, eps1))
        # update clipping by RMS
        rms_u = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
        # relative step scale
        scale = torch.clamp_min(torch.sqrt(torch.mean(torch.square(p.to(torch.float32)))), eps2)
        du = -lr_t * scale * u
        if weight_decay and p.ndim >= 2:
            du = torch.addcmul(du, lr_t * weight_decay, p.to(torch.float32), value=-1)
        return du.to(p.dtype), new_st

    @torch.no_grad()
    def update(grads, state, params, step):
        s = scalars(step)
        out = tree_map(lambda g, st, p: upd(g, st, p, *s), grads, state, params)
        return tree_unzip(out, 2)

    @torch.no_grad()
    def update_(grads, state, params, step):
        s = scalars(step)

        def one(g, st, p):
            du, new_st = upd(g, st, p, *s)
            for name, t in new_st.items():
                st[name].copy_(t)
            p.add_(du)

        tree_map_(one, grads, state, params)

    return Optimizer(init=init, update=update, update_=update_)
