"""Adafactor (Shazeer & Stern 2018) with factored second moments.

Port of `repro.optimizer.adafactor`: factored row / column statistics
for leaves with ``ndim >= 2`` (state ``{"row", "col"}``), a full second
moment otherwise (``{"nu"}``); relative step sizes and RMS update
clipping per the paper; momentum off (memory).

On a mesh (``splits``, see `optimizer.base`) a leaf is this rank's block
of the parameter, ``row`` and ``col`` the blocks `launch.specs.
opt_state_pspecs` gives them, and every mean is the whole leaf's: the
block's sum over the reduced dims, summed over each group that splits
one of them, over the whole count (``row``'s mean over the last dim,
``col``'s over dim -2, the mean of ``row``, ``rms_u`` and ``scale``).
A leaf with no split dim takes `torch.mean`, as on one device.
"""

from __future__ import annotations

import torch

from repro_torch.optimizer.base import (
    Optimizer, f32, lr_schedule, tree_map, tree_map_, tree_unzip,
)

__all__ = ["adafactor"]


def _mean(x: torch.Tensor, dims, split, keepdim: bool = False) -> torch.Tensor:
    """The whole leaf's mean over ``dims`` (all of them where None) of
    ``x``, a block split as ``split`` says ({dim: TP}, or None: whole)."""
    from repro_torch.models.layers import all_reduce

    dims = tuple(range(x.ndim)) if dims is None else tuple(d % x.ndim for d in dims)
    groups = [tp for d, tp in (split or {}).items() if d in dims]
    if not groups:
        return torch.mean(x, dim=dims, keepdim=keepdim)
    total = torch.sum(x, dim=dims, keepdim=keepdim)
    count = 1
    for d in dims:
        count *= x.shape[d]
    for tp in groups:
        all_reduce(total, tp)
        count *= tp.size
    return total / count


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

    def upd(g, st, p, beta2, lr_t, eps1_t, split=None):
        g = g.to(torch.float32)
        # each a * b + c as one fused multiply-add, as XLA contracts it
        g2 = torch.addcmul(eps1_t, g, g)
        if _factored(p):
            row = torch.addcmul((1 - beta2) * _mean(g2, (-1,), split), beta2, st["row"])
            col = torch.addcmul((1 - beta2) * _mean(g2, (-2,), split), beta2, st["col"])
            # row's last dim is the leaf's dim -2
            row_split = {d: tp for d, tp in (split or {}).items() if d < p.ndim - 1}
            row_mean = _mean(row, (-1,), row_split, keepdim=True)
            r = row / torch.clamp_min(row_mean, eps1)
            v = r[..., None] * col[..., None, :]
            new_st = {"row": row, "col": col}
        else:
            v = torch.addcmul((1 - beta2) * g2, beta2, st["nu"])
            new_st = {"nu": v}
        u = g * torch.rsqrt(torch.clamp_min(v, eps1))
        # update clipping by RMS
        rms_u = torch.sqrt(_mean(u * u, None, split))
        u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
        # relative step scale
        scale = torch.clamp_min(torch.sqrt(_mean(torch.square(p.to(torch.float32)), None, split)),
                                eps2)
        du = -lr_t * scale * u
        if weight_decay and p.ndim >= 2:
            du = torch.addcmul(du, lr_t * weight_decay, p.to(torch.float32), value=-1)
        return du.to(p.dtype), new_st

    def _splits(splits, params):
        return splits if splits is not None else tree_map(lambda p: None, params)

    @torch.no_grad()
    def update(grads, state, params, step, splits=None):
        s = scalars(step)
        out = tree_map(lambda g, st, p, sp: upd(g, st, p, *s, split=sp), grads, state, params,
                       _splits(splits, params))
        return tree_unzip(out, 2)

    @torch.no_grad()
    def update_(grads, state, params, step, splits=None):
        s = scalars(step)

        def one(g, st, p, sp):
            du, new_st = upd(g, st, p, *s, split=sp)
            for name, t in new_st.items():
                st[name].copy_(t)
            p.add_(du)

        tree_map_(one, grads, state, params, _splits(splits, params))

    return Optimizer(init=init, update=update, update_=update_)
