"""AdamW with decoupled weight decay and bias correction.

Port of `repro.optimizer.adamw`. Moments are kept in f32 whatever the
parameters' dtype (mixed-precision training with bf16 parameters); the
update is returned in the parameter's dtype. Weight decay applies to
leaves with ``ndim >= 2`` only.

Each ``a * b + c`` that XLA contracts into one fused multiply-add in the
jitted reference is one here too (``torch.addcmul(c, a, b)`` with ``a``
an f32 tensor: one FMA on the CPU's vector units and on the card); XLA's
rewrite of ``(a / b) / c`` as ``a / (b * c)`` is made here too, and the
square root is XLA's correctly rounded one (`base.sqrt_rn`). Fed the same
f32 grads, the update then has the reference's bits wherever
``b1 ** step`` and ``b2 ** step`` do (XLA's and PyTorch's ``pow`` differ
by an ulp at some steps).
"""

from __future__ import annotations

import torch

from repro_torch.optimizer.base import (
    Optimizer, f32, lr_schedule, sqrt_rn, tree_map, tree_map_, tree_unzip,
)

__all__ = ["adamw"]


def adamw(
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    lr_fn = lr_schedule(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def scalars(step):
        """The step's () f32 tensors, made once an update (a tensor made
        from a Python float on the card is a host-to-device copy)."""
        dev = step.device
        stepf = step.to(torch.float32) + 1.0
        b1_t, b2_t = f32(b1, dev), f32(b2, dev)
        return (b1_t, b2_t, f32(weight_decay, dev), 1 - torch.pow(b1_t, stepf),
                1 - torch.pow(b2_t, stepf), lr_fn(step))

    def upd(g, mu, nu, p, b1_t, b2_t, wd_t, corr1, corr2, lr_t):
        g = g.to(torch.float32)
        # b1 * mu + (1 - b1) * g, with the left product fused into the add
        # as XLA fuses it
        mu = torch.addcmul((1 - b1) * g, b1_t, mu)
        nu = torch.addcmul((1 - b2) * g * g, b2_t, nu)
        nu_hat = nu / corr2
        # mu_hat / (sqrt(nu_hat) + eps) with mu_hat = mu / corr1: XLA
        # rewrites (a / b) / c as a / (b * c), and so does this
        u = mu / (corr1 * (sqrt_rn(nu_hat) + eps))
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            u = torch.addcmul(u, wd_t, p.to(torch.float32))
        return (-lr_t * u).to(p.dtype), mu, nu

    @torch.no_grad()
    def update(grads, state, params, step, splits=None):  # elementwise: splits change nothing
        s = scalars(step)
        out = tree_map(lambda g, mu, nu, p: upd(g, mu, nu, p, *s),
                       grads, state["mu"], state["nu"], params)
        updates, mu, nu = tree_unzip(out, 3)
        return updates, {"mu": mu, "nu": nu}

    @torch.no_grad()
    def update_(grads, state, params, step, splits=None):
        s = scalars(step)

        def one(g, mu, nu, p):
            u, new_mu, new_nu = upd(g, mu, nu, p, *s)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
            p.add_(u)

        tree_map_(one, grads, state["mu"], state["nu"], params)

    return Optimizer(init=init, update=update, update_=update_)

