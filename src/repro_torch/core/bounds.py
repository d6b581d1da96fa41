"""Theorem 1 of the paper and related concentration bounds.

Port of `repro.core.bounds`, in float32 with the reference's operation
order. The paper's central statistical tool (Sec 3.4): with n_i samples
of candidate i over a support of size ``V_X``, the empirical
distribution is within eps_i of the true one in l1 with probability
> 1 - delta_i, where

    eps_i   = sqrt( (2 / n_i) * (V_X log 2 - log delta_i) )
    delta_i = 2**V_X * exp(-eps_i**2 * n_i / 2)

computed in log space (2**V_X overflows long before the bound is
vacuous).

The per-metric family reuses Theorem 1 through each metric's ℓ1 budget,
the inverse modulus of continuity from the metric registry
(`repro_torch.kernels.metrics`): l1 is the identity, chi2 eps/3,
squared Hellinger eps^2/4. The metric-native family sharpens the budget
with the candidate's observed distance tau:

  chi2       max(eps/3, (sqrt(tau+eps) - sqrt(tau))^2)
  hellinger  max(eps^2/4, (sqrt(1+2 eps) - 1)^2, 2 (sqrt(tau+eps) - sqrt(tau))^2)

and `metric_native_epsilon` inverts it (l1: b; chi2: min(3 b, b + 2
sqrt(tau b)); hellinger: min(sqrt(b) + b/2, b/2 + sqrt(2 tau b)), with
b = theorem1_epsilon). The derivations are in the reference's module
docstring. ``waggoner_epsilon`` (Waggoner '15) and ``slowmatch_epsilon``
serve the paper's Fig. 4 and the SlowMatch baseline.

Arguments may be tensors or Python numbers; results are float32 tensors
on the device of the tensor arguments.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import metrics as _metrics

__all__ = [
    "theorem1_epsilon",
    "theorem1_delta",
    "theorem1_log_delta",
    "theorem1_samples",
    "metric_l1_budget",
    "metric_log_delta",
    "metric_epsilon",
    "metric_native_l1_budget",
    "metric_native_log_delta",
    "metric_native_epsilon",
    "BOUNDED_METRICS",
    "waggoner_epsilon",
    "slowmatch_epsilon",
]

BOUNDED_METRICS = _metrics.METRIC_NAMES

_LOG2 = 0.6931471805599453


def _f32(v, like=None) -> torch.Tensor:
    """``v`` as a float32 tensor, on ``like``'s device when v is a number."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def theorem1_epsilon(n, delta, v_x: int) -> torch.Tensor:
    """eps such that ||r_hat - r*||_1 < eps w.p. > 1 - delta after n samples:
    sqrt( (2 / n) * (V_X log 2 - log delta) )."""
    n = _f32(n, delta)
    log_delta = torch.log(_f32(delta, n))
    n = torch.clamp_min(n, 1.0)
    return torch.sqrt((2.0 / n) * (v_x * _LOG2 - log_delta))


def theorem1_log_delta(eps, n, v_x: int) -> torch.Tensor:
    """log delta = V_X log 2 - eps^2 n / 2, clamped to <= 0 (delta <= 1)."""
    eps = _f32(eps, n)
    n = _f32(n, eps)
    log_delta = v_x * _LOG2 - 0.5 * eps * eps * n
    return torch.clamp_max(log_delta, 0.0)


def theorem1_delta(eps, n, v_x: int) -> torch.Tensor:
    """delta_i = min(1, 2^V_X exp(-eps^2 n / 2))."""
    return torch.exp(theorem1_log_delta(eps, n, v_x))


def theorem1_samples(eps: float, delta: float, v_x: int) -> int:
    """Samples needed for eps-deviation w.p. > 1-delta:
    n = (2 / eps^2) * (V_X log 2 - log delta)."""
    n = (2.0 / (eps * eps)) * (v_x * _LOG2 - math.log(delta))
    return int(math.ceil(n))


def metric_l1_budget(eps, metric: str = "l1"):
    """The ℓ1 deviation that guarantees a ``metric``-space deviation of
    at most ``eps`` (identity for l1)."""
    return _metrics.coerce_metric(metric).l1_budget(eps)


def metric_log_delta(eps, n, v_x: int, metric: str = "l1") -> torch.Tensor:
    """log failure probability for a metric-space deviation ``eps``:
    Theorem 1 at the metric's ℓ1 budget."""
    return theorem1_log_delta(metric_l1_budget(eps, metric), n, v_x)


def metric_epsilon(n, delta, v_x: int, metric: str = "l1") -> torch.Tensor:
    """Metric-space deviation guaranteed w.p. > 1 - delta after n samples
    (l1: eps; chi2: 3 eps; hellinger: 2 sqrt(eps))."""
    eps1 = theorem1_epsilon(n, delta, v_x)
    if metric == "l1":
        return eps1
    if metric == "chi2":
        return 3.0 * eps1
    if metric == "hellinger":
        return 2.0 * torch.sqrt(eps1)
    raise ValueError(f"unknown metric {metric!r}; have {BOUNDED_METRICS}")


def metric_native_l1_budget(eps, tau, metric: str = "l1"):
    """Observation-aware ℓ1 budget for a ``metric`` deviation of ``eps``
    at observed distance ``tau``; dominates `metric_l1_budget`."""
    mdef = _metrics.coerce_metric(metric)
    if mdef.native_l1_budget is None:
        return mdef.l1_budget(eps)
    tau = _f32(tau, eps)
    return mdef.native_l1_budget(_f32(eps, tau), tau)


def metric_native_log_delta(eps, n, v_x: int, *, tau, metric: str = "l1") -> torch.Tensor:
    """log failure probability for a metric-space deviation ``eps`` at
    observed distance ``tau``: Theorem 1 at the native ℓ1 budget (for
    l1 exactly `theorem1_log_delta`)."""
    mdef = _metrics.coerce_metric(metric)
    if mdef.native_l1_budget is None:
        return theorem1_log_delta(mdef.l1_budget(eps), n, v_x)
    return theorem1_log_delta(metric_native_l1_budget(eps, tau, metric), n, v_x)


def metric_native_epsilon(n, delta, v_x: int, *, tau, metric: str = "l1") -> torch.Tensor:
    """Metric-space deviation guaranteed w.p. > 1 - delta after n
    samples at observed distance ``tau`` (never above `metric_epsilon`)."""
    b = theorem1_epsilon(n, delta, v_x)
    if metric == "l1":
        return b
    t = torch.clamp_min(_f32(tau, b), 0.0)
    if metric == "chi2":
        return torch.minimum(3.0 * b, b + 2.0 * torch.sqrt(t * b))
    if metric == "hellinger":
        return torch.minimum(
            torch.sqrt(b) + 0.5 * b, 0.5 * b + torch.sqrt(2.0 * t * b)
        )
    raise ValueError(f"unknown metric {metric!r}; have {BOUNDED_METRICS}")


def waggoner_epsilon(n, delta, v_x: int) -> torch.Tensor:
    """Prior-art l1 learning bound (Waggoner '15), for the Fig. 4
    comparison: sqrt(2 V_X / n) + sqrt((2 / n) * log(1 / delta))."""
    n = torch.clamp_min(_f32(n, delta), 1.0)
    log_inv_delta = -torch.log(_f32(delta, n))
    return torch.sqrt(2.0 * v_x / n) + torch.sqrt(2.0 * log_inv_delta / n)


def slowmatch_epsilon(n, delta: float, v_z: int, v_x: int) -> torch.Tensor:
    """Fixed-width CI used by SlowMatch: Theorem 1 at confidence delta/|V_Z|."""
    return theorem1_epsilon(n, delta / float(v_z), v_x)
