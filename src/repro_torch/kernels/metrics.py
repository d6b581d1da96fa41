"""Pluggable distance metrics over the shared row-normalized counts matrix.

Port of `repro.kernels.metrics`. Every query reduces to the same
per-round computation: normalize each candidate row of the shared
(V_Z, V_X) counts once, then reduce an elementwise score against each
of Q targets,

    tau[q, i] = sum_x score(r_hat[i, x], q_hat[q, x]).

The registry (`METRICS`) carries each metric's score, its ℓ1 budget (the
inverse modulus of continuity `core.bounds` feeds Theorem 1) and its
observation-aware native budget, as in the reference:

  l1         sum |r - q|            in [0, 2]; empty row -> 1
  chi2       sum (r-q)^2 / (r+q)    in [0, 2]; 0/0 lanes -> 0; empty row -> 1
  hellinger  0.5 * sum (sqrt(r) - sqrt(q))^2 (squared)  in [0, 1]; empty row -> 0.5

All scores are 0 at r = q = 0, so padded lanes need no mask.

`distance_multi_ref` is the plain PyTorch version (row sum, then the
``max(row, 1)`` divide, then the score, then the lane sum, in the
reference's order); `distance_multi_xla` is the reference's one-broadcast
(Q, V_Z, V_X) form of the same arithmetic. `distance_multi` launches
CUDA kernel C (``csrc/distance.cu``): its narrow branch (row tiles,
V_X <= 1024) or its wide branch (a block per row), on float32 counts or,
in its uint16 form, on uint16 counts behind an overflow gate that stays
on the card. `distance` is its Q = 1 case with the reference's
single-block V_X bound. Its launch choice is a knob of
`autotune.TauPlan`: ``sweeps`` and ``x_tile`` pick the branch; each
branch picks its own grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

__all__ = [
    "METRICS",
    "METRIC_NAMES",
    "MetricDef",
    "coerce_metric",
    "distance_ref",
    "distance_multi_ref",
    "distance_multi_xla",
    "distance",
    "distance_multi",
    "streaming_tau_bytes",
    "MAX_SINGLE_BLOCK_VX",
    "NARROW_MAX_VX",
    "KERNEL",
    "KERNEL_WIDE",
    "KERNEL_U16",
    "KERNEL_WIDE_U16",
    "wide_branch",
]

# Single-block V_X bound of the reference's Q = 1 kernel form, kept for
# `distance` so the two packages reject the same inputs.
MAX_SINGLE_BLOCK_VX = 4096

# The widest row kernel C's narrow branch takes (kWideRow in the source).
NARROW_MAX_VX = 1024

# counts, q_hat, tau, V_Z, V_X, Q, metric; the uint16 forms take the
# uint16 counts, the f32 counts and the gate's flag in place of counts
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("distance", "fm_distance_narrow", (_P, _P, _P, _I, _I, _I, _I))
KERNEL_WIDE = CudaKernel("distance", "fm_distance_wide", (_P, _P, _P, _I, _I, _I, _I))
KERNEL_U16 = CudaKernel(
    "distance", "fm_distance_narrow_u16", (_P, _P, _P, _P, _P, _I, _I, _I, _I)
)
KERNEL_WIDE_U16 = CudaKernel(
    "distance", "fm_distance_wide_u16", (_P, _P, _P, _P, _P, _I, _I, _I, _I)
)


def _score_l1(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.abs(r - q)


def _score_chi2(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    # 0/0 -> 0: with r, q >= 0 the denominator is 0 only when both are.
    s = r + q
    d = r - q
    return torch.where(s > 0.0, (d * d) / torch.where(s > 0.0, s, 1.0), 0.0)


def _score_hellinger(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(r) - torch.sqrt(q)
    return 0.5 * (d * d)


def streaming_tau_bytes(
    v_z: int, v_x: int, q: int, *, passes: int, counts_itemsize: int
) -> int:
    """Device-memory bytes per tau round for a streaming metric:
    ``passes`` reads of the counts matrix plus targets in / taus out."""
    return passes * v_z * v_x * counts_itemsize + q * (v_x + v_z) * 4


@dataclasses.dataclass(frozen=True)
class MetricDef:
    """One pluggable distance: score + deviation budget + traffic model."""

    name: str
    score: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    l1_budget: Callable
    bytes_model: Callable[..., int] = streaming_tau_bytes
    empty_row_tau: float = 1.0
    native_l1_budget: Optional[Callable] = None
    kernel_id: int = 0  # the metric switch of kernel C


def _budget_l1(eps):
    return eps


def _budget_chi2(eps):
    # chi2 is 3-Lipschitz in p under ℓ1 (see core/bounds.py).
    return eps / 3.0


def _budget_hellinger(eps):
    # |H^2(p, t) - H^2(q, t)| <= sqrt(l1) + l1/2 (see core/bounds.py).
    return 0.25 * eps * eps


def _native_budget_chi2(eps, tau):
    # max(eps/3, (sqrt(tau+eps) - sqrt(tau))^2), derivation in core/bounds.py
    t = torch.clamp_min(tau, 0.0)
    tri = torch.square(torch.sqrt(t + eps) - torch.sqrt(t))
    return torch.maximum(eps / 3.0, tri)


def _native_budget_hellinger(eps, tau):
    # max(eps^2/4, (sqrt(1+2 eps) - 1)^2, 2 (sqrt(tau+eps) - sqrt(tau))^2)
    t = torch.clamp_min(tau, 0.0)
    cs = torch.square(torch.sqrt(1.0 + 2.0 * eps) - 1.0)
    tri = 2.0 * torch.square(torch.sqrt(t + eps) - torch.sqrt(t))
    return torch.maximum(torch.maximum(0.25 * eps * eps, cs), tri)


METRICS = {
    "l1": MetricDef("l1", _score_l1, _budget_l1, empty_row_tau=1.0, kernel_id=0),
    "chi2": MetricDef(
        "chi2", _score_chi2, _budget_chi2, empty_row_tau=1.0,
        native_l1_budget=_native_budget_chi2, kernel_id=1,
    ),
    "hellinger": MetricDef(
        "hellinger", _score_hellinger, _budget_hellinger, empty_row_tau=0.5,
        native_l1_budget=_native_budget_hellinger, kernel_id=2,
    ),
}
METRIC_NAMES = tuple(METRICS)


def coerce_metric(metric) -> MetricDef:
    """Registry lookup with a helpful error; accepts a MetricDef as-is."""
    if isinstance(metric, MetricDef):
        return metric
    try:
        return METRICS[metric]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown metric {metric!r}; have {METRIC_NAMES}"
        ) from None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _normalize(counts: torch.Tensor) -> torch.Tensor:
    counts = counts.to(torch.float32)
    row = torch.sum(counts, dim=1, keepdim=True)
    return counts / torch.clamp_min(row, 1.0)


def distance_ref(counts: torch.Tensor, q_hat: torch.Tensor, *, metric="l1") -> torch.Tensor:
    """(V_Z,) float32 tau_i = sum_x score(normalize(counts_i), q_hat).
    Rows with zero mass score the metric's ``empty_row_tau``."""
    m = coerce_metric(metric)
    r_hat = _normalize(counts)
    return torch.sum(m.score(r_hat, q_hat[None, :].to(torch.float32)), dim=1)


def distance_multi_ref(counts: torch.Tensor, q_hat: torch.Tensor, *, metric="l1") -> torch.Tensor:
    """(Q, V_Z) batched tau: the normalization is computed once for all
    queries, then one lane reduction per target."""
    m = coerce_metric(metric)
    r_hat = _normalize(counts)
    q = q_hat.to(torch.float32)
    return torch.stack(
        [torch.sum(m.score(r_hat, q[i][None, :]), dim=1) for i in range(q.shape[0])]
    )


def distance_multi_xla(counts: torch.Tensor, q_hat: torch.Tensor, *, metric="l1") -> torch.Tensor:
    """(Q, V_Z) batched tau as one (Q, V_Z, V_X) broadcast, the
    reference's "let XLA schedule it" form. The lane sums run in the
    stacked form's order, so the result equals `distance_multi_ref`."""
    m = coerce_metric(metric)
    r_hat = _normalize(counts)
    q = q_hat.to(torch.float32)
    return torch.sum(m.score(r_hat[None, :, :], q[:, None, :]), dim=2)


# ---------------------------------------------------------------------------
# CUDA kernel C
# ---------------------------------------------------------------------------


def wide_branch(v_x: int, *, x_tile: int = 4096, sweeps: int = 0) -> bool:
    """Whether kernel C takes its wide branch: forced by ``sweeps=2``,
    refused at ``sweeps=1`` past the narrow branch's rows, and with
    ``sweeps=0`` taken past min(``x_tile``, `NARROW_MAX_VX`)."""
    if sweeps == 2:
        return True
    if sweeps == 1:
        if v_x > NARROW_MAX_VX:
            raise ValueError(
                f"sweeps=1 forces the single-sweep narrow branch, which holds V_X <= "
                f"{NARROW_MAX_VX}, got V_X={v_x}"
            )
        return False
    if sweeps != 0:
        raise ValueError(f"sweeps must be 0 (auto), 1 or 2, got {sweeps}")
    return v_x > min(x_tile, NARROW_MAX_VX)


def distance_multi(
    counts: torch.Tensor,
    q_hat: torch.Tensor,
    *,
    metric="l1",
    x_tile: int = 4096,
    sweeps: int = 0,
    gate: Optional[tuple] = None,
) -> torch.Tensor:
    """(Q, V_Z) float32 distances through kernel C, for any V_X.

    counts: (V_Z, V_X) float32, q_hat: (Q, V_X) float32, both contiguous
    on the current CUDA device. With uint16 counts, ``gate`` is
    ``(counts_f32, fits)``: the same counts in float32 and a one-element
    bool tensor, ``max(counts_f32) <= 65535``, on the card; kernel C's
    uint16 form reads the uint16 counts where ``fits`` holds and the f32
    ones where it does not, so the gate needs no host read. The branch
    follows `wide_branch`. Launches on the current stream.
    """
    m = coerce_metric(metric)
    lowprec = counts.dtype == torch.uint16
    check_cuda_tensor(counts, "counts", torch.uint16 if lowprec else torch.float32, 2)
    check_cuda_tensor(q_hat, "q_hat", torch.float32, 2)
    v_z, v_x = counts.shape
    num_q, v_xq = q_hat.shape
    if v_xq != v_x:
        raise ValueError(f"q_hat V_X={v_xq} does not match counts V_X={v_x}")
    if lowprec:
        if gate is None:
            raise ValueError("uint16 counts need gate=(counts_f32, fits)")
        full, fits = gate
        check_cuda_tensor(full, "gate counts", torch.float32, 2)
        if full.shape != counts.shape:
            raise ValueError(f"gate counts {tuple(full.shape)} differ from {tuple(counts.shape)}")
        if fits.device != counts.device or fits.dtype != torch.bool or fits.numel() != 1:
            raise ValueError("fits must be a one-element bool tensor on the counts' device")
    elif gate is not None:
        raise ValueError("gate is for uint16 counts")
    wide = wide_branch(v_x, x_tile=x_tile, sweeps=sweeps)
    tau = torch.empty((num_q, v_z), dtype=torch.float32, device=counts.device)
    if v_z == 0 or num_q == 0:
        return tau
    if v_x == 0:
        return tau.zero_()
    tail = (q_hat.data_ptr(), tau.data_ptr(), v_z, v_x, num_q, m.kernel_id)
    if lowprec:
        head = (counts.data_ptr(), full.data_ptr(), fits.data_ptr())
        if wide:
            KERNEL_WIDE_U16.launch(*head, *tail)
        else:
            KERNEL_U16.launch(*head, *tail)
    elif wide:
        KERNEL_WIDE.launch(counts.data_ptr(), *tail)
    else:
        KERNEL.launch(counts.data_ptr(), *tail)
    return tau


def distance(counts: torch.Tensor, q_hat: torch.Tensor, *, metric="l1", **launch) -> torch.Tensor:
    """(V_Z,) single-query tau: the Q = 1 launch of kernel C, with
    `distance_multi`'s launch choices and gate. V_X must not pass
    `MAX_SINGLE_BLOCK_VX`, as in the reference."""
    if counts.shape[1] > MAX_SINGLE_BLOCK_VX:
        raise ValueError(
            f"V_X={counts.shape[1]} exceeds single-block bound {MAX_SINGLE_BLOCK_VX}"
        )
    return distance_multi(counts, q_hat[None, :].contiguous(), metric=metric, **launch)[0]
