"""Deviation selection (Sec 3.3 of the paper) — the heart of HistSim.

Port of `repro.core.deviations`. Given distance estimates tau_i and
sample counts n_i, choose per-candidate deviations eps_i that satisfy
Lemma 2 while making each as large as possible:

  * split point  s = midpoint between the k-th and (k+1)-th smallest tau
  * i in M (top-k):   eps_i = min(eps, s + eps/2 - tau_i)
  * j not in M:       eps_j = tau_j - max(s - eps/2, 0)

then delta_upper = sum_i delta_i (``max`` times V_Z for SlowMatch) and
the active set is {i : delta_i > delta / V_Z} (AnyActive, Sec 4.2).

The reference runs one query per call and `vmap`s over query slots; here
the slot axis is written out: `assign_deviations_dynamic` takes tau of
shape (Q, V_Z) with per-slot k, eps and delta (a 1-D tau is one slot).
Selection is a stable ascending sort, so exact ties go to the lower
index, as the reference's ``lax.top_k`` does (``torch.topk`` promises
no tie order). `assign_closeness` (the tolerant closeness rule) and
`prune_far` (early rejection of clearly-far candidates) take the slot
axis the same way, with per-slot eps, gap and delta.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import bounds

__all__ = [
    "DeviationState",
    "assign_closeness",
    "assign_deviations",
    "assign_deviations_dynamic",
    "prune_far",
    "slowmatch_deviations",
    "split_point",
    "top_k_mask",
]


def _per_slot(v, q: int, device) -> torch.Tensor:
    """A (Q,) f32 tensor of per-slot values from a tensor or a scalar."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(q)


def _metric_log_delta(eps_i, tau, n, v_x, metric, bounds_mode):
    if bounds_mode == "conservative":
        return bounds.metric_log_delta(eps_i, n, v_x, metric=metric)
    if bounds_mode == "native":
        return bounds.metric_native_log_delta(eps_i, n, v_x, tau=tau, metric=metric)
    raise ValueError(
        f"bounds_mode must be 'native' or 'conservative', got {bounds_mode!r}"
    )


class DeviationState(NamedTuple):
    """Result of one statistics-engine iteration (Alg. 1 lines 8-14)."""

    tau: torch.Tensor  # (..., V_Z) f32 distance estimates
    in_top_k: torch.Tensor  # (..., V_Z) bool — membership in M
    split: torch.Tensor  # (...) f32 — split point s
    eps_i: torch.Tensor  # (..., V_Z) f32 assigned deviations
    log_delta_i: torch.Tensor  # (..., V_Z) f32 log failure bounds
    delta_upper: torch.Tensor  # (...) f32 sum_i delta_i
    active: torch.Tensor  # (..., V_Z) bool — delta_i > delta/V_Z


def _ascending(tau: torch.Tensor) -> tuple:
    """(values, indices) of tau sorted ascending, ties by lower index."""
    return torch.sort(tau, dim=-1, stable=True)


def top_k_mask(tau: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k smallest entries of a (V_Z,) tau, exactly k
    of them even under ties (lower index first)."""
    v_z = tau.shape[0]
    idx = _ascending(tau)[1][: min(k, v_z)]
    return torch.zeros((v_z,), dtype=torch.bool, device=tau.device).index_fill_(0, idx, True)


def split_point(tau: torch.Tensor, k: int) -> torch.Tensor:
    """s = (tau_(k) + tau_(k+1)) / 2 in sorted order for a (V_Z,) tau."""
    v_z = tau.shape[0]
    if k >= v_z:  # degenerate: everything matches
        return torch.max(tau)
    small = _ascending(tau)[0]
    kth = small[k - 1] if k >= 1 else torch.zeros((), dtype=tau.dtype, device=tau.device)
    return 0.5 * (kth + small[k])


def assign_deviations(tau, n, *, k: int, eps: float, delta: float, v_x: int) -> DeviationState:
    """Static-parameter entry point over `assign_deviations_dynamic`
    (k doubles as the selection cap)."""
    return assign_deviations_dynamic(
        tau, n, k=k, eps=eps, delta=delta, v_x=v_x, criterion="histsim", k_cap=k
    )


def assign_deviations_dynamic(
    tau: torch.Tensor,
    n: torch.Tensor,
    *,
    k,
    eps,
    delta,
    v_x: int,
    criterion: str = "histsim",
    k_cap: Optional[int] = None,
    metric: str = "l1",
    bounds_mode: str = "native",
) -> DeviationState:
    """Deviation assignment for Q query slots at once.

    tau: (Q, V_Z) or (V_Z,) distance estimates; n: (V_Z,) shared sample
    counts; k, eps, delta: per-slot values, (Q,) tensors or scalars.
    Only the m = min(k_cap + 1, V_Z) smallest order statistics are read
    (membership in M plus the split point's two neighbours); k_cap None
    means V_Z. ``criterion`` "slowmatch" reports delta_upper = V_Z *
    max_i delta_i. ``metric``/``bounds_mode`` route the failure bounds
    as in the reference (the l1 arm is Theorem 1 under either mode).
    """
    if criterion not in ("histsim", "slowmatch"):
        raise ValueError(criterion)
    tau = torch.as_tensor(tau, dtype=torch.float32)
    single = tau.dim() == 1
    if single:
        tau = tau[None, :]
    q, v_z = tau.shape
    dev = tau.device
    k = torch.as_tensor(k, dtype=torch.int64, device=dev).reshape(-1).expand(q)
    eps, delta = _per_slot(eps, q, dev), _per_slot(delta, q, dev)
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)

    cap = v_z if k_cap is None else int(k_cap)
    if cap < 1:
        raise ValueError(f"need k_cap >= 1, got {k_cap}")
    m = min(cap + 1, v_z)
    vals, order = _ascending(tau)
    sorted_small, small_idx = vals[:, :m], order[:, :m]
    # rank-based membership: the j-th smallest has rank j; everything
    # past the m smallest has rank >= m > k
    ranks = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    in_m = torch.zeros((q, v_z), dtype=torch.bool, device=dev).scatter_(
        1, small_idx, ranks < k[:, None]
    )
    kth = sorted_small.gather(1, torch.clamp(k - 1, 0, m - 1)[:, None])[:, 0]
    k1th = sorted_small.gather(1, torch.clamp(k, 0, m - 1)[:, None])[:, 0]
    s = torch.where(k >= v_z, torch.amax(tau, dim=1), 0.5 * (kth + k1th))

    e = eps[:, None]
    eps_in = torch.minimum(e, s[:, None] + 0.5 * e - tau)
    eps_out = tau - torch.clamp_min(s - 0.5 * eps, 0.0)[:, None]
    eps_i = torch.clamp_min(torch.where(in_m, eps_in, eps_out), 0.0)

    log_delta_i = _metric_log_delta(eps_i, tau, n, v_x, metric, bounds_mode)
    if criterion == "slowmatch":
        # every candidate individually at confidence delta/V_Z (Sec 5.2)
        delta_upper = float(v_z) * torch.exp(torch.amax(log_delta_i, dim=1))
    else:
        delta_upper = torch.sum(torch.exp(log_delta_i), dim=1)
    log_threshold = torch.log(delta / float(v_z))
    out = DeviationState(
        tau=tau,
        in_top_k=in_m,
        split=s,
        eps_i=eps_i,
        log_delta_i=log_delta_i,
        delta_upper=delta_upper,
        active=log_delta_i > log_threshold[:, None],
    )
    if single:
        return DeviationState(*(leaf[0] for leaf in out))
    return out


def slowmatch_deviations(tau, n, *, k: int, eps: float, delta: float, v_x: int) -> DeviationState:
    """SlowMatch's termination state (paper Sec 5.2): delta_upper = V_Z *
    max_i delta_i, so the shared ``delta_upper < delta`` test requires
    every candidate at confidence delta/V_Z."""
    return assign_deviations_dynamic(
        tau, n, k=k, eps=eps, delta=delta, v_x=v_x, criterion="slowmatch", k_cap=k
    )


def assign_closeness(
    tau: torch.Tensor,
    n: torch.Tensor,
    *,
    eps,
    gap,
    delta,
    v_x: int,
    metric: str = "l1",
    bounds_mode: str = "native",
) -> DeviationState:
    """Tolerant closeness test for Q slots at once, in the same
    `DeviationState` shape as the top-k rule.

    Each candidate is labeled close (true distance <= eps) or far (>=
    eps + gap), thresholded at t = eps + gap/2; inside the gap either
    label is allowed. The decision margin m_i = max(tau_i - eps, (eps +
    gap) - tau_i) >= gap/2 is the deviation that would break the label,
    so delta_i = metric_delta(m_i, n_i) and delta_upper = sum_i delta_i.
    ``in_top_k`` holds the close label, ``split`` the threshold t and
    ``eps_i`` the margin; k plays no role. tau: (Q, V_Z) or (V_Z,);
    eps, gap, delta: (Q,) tensors or scalars.
    """
    tau = torch.as_tensor(tau, dtype=torch.float32)
    single = tau.dim() == 1
    if single:
        tau = tau[None, :]
    q, v_z = tau.shape
    dev = tau.device
    eps, gap, delta = (_per_slot(v, q, dev) for v in (eps, gap, delta))
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)

    threshold = eps + 0.5 * gap
    e, g = eps[:, None], gap[:, None]
    margin = torch.clamp_min(torch.maximum(tau - e, (e + g) - tau), 0.0)
    log_delta_i = _metric_log_delta(margin, tau, n, v_x, metric, bounds_mode)
    log_threshold = torch.log(delta / float(v_z))
    out = DeviationState(
        tau=tau,
        in_top_k=tau <= threshold[:, None],
        split=threshold,
        eps_i=margin,
        log_delta_i=log_delta_i,
        delta_upper=torch.sum(torch.exp(log_delta_i), dim=1),
        active=log_delta_i > log_threshold[:, None],
    )
    if single:
        return DeviationState(*(leaf[0] for leaf in out))
    return out


def prune_far(
    tau: torch.Tensor,
    n: torch.Tensor,
    *,
    far_edge,
    delta,
    v_x: int,
    metric: str = "l1",
) -> torch.Tensor:
    """Early-reject mask: candidates whose lower confidence bound already
    clears ``far_edge``, ``tau_i - conf_i > far_edge`` with conf_i the
    metric-native deviation at the per-candidate budget delta/V_Z.

    Callers pass far_edge = eps + gap for closeness slots and split +
    eps/2 for top-k slots. The mask only shrinks the I/O marking; the
    failure bounds keep summing over every candidate. tau: (Q, V_Z) or
    (V_Z,); far_edge and delta: (Q,) tensors or scalars.
    """
    tau = torch.as_tensor(tau, dtype=torch.float32)
    single = tau.dim() == 1
    if single:
        tau = tau[None, :]
    q, v_z = tau.shape
    dev = tau.device
    far_edge, delta = _per_slot(far_edge, q, dev), _per_slot(delta, q, dev)
    conf = bounds.metric_native_epsilon(
        torch.as_tensor(n, dtype=torch.float32, device=dev), (delta / float(v_z))[:, None],
        v_x, tau=tau, metric=metric,
    )
    out = (tau - conf) > far_edge[:, None]
    return out[0] if single else out
