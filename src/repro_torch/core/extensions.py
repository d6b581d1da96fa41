"""Paper Appendix A extensions.

A.1.1  SUM aggregations via measure-biased sampling: pre-build a sample
       where tuple t is replicated proportionally to its measure Y; then
       COUNT-matching over the biased sample equals SUM-matching over
       the original data (Ding et al.'s measure-biased trick, one extra
       pass per measure attribute).
A.1.2  Candidates defined by boolean predicates over multiple attributes,
       supported by DENSITY MAPS (per-block per-value tuple counts, not
       just presence bits) with AND/OR count estimation for AnyActive.
A.2.1  Distinct eps_1 (separation) / eps_2 (reconstruction).
A.2.3  A range [k_lo, k_hi]: HistSim picks the k in the range with the
       widest tau-gap (easiest to certify), exactly as described.
A.3.1  No-index operation = the ScanMatch variant (core/engine.py).

Port of `repro.core.extensions`. The sampling and density-map helpers
and `pick_k_in_range` are the reference's numpy code, copied;
`assign_deviations_two_eps` runs on tensors through the port's
`deviations` and `bounds`, on the device of its ``tau``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.deviations import DeviationState, split_point, top_k_mask

__all__ = [
    "measure_biased_sample",
    "DensityMap",
    "PredicateNode",
    "estimate_block_counts",
    "assign_deviations_two_eps",
    "pick_k_in_range",
]


# ---------------------------------------------------------------------------
# A.1.1 measure-biased sampling for SUM aggregations
# ---------------------------------------------------------------------------

def measure_biased_sample(
    z: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    *,
    target_size: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a measure-biased sample for `SELECT X, SUM(Y) ... GROUP BY X`.

    Tuple t is included with multiplicity proportional to its measure
    y_t >= 0 (systematic residual sampling keeps the estimator unbiased
    while bounding the sample size). Running COUNT-based HistSim over the
    returned (z', x') matches SUM-based histograms of the original data.
    """
    y = np.asarray(y, np.float64)
    if (y < 0).any():
        raise ValueError("measure attribute must be nonnegative")
    total = y.sum()
    if total <= 0:
        raise ValueError("measure attribute sums to zero")
    rng = np.random.default_rng(seed)
    expect = y * (target_size / total)
    base = np.floor(expect).astype(np.int64)
    frac = expect - base
    extra = (rng.random(len(y)) < frac).astype(np.int64)
    reps = base + extra
    idx = np.repeat(np.arange(len(y)), reps)
    perm = rng.permutation(len(idx))
    idx = idx[perm]
    return np.asarray(z)[idx].astype(np.int32), np.asarray(x)[idx].astype(np.int32)


# ---------------------------------------------------------------------------
# A.1.2 density maps + boolean predicates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DensityMap:
    """Per-block tuple counts for each value of each candidate attribute.

    counts[attr][block, value] = #tuples in `block` with attr == value,
    saturated to 255 (uint8 — "slightly costlier" than bitmaps, paper).
    """

    counts: dict  # attr name -> (num_blocks, |V_attr|) uint8

    @classmethod
    def build(cls, blocks_by_attr: dict, cardinalities: dict) -> "DensityMap":
        out = {}
        for attr, blocks in blocks_by_attr.items():
            blocks = np.asarray(blocks)
            nb = blocks.shape[0]
            v = cardinalities[attr]
            c = np.zeros((nb, v), np.uint16)
            rows = np.repeat(np.arange(nb), blocks.shape[1])
            vals = blocks.reshape(-1)
            ok = (vals >= 0) & (vals < v)
            np.add.at(c, (rows[ok], vals[ok]), 1)
            out[attr] = np.minimum(c, 255).astype(np.uint8)
        return cls(counts=out)


@dataclasses.dataclass(frozen=True)
class PredicateNode:
    """Boolean predicate tree over attribute values: leaf | AND | OR."""

    op: str  # "leaf" | "and" | "or"
    attr: Optional[str] = None
    value: Optional[int] = None
    children: Tuple["PredicateNode", ...] = ()

    @classmethod
    def leaf(cls, attr: str, value: int) -> "PredicateNode":
        return cls(op="leaf", attr=attr, value=value)

    @classmethod
    def and_(cls, *children) -> "PredicateNode":
        return cls(op="and", children=tuple(children))

    @classmethod
    def or_(cls, *children) -> "PredicateNode":
        return cls(op="or", children=tuple(children))

    def evaluate(self, tuple_values: dict) -> bool:
        if self.op == "leaf":
            return tuple_values[self.attr] == self.value
        results = [c.evaluate(tuple_values) for c in self.children]
        return all(results) if self.op == "and" else any(results)


def estimate_block_counts(dmap: DensityMap, pred: PredicateNode, block_size: int) -> np.ndarray:
    """Upper-bound estimate of tuples per block satisfying `pred`.

    leaf  -> exact per-block count of the value;
    AND   -> min of children (can overestimate, never underestimates);
    OR    -> sum of children clipped at block size (likewise an upper
             bound). Upper bounds are safe for AnyActive: a block is only
             skipped when the estimate is 0, which then is exact — so the
             guarantees are untouched (paper A.1.2).
    """
    if pred.op == "leaf":
        return dmap.counts[pred.attr][:, pred.value].astype(np.int32)
    child = [estimate_block_counts(dmap, c, block_size) for c in pred.children]
    if pred.op == "and":
        return np.minimum.reduce(child)
    return np.minimum(np.add.reduce(child), block_size).astype(np.int32)


# ---------------------------------------------------------------------------
# A.2.1 distinct eps_1 / eps_2
# ---------------------------------------------------------------------------

def assign_deviations_two_eps(
    tau,
    n,
    *,
    k: int,
    eps_sep: float,
    eps_rec: float,
    delta: float,
    v_x: int,
) -> DeviationState:
    """Sec 3.3 deviation assignment with separate guarantee tolerances.

    eps_sep bounds Guarantee 1 (separation), eps_rec Guarantee 2
    (reconstruction): i in M gets eps_i = min(eps_rec, s + eps_sep/2 -
    tau_i); j not in M gets eps_j = tau_j - max(s - eps_sep/2, 0).
    With eps_sep == eps_rec this is exactly assign_deviations.
    """
    tau = torch.as_tensor(tau, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=tau.device)
    v_z = tau.shape[0]
    in_m = top_k_mask(tau, k)
    s = split_point(tau, k)
    eps_in = torch.clamp_max(s + 0.5 * eps_sep - tau, eps_rec)
    eps_out = tau - torch.clamp_min(s - 0.5 * eps_sep, 0.0)
    eps_i = torch.clamp_min(torch.where(in_m, eps_in, eps_out), 0.0)
    log_delta_i = bounds.theorem1_log_delta(eps_i, n, v_x)
    delta_i = torch.exp(log_delta_i)
    delta_upper = torch.sum(delta_i)
    log_threshold = torch.log(
        torch.tensor(delta / float(v_z), dtype=torch.float32, device=tau.device)
    )
    return DeviationState(
        tau=tau,
        in_top_k=in_m,
        split=s,
        eps_i=eps_i,
        log_delta_i=log_delta_i,
        delta_upper=delta_upper,
        active=log_delta_i > log_threshold,
    )


# ---------------------------------------------------------------------------
# A.2.3 k ranges
# ---------------------------------------------------------------------------

def pick_k_in_range(tau, k_lo: int, k_hi: int) -> int:
    """Choose k in [k_lo, k_hi] with the widest gap tau_(k+1) - tau_(k).

    "there may be a very large separation between the 7th- and 8th-closest
    candidates, in which case HistSim can automatically choose k = 7, as
    this likely provides a small delta_upper as soon as possible."
    """
    if isinstance(tau, torch.Tensor):
        tau = tau.detach().cpu().numpy()
    tau = np.sort(np.asarray(tau, np.float64))
    v_z = len(tau)
    k_hi = min(k_hi, v_z - 1)
    k_lo = max(1, k_lo)
    if k_lo > k_hi:
        raise ValueError(f"empty k range [{k_lo}, {k_hi}] for V_Z={v_z}")
    gaps = tau[k_lo : k_hi + 1] - tau[k_lo - 1 : k_hi]
    return int(k_lo + np.argmax(gaps))
