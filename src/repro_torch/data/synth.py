"""Synthetic categorical datasets with the paper's query shapes.

The paper evaluates on FLIGHTS (|V_Z|=161, |V_X| in {7,24,161}), TAXI
(|V_Z|=7548, |V_X| in {12,24}) and POLICE (|V_Z| in {191,2110}, |V_X| in
{2,5}). Those raw files are not available offline, so we generate
datasets with the same statistical structure and *planted ground truth*:

* a target distribution Q over V_X;
* `n_close` candidates whose true distribution sits at controlled l1
  distances from Q (the planted top-k, with a controllable separation
  gap — this is what stresses Guarantee 1);
* remaining candidates drawn from a Dirichlet prior, rejected into a
  band of distances >= far_distance from Q;
* candidate frequencies following a Zipf law (the paper's "rare top-k"
  FLIGHTS-q2/q3 regime corresponds to planting the close candidates in
  the Zipf tail via `close_rank`).

Ground truth (true candidate distributions + true distances) ships with
the dataset so tests/benchmarks can check Guarantees 1 and 2 exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SynthSpec", "SynthDataset", "make_dataset", "perturb_distribution"]


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    v_z: int = 161
    v_x: int = 24
    num_tuples: int = 2_000_000
    k: int = 10
    n_close: int = 10  # candidates planted near the target
    close_distance: float = 0.02  # l1 distance of planted matches
    far_distance: float = 0.25  # minimum l1 distance of non-matches
    zipf_a: float = 1.2  # candidate frequency skew (1.0 = flat-ish)
    close_rank: str = "head"  # "head" | "tail" — where matches sit in the Zipf order
    target_kind: str = "peaked"  # "peaked" | "uniform"
    seed: int = 0


@dataclasses.dataclass
class SynthDataset:
    spec: SynthSpec
    z: np.ndarray  # (N,) int32 candidate ids
    x: np.ndarray  # (N,) int32 group ids
    target: np.ndarray  # (V_X,) f64 target distribution Q_hat
    true_dists: np.ndarray  # (V_Z,) f64 DATASET-empirical distance to Q (the paper's tau*)
    true_hists: np.ndarray  # (V_Z, V_X) f64 DATASET-empirical candidate distributions (r*)
    gen_hists: np.ndarray  # (V_Z, V_X) f64 generating distributions (before sampling noise)
    close_ids: np.ndarray  # ids of planted close candidates

    @property
    def true_top_k(self) -> np.ndarray:
        return np.argsort(self.true_dists, kind="stable")[: self.spec.k]


def perturb_distribution(p: np.ndarray, dist: float, rng: np.random.Generator) -> np.ndarray:
    """A distribution at l1 distance ~`dist` from p (mass moved randomly)."""
    v = p.copy()
    d = rng.dirichlet(np.ones_like(p))
    e = rng.dirichlet(np.ones_like(p))
    move = (d - e) * (dist / max(np.abs(d - e).sum(), 1e-12))
    v = np.clip(v + move, 1e-9, None)
    return v / v.sum()


def _target(spec: SynthSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.target_kind == "uniform":
        q = np.full(spec.v_x, 1.0 / spec.v_x)
    else:
        q = rng.dirichlet(np.full(spec.v_x, 2.0))
    return q / q.sum()


def make_dataset(spec: SynthSpec) -> SynthDataset:
    """The dataset ``spec`` describes, drawn on the host in the
    reference's order from ``spec.seed``."""
    rng = np.random.default_rng(spec.seed)
    q = _target(spec, rng)

    # Candidate frequencies: Zipf over ranks, assigned to candidate ids.
    ranks = np.arange(1, spec.v_z + 1, dtype=np.float64)
    freq = ranks ** (-spec.zipf_a)
    freq /= freq.sum()

    # Planted close candidates occupy the head or tail of the Zipf order.
    ids = np.arange(spec.v_z)
    if spec.close_rank == "tail":
        close_ids = ids[-spec.n_close :]
    else:
        close_ids = ids[: spec.n_close]

    # Per-candidate true distributions.
    hists = np.zeros((spec.v_z, spec.v_x))
    spread = np.linspace(0.5, 1.5, num=max(spec.n_close, 1))
    ci = 0
    for z in range(spec.v_z):
        if z in set(close_ids.tolist()):
            d = spec.close_distance * spread[ci % len(spread)]
            ci += 1
            hists[z] = perturb_distribution(q, d, rng)
        else:
            # Rejection sample into the far band.
            for _ in range(64):
                h = rng.dirichlet(np.full(spec.v_x, 0.8))
                if np.abs(h - q).sum() >= spec.far_distance:
                    break
            else:  # force it far: move mass to a random corner
                h = perturb_distribution(q, spec.far_distance * 1.5, rng)
            hists[z] = h

    # Sample tuples: z ~ freq, x | z ~ hists[z].
    z = rng.choice(spec.v_z, size=spec.num_tuples, p=freq).astype(np.int32)
    x = np.empty(spec.num_tuples, dtype=np.int32)
    # Vectorized per-candidate sampling. A stable sort has one result, so
    # the ids sort as int16 where they fit: numpy radix-sorts 16-bit keys,
    # several times faster than its int32 sort.
    order = np.argsort(z.astype(np.int16) if spec.v_z <= 1 << 15 else z, kind="stable")
    z_sorted = z[order]
    boundaries = np.searchsorted(z_sorted, np.arange(spec.v_z + 1))
    for zv in range(spec.v_z):
        lo, hi = boundaries[zv], boundaries[zv + 1]
        if hi > lo:
            x[order[lo:hi]] = rng.choice(spec.v_x, size=hi - lo, p=hists[zv])

    # Ground truth in the paper's sense: r*_i is the histogram a COMPLETE
    # SCAN of the dataset would produce (not the generating distribution).
    emp = np.bincount(z.astype(np.int64) * spec.v_x + x, minlength=spec.v_z * spec.v_x)
    emp = emp.reshape(spec.v_z, spec.v_x).astype(np.float64)
    row = np.maximum(emp.sum(axis=1, keepdims=True), 1.0)
    emp_hat = emp / row
    true_dists = np.abs(emp_hat - q[None, :]).sum(axis=1)
    return SynthDataset(
        spec=spec,
        z=z,
        x=x,
        target=q,
        true_dists=true_dists,
        true_hists=emp_hat,
        gen_hists=hists,
        close_ids=np.asarray(close_ids),
    )
