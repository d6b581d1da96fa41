"""The `Telemetry` handle: one object threaded through the serving stack.

Port of `repro.obs.telemetry`. It bundles what every instrumented layer
needs:

  registry — `MetricsRegistry` (counters, gauges, latency histograms),
             on the handle's ``device``
  tracer   — `Tracer` (per-query lifecycle and per-round-batch events)
  curves   — per-query confidence trajectories: the (tuples, eps(n),
             delta_upper) points the scheduler stages at every poll, the
             tuples-to-confidence curve of each query (Theorem 1's
             n -> eps(n), measured); the anytime API's
             `AnytimeAnswer.curve_point` speaks the same columns (see
             `record_anytime`)

A `MatchServer(telemetry=True)` owns one and threads it into its
scheduler, its `PrefetchSource` and its `CheckpointManager`; every
instrumented point guards on ``telemetry is not None``, so the default
path is untouched. One handle belongs to one server: query ids key the
curve store.

A curve point is a dict of the columns `CURVE_COLUMNS`;
`confidence_curve` returns a query's points as a float array and
`export_confidence_csv` writes them as a CSV file. A query keeps at
most ``max_curve_points`` points, the earliest (a confidence curve's
shape is its rise); the points dropped are counted in ``curve_drops``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["Telemetry", "CURVE_COLUMNS"]

# Column order of a confidence-trajectory point (see
# `SharedCountsScheduler.flush_telemetry` for where each is measured).
CURVE_COLUMNS = (
    "round",        # rounds (windows dispatched) at the poll
    "tuples",       # shared tuples_read total at the poll
    "tuples_live",  # tuples read while this query was live (its cost)
    "n_min",        # min_i n_i — the worst-sampled candidate's sample count
    "tau_min",      # min_i tau_i — the distance estimate of the current best
    "eps_n",        # Theorem 1 eps at n_min and per-candidate budget delta/V_Z
    "delta_upper",  # the stats tail's failure bound sum_i delta_i
    "confidence",   # max(0, 1 - delta_upper)
)


class Telemetry:
    """Registry + tracer + per-query confidence-trajectory store.
    ``device`` is the registry's (the CUDA device unless "cpu")."""

    def __init__(self, *, tracer_capacity: int = 8192, max_curve_points: int = 4096,
                 clock=None, device=None):
        self.registry = MetricsRegistry(device=device)
        self.tracer = Tracer(capacity=tracer_capacity, clock=clock)
        self.max_curve_points = max_curve_points
        self._curves: Dict[int, List[dict]] = {}
        self.curve_drops = 0  # points not recorded because of the per-query cap
        self._lock = threading.Lock()
        self._flush_hooks: List = []

    # -- producer flush hooks ----------------------------------------------

    def add_flush_hook(self, fn) -> None:
        """Register a producer's drain (the scheduler's `flush_telemetry`).
        A producer may stage raw measurements and shape them in batches
        off its hot path; every read accessor below runs the hooks first,
        so a reader sees current data."""
        self._flush_hooks.append(fn)

    def remove_flush_hook(self, fn) -> None:
        """Unregister a producer's drain, after running it once (a
        supervisor retiring a wounded server's scheduler, so the shared
        handle neither keeps it alive nor loses its staged points)."""
        fn()
        self._flush_hooks.remove(fn)

    def _flush(self) -> None:
        # outside self._lock: the hooks call record_curve_point themselves
        for fn in self._flush_hooks:
            fn()

    # -- confidence trajectories -------------------------------------------

    def record_curve_point(self, qid: int, point: dict) -> None:
        """Append one poll's point to a query's trajectory."""
        with self._lock:
            pts = self._curves.setdefault(qid, [])
            if pts and all(pts[-1][c] == point[c] for c in ("round", "tuples", "delta_upper")):
                return  # a repeat poll at the same round (an admission right
                # after a loop poll): nothing new to plot
            if len(pts) >= self.max_curve_points:
                self.curve_drops += 1
                return
            pts.append(point)

    def record_anytime(self, qid: int, answer) -> None:
        """Append an `AnytimeAnswer`'s curve point to its trajectory: an
        answer polled from outside (`MatchServer.poll_result`) lands on
        the query's curve like a point the scheduler recorded, with the
        same dedup and cap (``answer.curve_point()`` gives exactly
        `CURVE_COLUMNS`)."""
        self.record_curve_point(qid, answer.curve_point())

    def trajectory(self, qid: int) -> List[dict]:
        """The recorded points of one query, oldest first."""
        self._flush()
        with self._lock:
            return list(self._curves.get(qid, ()))

    def query_ids(self) -> List[int]:
        self._flush()
        with self._lock:
            return sorted(self._curves)

    def confidence_curve(self, qid: int) -> np.ndarray:
        """(points, len(CURVE_COLUMNS)) float64 array of one query."""
        pts = self.trajectory(qid)
        if not pts:
            return np.zeros((0, len(CURVE_COLUMNS)))
        return np.asarray([[float(p[c]) for c in CURVE_COLUMNS] for p in pts], np.float64)

    def export_confidence_csv(self, path, qid: Optional[int] = None) -> int:
        """Write the trajectories (one query's, or all) as CSV; returns rows."""
        qids = [qid] if qid is not None else self.query_ids()
        rows = 0
        with open(path, "w") as f:
            f.write("qid," + ",".join(CURVE_COLUMNS) + "\n")
            for q in qids:
                for p in self.trajectory(q):
                    f.write(f"{q}," + ",".join(repr(float(p[c])) for c in CURVE_COLUMNS) + "\n")
                    rows += 1
        return rows
