"""Metrics registry: counters, gauges, fixed-bin histograms and exporters.

Port of `repro.obs.registry`, with the same names, kinds, errors,
snapshot dict and Prometheus text. Three metric kinds, all on the host
and lock-protected (the prefetch worker records from its own thread):

  Counter   — monotone float; ``inc`` only
  Gauge     — last-write-wins float
  Histogram — fixed upper-bound bins (Prometheus ``le`` semantics) with a
              running sum and count; ``observe`` is an O(1) append, and
              the samples are binned lazily, when something reads the
              histogram, by the package's own histogram kernel (kernel B
              at V_Z = 1 and V_X = the bins + 1, through
              `repro_torch.kernels.ops.histogram`)

A registry belongs to a device: ``MetricsRegistry(device=None)`` is the
CUDA device unless ``device="cpu"`` is passed, and raises without a GPU.
On the card a flush launches kernel B; on the CPU it runs the plain
version (`ref.histogram_ref`); neither falls back to the other. A flush
copies the bin ids to the device and the counts back, which waits for
the device, so it runs only when a reader asks (``snapshot``,
``bucket_counts``, ``to_prometheus``), never in the serving loop.

`MetricsRegistry` is the factory and namespace: ``registry.counter(name)``
returns the existing metric or makes it (a name registered under another
kind raises). Exports: ``to_prometheus()`` (text exposition format) and
``snapshot()`` / ``to_json()`` (a JSON-able dict, one entry a metric).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_LATENCY_BINS"]

# Upper bin edges (seconds) for latency histograms: 100us .. 100s in
# roughly x3 steps, wide enough for one round's dispatch and for an
# exact-completion pass.
DEFAULT_LATENCY_BINS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0
)


def _check_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotone counter (a ``_total`` suffix by convention)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._value}


class Histogram:
    """Fixed-bin histogram with Prometheus ``le`` bucket semantics.

    ``observe`` appends to a list; `_flush` bins the pending samples:
    ``np.searchsorted`` gives each its bin id, and one histogram call on
    ``device`` counts them (one candidate row, one column a bin: the
    ingest op at V_Z = 1). The counts kept are per bin, not cumulative,
    with an overflow bin last; the exporter emits the cumulative form.
    A flush counts exactly up to 2^24 samples a bin (float32 counts).
    """

    kind = "histogram"

    def __init__(self, name: str, edges: Sequence[float] = DEFAULT_LATENCY_BINS,
                 help: str = "", *, device=None):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram {name}: edges must be sorted and non-empty")
        self.name = _check_name(name)
        self.help = help
        self.edges = tuple(float(e) for e in edges)
        self.device = resolve_device(device)
        self._counts = np.zeros(len(self.edges) + 1, np.int64)  # [+Inf] last
        self._sum = 0.0
        self._count = 0
        self._pending: List[float] = []
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._pending.append(float(value))
            self._sum += float(value)
            self._count += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Observe a batch under one lock acquisition: for callers that
        gather samples lock-free on a hot path (the prefetch stream's
        per-window timings) and hand them over once."""
        vals = [float(v) for v in values]
        if not vals:
            return
        with self._lock:
            self._pending.extend(vals)
            self._sum += sum(vals)
            self._count += len(vals)

    def _flush(self) -> None:
        """Bin the pending samples with the histogram kernel."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        vals = np.asarray(pending, np.float64)
        # side="left": v == edge lands in that edge's bucket (v <= le)
        bins = np.searchsorted(self.edges, vals, side="left").astype(np.int32)
        x_idx = torch.from_numpy(bins).to(self.device)
        counts = ops.histogram(None, x_idx, v_z=1, v_x=len(self.edges) + 1)
        with self._lock:
            self._counts += counts[0].cpu().numpy().astype(np.int64)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> np.ndarray:
        """Per-bin (non-cumulative) counts, overflow last."""
        self._flush()
        return self._counts.copy()

    def snapshot(self) -> dict:
        self._flush()
        return {
            "kind": self.kind,
            "edges": list(self.edges),
            "buckets": self._counts.tolist(),
            "sum": self._sum,
            "count": self._count,
        }


class MetricsRegistry:
    """Get-or-create namespace of metrics, and the two exporters.
    ``device`` is where its histograms are binned (see the module
    docstring)."""

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
                    )
                return m
            m = cls(name, *args, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, edges: Sequence[float] = DEFAULT_LATENCY_BINS, help: str = ""
    ) -> Histogram:
        return self._get_or_create(Histogram, name, edges, help, device=self.device)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able {name: metric snapshot} of every registered metric."""
        return {name: self._metrics[name].snapshot() for name in self.names()}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for edge, c in zip(m.edges, m.bucket_counts()):
                    cum += int(c)
                    lines.append(f'{name}_bucket{{le="{_fmt(edge)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Prometheus float rendering: integers without a trailing .0."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)
