"""Per-query lifecycle tracing: a bounded ring buffer and a JSONL sink.

Port of `repro.obs.tracer` (pure Python; the port keeps its own copy).
Events are plain dicts, ``{"seq", "ts", "kind", ...payload}``, pushed by
the serving layers at host polls only: the round path records nothing
(the `repro_torch.obs` package docstring lists the event kinds). The
ring is a ``deque(maxlen=...)``, so a long-lived server holds a bounded
tail of its trace; ``export_jsonl`` writes what the ring holds.

Determinism: the sequence of events (kinds, each query's enqueue ->
admit -> round_batch* -> retire, slots, round counts) is a function of
the workload for a seeded run. Only ``ts`` and the ``*_s`` timing
fields vary between runs, so golden tests compare `Tracer.skeleton`,
the events with the timing fields stripped.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

__all__ = ["Tracer", "TIMING_FIELDS"]

# Fields whose values are wall-clock measurements: stripped by
# `skeleton()` so golden tests can compare traces across runs.
TIMING_FIELDS = frozenset({
    "ts", "dur_s", "gather_s", "dispatch_s", "sync_s", "assemble_s",
    "wall_s", "wait_s", "fetch_s", "hidden_s", "stall_frac", "save_s",
    "worker_gather_s",
})


class Tracer:
    """Bounded in-memory event trace with a JSONL sink.

    capacity  — ring size (the oldest events drop first); ``events_total``
                keeps counting past the cap, so truncation is visible.
    clock     — the time source (tests pin it for reproducible ``ts``);
                by default ``time.perf_counter`` from the tracer's
                construction.
    """

    def __init__(self, capacity: int = 8192, clock=None):
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.events_total = 0
        self._clock = clock if clock is not None else time.perf_counter
        self._epoch = self._clock()

    def emit(self, kind: str, **fields) -> dict:
        """Record one event; returns the event dict (already in the ring)."""
        with self._lock:
            ev = {"seq": self._seq, "ts": self._clock() - self._epoch, "kind": kind}
            ev.update(fields)
            self._seq += 1
            self.events_total += 1
            self._ring.append(ev)
        return ev

    @contextmanager
    def span(self, kind: str, **fields) -> Iterator[dict]:
        """Time a with-block; the event (with ``dur_s``) is emitted at exit,
        so the trace stays ordered by completion time."""
        t0 = self._clock()
        extra: Dict[str, object] = dict(fields)
        try:
            yield extra
        finally:
            extra["dur_s"] = self._clock() - t0
            self.emit(kind, **extra)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """The ring's contents (oldest first), optionally of one kind."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def skeleton(self, kind: Optional[str] = None) -> List[dict]:
        """The events with their timing fields stripped: the deterministic
        part of the trace, which golden tests compare."""
        return [
            {k: v for k, v in e.items() if k not in TIMING_FIELDS}
            for e in self.events(kind)
        ]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def export_jsonl(self, path) -> int:
        """Write the ring to ``path`` as JSON Lines; returns the event count."""
        evs = self.events()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e, sort_keys=True) + "\n")
        return len(evs)
