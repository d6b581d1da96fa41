"""Double-buffered background-thread block prefetch (paper Sec 4.2).

Port of `repro.io.prefetch`. While the device runs round t, a worker
thread fetches window t + 1 from the wrapped source into a bounded
queue (``depth=2``: double buffering; a slower source gets
back-pressure, not unbounded memory).

The worker only fetches: it calls no kernel op, so every ingest stays on
the consumer's stream (kernel B keeps its scratch per device, stream and
shape). A window the source hands over in host memory (a host-resident
source) is staged by the worker: copied into pinned memory, then to the
device with ``non_blocking=True`` on a side CUDA stream, with an event
recorded after the copies. The consumer makes its current stream wait
on that event before the round reads the window, and marks the window's
tensors used on its stream (``record_stream``) so the caching allocator
does not hand their memory to the side stream early. A device-resident
source's windows are device gathers already; they pass as they are.

Closing the stream mid-pass signals the worker and drains the queue, so
a blocked ``put`` cannot leak the thread; a wrapped `ResilientSource`
gets the stop flag as its cancellation event, so a worker inside a
backoff wait stops at its next boundary. A worker exception is raised
at the consumer's next pull; one that lands after the stream was closed
is logged, as is a worker that outlives ``join_timeout``.

With ``telemetry=`` (a `repro_torch.obs.Telemetry`) the stream measures
the stall-against-hide balance the double buffer is for: each window's
fetch (and staging) time on the worker (``prefetch_fetch_seconds``,
what is hidden) and the consumer's wait for it (``prefetch_wait_seconds``,
what leaks through), the queue depth at the last hand-off, and one
``prefetch_stream`` event a stream with the totals, the hidden seconds
and the stall share. The failures above become counters and events too
(``prefetch_worker_error``, ``prefetch_join_timeout``,
``prefetch_dropped_error``). The timings are kept in plain lists, one
writer thread each, and reach the registry once, when the stream closes.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.io.block_source import BlockSource, WindowData
from repro_torch.io.faults import FetchCancelled, _wrap_attrs, find_resilient

__all__ = ["PrefetchSource"]

logger = logging.getLogger(__name__)

_TENSORS = WindowData._fields[:5]


def _stage(wd: WindowData, device: torch.device, side) -> tuple:
    """(the window on ``device``, the event after its copies): pinned
    host copies moved with ``non_blocking=True`` on the ``side`` stream."""
    with torch.cuda.stream(side):
        moved = [getattr(wd, f).pin_memory().to(device, non_blocking=True) for f in _TENSORS]
        done = torch.cuda.Event()
        done.record(side)
    return WindowData(*moved, bitmap_by_id=wd.bitmap_by_id, id_base=wd.id_base), done


class PrefetchSource:
    """Wrap any `BlockSource`; `stream` overlaps fetch with consumption.

    ``join_timeout`` bounds how long closing a stream waits for the
    worker (a daemon thread, so it cannot hang interpreter exit; past
    the timeout it is still running, which is why that warns).
    """

    def __init__(self, inner: BlockSource, *, depth: int = 2,
                 join_timeout: float = 10.0, telemetry=None):
        if depth < 1:
            raise ValueError(f"need depth >= 1, got {depth}")
        _wrap_attrs(self, inner)
        self.depth = depth
        self.join_timeout = join_timeout
        self.telemetry = telemetry
        if telemetry is not None:
            reg = telemetry.registry
            self._h_wait = reg.histogram(
                "prefetch_wait_seconds", help="consumer stall per window (0 = fully hidden)")
            self._h_fetch = reg.histogram(
                "prefetch_fetch_seconds", help="producer-side gather cost per window")
            self._g_depth = reg.gauge("prefetch_queue_depth", "staged windows at last hand-off")
            self._c_errors = reg.counter(
                "prefetch_worker_errors_total", "prefetch worker exceptions")
            self._c_timeouts = reg.counter(
                "prefetch_join_timeouts_total",
                "stream closes that abandoned a still-running worker")
            self._c_dropped = reg.counter(
                "prefetch_dropped_errors_total",
                "worker errors that surfaced only after stream close")

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        return self.inner.fetch(win, pad_to)

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        windows = list(windows)
        tel = self.telemetry
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        resilient = find_resilient(self.inner)
        if resilient is not None:
            resilient.set_cancel_event(stop)
        failure: list = []  # the worker's exception, whether or not it queued
        device = self.device
        staging = device is not None and device.type == "cuda"
        # the stall-against-hide accounting, without a lock on the hot path:
        # each list has one writer thread (fetch_times and produced the
        # worker's, wait_times the consumer's); the registry gets them once,
        # when the stream closes
        fetch_times: list = []
        wait_times: list = []
        produced = [0]
        depth_last = 0

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                side = torch.cuda.Stream(device) if staging else None
                for win in windows:
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    wd, done = self.inner.fetch(win, pad_to), None
                    if staging and wd.indices.device.type == "cpu":
                        wd, done = _stage(wd, device, side)
                    if tel is not None:
                        fetch_times.append(time.perf_counter() - t0)
                    if not _put(("data", (wd, done))):
                        return
                    produced[0] += 1
                _put(("done", None))
            except FetchCancelled:
                # the consumer closed the stream and the resilient layer
                # dropped the fetch in flight: a clean shutdown
                return
            except BaseException as exc:
                # recorded unconditionally: the queued item is lost when
                # the consumer is already closing
                failure.append(exc)
                if tel is not None:
                    self._c_errors.inc(1)
                    tel.tracer.emit("prefetch_worker_error", source=type(self.inner).__name__,
                                    error=repr(exc))
                _put(("error", exc))

        t = threading.Thread(target=worker, name="block-prefetch", daemon=True)
        t.start()
        raised = False
        try:
            while True:
                if tel is None:
                    kind, payload = q.get()
                else:
                    t0 = time.perf_counter()
                    kind, payload = q.get()
                    wait_times.append(time.perf_counter() - t0)
                    # produced - consumed, read without the queue's lock: an
                    # estimate (the worker's count may lag a put), for a gauge
                    depth_last = max(produced[0] - len(wait_times), 0)
                if kind == "done":
                    break
                if kind == "error":
                    raised = True
                    raise payload
                wd, done = payload
                if done is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(done)
                    for f in _TENSORS:
                        getattr(wd, f).record_stream(current)
                yield wd
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=self.join_timeout)
            if t.is_alive():
                logger.warning(
                    "prefetch worker still running %.1fs after stream close "
                    "(blocked in %s.fetch?); abandoning daemon thread",
                    self.join_timeout, type(self.inner).__name__,
                )
                if tel is not None:
                    self._c_timeouts.inc(1)
                    tel.tracer.emit("prefetch_join_timeout", source=type(self.inner).__name__,
                                    timeout_s=self.join_timeout)
            elif failure and not raised:
                logger.warning(
                    "prefetch worker failed after the stream was closed; dropping: %r",
                    failure[0],
                )
                if tel is not None:
                    self._c_dropped.inc(1)
                    tel.tracer.emit("prefetch_dropped_error", source=type(self.inner).__name__,
                                    error=repr(failure[0]))
            if resilient is not None and resilient.cancel_event is stop:
                resilient.set_cancel_event(None)
            if tel is not None:
                # the worker has exited (or was abandoned past join_timeout:
                # its list stays readable, appends are atomic)
                self._h_fetch.observe_many(fetch_times)
                self._h_wait.observe_many(wait_times)
                self._g_depth.set(depth_last)
                wait_s, fetch_s = float(sum(wait_times)), float(sum(fetch_times))
                tel.tracer.emit(
                    "prefetch_stream", source=type(self.inner).__name__,
                    windows=len(wait_times), wait_s=wait_s, fetch_s=fetch_s,
                    # gather wall the consumer never waited for, and the share
                    # that leaked through as stalls (a hand-off's overhead can
                    # make the wait exceed the fetch it is charged to)
                    hidden_s=max(fetch_s - wait_s, 0.0),
                    stall_frac=min(wait_s / fetch_s if fetch_s > 0 else 0.0, 1.0),
                )
