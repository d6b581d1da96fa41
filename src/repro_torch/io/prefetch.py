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
is logged, as is a worker that outlives ``join_timeout``. Telemetry is
refused (ROADMAP A7).
"""

from __future__ import annotations

import logging
import queue
import threading
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
    return WindowData(*moved, bitmap_by_id=wd.bitmap_by_id), done


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
        if telemetry is not None:
            raise NotImplementedError(
                "PrefetchSource(telemetry=...) is not ported yet (ROADMAP A7)"
            )
        _wrap_attrs(self, inner)
        self.depth = depth
        self.join_timeout = join_timeout

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        return self.inner.fetch(win, pad_to)

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        windows = list(windows)
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        resilient = find_resilient(self.inner)
        if resilient is not None:
            resilient.set_cancel_event(stop)
        failure: list = []  # the worker's exception, whether or not it queued
        device = self.device
        staging = device is not None and device.type == "cuda"

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
                    wd, done = self.inner.fetch(win, pad_to), None
                    if staging and wd.indices.device.type == "cpu":
                        wd, done = _stage(wd, device, side)
                    if not _put(("data", (wd, done))):
                        return
                _put(("done", None))
            except FetchCancelled:
                # the consumer closed the stream and the resilient layer
                # dropped the fetch in flight: a clean shutdown
                return
            except BaseException as exc:
                # recorded unconditionally: the queued item is lost when
                # the consumer is already closing
                failure.append(exc)
                _put(("error", exc))

        t = threading.Thread(target=worker, name="block-prefetch", daemon=True)
        t.start()
        raised = False
        try:
            while True:
                kind, payload = q.get()
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
            elif failure and not raised:
                logger.warning(
                    "prefetch worker failed after the stream was closed; dropping: %r",
                    failure[0],
                )
            if resilient is not None and resilient.cancel_event is stop:
                resilient.set_cancel_event(None)
