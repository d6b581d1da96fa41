"""I/O fault injection and the resilient source boundary.

Port of `repro.io.faults`. Two failure classes matter to a sampling
engine fed by block fetches: availability (a fetch raises or stalls)
and integrity (a fetch returns a truncated or corrupted window). A bad
window that reached `ingest` would poison the shared counts, which
outlive the fault through the on-disk cache snapshots.

`FaultySource` (+ `FaultInjector`) is the seeded chaos wrapper:
transient fetch exceptions, stalls, truncated and corrupted windows, one
mid-stream EOF and one unrecoverable crash, each drawn from a seeded
per-attempt RNG (the reference's draws, one per attempt), so a run is
reproducible fault for fault and both packages inject the same faults
for the same plan and seed.

`ResilientSource` is the boundary every window passes before ingest:
bounded retries with exponential backoff, seeded jitter and an optional
per-fetch deadline for the transient errors; `validate_window` on every
window; quarantine instead of poison: a window that exhausts its
retries or fails validation never reaches ingest, `stream` skips it,
`fetch` raises `WindowQuarantined`, and its block ids wait in
`take_quarantined()` for the scheduler, which re-derives the guarantee
over the surviving blocks. A cooperative ``cancel_event`` stops the
retry loop at its next boundary.

Validation levels (``validate=``): "structural" checks shapes and
dtypes only, with no device sync; "content" adds value ranges, the z/x
padding pairing and an exact bitmap rebuild on the host; "auto" is
"content" when every tensor of the window lies on the CPU (a host,
disk or remote source, where corruption lives) and "structural" when
the window is on the device.

What differs from the reference is the representation: packed bitmap
words are int32 tensors carrying the uint32 bits, window ids are
int64, and a device-resident source's window carries the whole
(num_blocks, W) bitmap table (``bitmap_by_id``), which the structural
check holds to the table's shape and which a fault copy gathers to the
window's rows before it leaves the device.

With ``telemetry=`` (a `repro_torch.obs.Telemetry`) the resilient source
counts its retries, transient and permanent faults, validation failures
and quarantined blocks in the ``io_*`` counters, and emits one
``window_quarantine`` event a quarantined window.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bitmap import build_block_bitmap, words_for
from repro_torch.io.block_source import BlockSource, WindowData

__all__ = [
    "CorruptWindowError",
    "FaultInjector",
    "FaultPlan",
    "FaultySource",
    "FetchCancelled",
    "ResilientSource",
    "RetryPolicy",
    "TransientIOError",
    "TruncatedStreamError",
    "UnrecoverableIOError",
    "WindowQuarantined",
    "find_resilient",
    "maybe_chaos",
    "validate_window",
]

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Exception taxonomy
# --------------------------------------------------------------------------


class TransientIOError(IOError):
    """A fetch failure expected to heal on retry."""


class TruncatedStreamError(EOFError):
    """Mid-stream EOF: the source ended before the window was served
    (transient)."""


class UnrecoverableIOError(RuntimeError):
    """A failure no retry can heal. Not in the transient set: it
    propagates out of `ResilientSource` and crashes the round, which the
    `ServeSupervisor` recovers from."""


class CorruptWindowError(ValueError):
    """`validate_window`'s verdict: not a valid window of this source."""


class WindowQuarantined(RuntimeError):
    """Raised by `ResilientSource.fetch` after a window is quarantined;
    carries the window's global block ids. `ResilientSource.stream`
    absorbs it (skips the window)."""

    def __init__(self, block_ids: np.ndarray, cause: BaseException):
        self.block_ids = np.asarray(block_ids, np.int64).ravel()
        self.cause = cause
        super().__init__(f"window of {self.block_ids.size} blocks quarantined: {cause!r}")


class FetchCancelled(RuntimeError):
    """The cooperative cancellation flag fired mid-retry: the consumer no
    longer wants the window. Not a fault; nothing is quarantined."""


# --------------------------------------------------------------------------
# Window integrity validation
# --------------------------------------------------------------------------

_LEAVES = (
    ("indices", 1, (torch.int32, torch.int64)),
    ("z", 2, (torch.int32,)),
    ("x", 2, (torch.int32,)),
    ("bitmap", 2, (torch.int32,)),  # int32 words carrying the uint32 bits
    ("valid", 1, (torch.bool,)),
)


def _is_host(wd: WindowData) -> bool:
    return all(getattr(wd, name).device.type == "cpu" for name, _, _ in _LEAVES)


def validate_window(
    wd: WindowData,
    *,
    num_blocks: int,
    block_size: int,
    v_z: int,
    v_x: int,
    pad_to: Optional[int] = None,
    level: str = "auto",
) -> None:
    """Raise `CorruptWindowError` unless ``wd`` is a well-formed window
    of this source (see the module docstring for the levels)."""
    if level not in ("auto", "structural", "content"):
        raise ValueError(f"unknown validation level {level!r}")
    for name, ndim, dtypes in _LEAVES:
        leaf = getattr(wd, name)
        if not isinstance(leaf, torch.Tensor) or leaf.dim() != ndim:
            raise CorruptWindowError(
                f"{name}: expected a {ndim}-d tensor, got {type(leaf).__name__} "
                f"shape {getattr(leaf, 'shape', None)}"
            )
        if leaf.dtype not in dtypes:
            raise CorruptWindowError(f"{name}: dtype {leaf.dtype} not in {dtypes}")
    length = wd.indices.shape[0]
    if pad_to is not None and length != pad_to:
        raise CorruptWindowError(f"window length {length} != pad_to {pad_to} (truncated?)")
    rows = (("z", wd.z), ("x", wd.x), ("valid", wd.valid))
    if not wd.bitmap_by_id:
        rows += (("bitmap", wd.bitmap),)
    elif wd.bitmap.shape[0] != num_blocks:
        raise CorruptWindowError(
            f"bitmap table has {wd.bitmap.shape[0]} rows, the source {num_blocks} blocks"
        )
    for name, leaf in rows:
        if leaf.shape[0] != length:
            raise CorruptWindowError(
                f"{name}: {leaf.shape[0]} rows, indices has {length} (truncated?)"
            )
    if tuple(wd.z.shape) != (length, block_size) or wd.x.shape != wd.z.shape:
        raise CorruptWindowError(
            f"z/x shape {tuple(wd.z.shape)}/{tuple(wd.x.shape)} != ({length}, {block_size})"
        )
    if wd.bitmap.shape[1] != words_for(v_z):
        raise CorruptWindowError(
            f"bitmap width {wd.bitmap.shape[1]} != words_for({v_z})={words_for(v_z)}"
        )
    if level == "structural" or (level == "auto" and not _is_host(wd)):
        return
    # -- content checks (on the host, one pass over the window's bytes) ---
    idx = wd.indices.cpu().numpy()
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= num_blocks):
        raise CorruptWindowError(
            f"block ids outside [0, {num_blocks}): [{idx.min()}, {idx.max()}]"
        )
    z, x = wd.z.cpu().numpy(), wd.x.cpu().numpy()
    if z.size and (int(z.min()) < -1 or int(z.max()) >= v_z):
        raise CorruptWindowError(f"z values outside [-1, {v_z}): [{z.min()}, {z.max()}]")
    if x.size and (int(x.min()) < -1 or int(x.max()) >= v_x):
        raise CorruptWindowError(f"x values outside [-1, {v_x}): [{x.min()}, {x.max()}]")
    if ((z >= 0) != (x >= 0)).any():
        raise CorruptWindowError("z/x padding mismatch: (z >= 0) != (x >= 0) somewhere")
    valid = wd.valid.cpu().numpy()
    if valid.any():
        rebuilt = build_block_bitmap(z[valid], v_z)
        rows_u32 = wd.bitmap_rows().cpu().numpy().view(np.uint32)
        if not np.array_equal(rebuilt, rows_u32[valid]):
            raise CorruptWindowError("bitmap inconsistent with window tuples")


# --------------------------------------------------------------------------
# Deterministic fault injection
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-attempt fault probabilities + one-shot fault positions.

    Probabilities are judged per fetch attempt (retries draw fresh) from
    a seeded RNG; ``eof_at`` / ``crash_at`` name one 0-based global
    attempt index each and fire exactly once.
    """

    p_transient: float = 0.0  # raise TransientIOError (retry heals)
    p_stall: float = 0.0  # serve the window after sleeping stall_s
    stall_s: float = 0.005
    p_corrupt: float = 0.0  # serve a window with out-of-range ids
    p_truncate: float = 0.0  # serve a window with a missing row
    eof_at: Optional[int] = None  # one TruncatedStreamError (transient)
    crash_at: Optional[int] = None  # one UnrecoverableIOError (fatal)

    def __post_init__(self):
        total = self.p_transient + self.p_stall + self.p_corrupt + self.p_truncate
        if not (0.0 <= total <= 1.0):
            raise ValueError(f"fault probabilities sum to {total}, need [0, 1]")


class FaultInjector:
    """Seeded per-attempt fault schedule: one draw of
    ``np.random.default_rng(seed)`` per attempt, so the schedule is a
    pure function of (plan, seed, call order)."""

    def __init__(self, plan: FaultPlan, *, seed: int = 0):
        self.plan = plan
        self._rng = np.random.default_rng(seed)
        self.attempts = 0
        self.injected: dict = {
            "transient": 0, "stall": 0, "corrupt": 0, "truncate": 0, "eof": 0, "crash": 0,
        }

    def next_fault(self) -> Optional[str]:
        i = self.attempts
        self.attempts += 1
        p = self.plan
        # the draw is consumed even when a one-shot fires, so the rest of
        # the schedule matches the run without one-shots
        u = self._rng.random()
        if p.crash_at is not None and i == p.crash_at:
            kind = "crash"
        elif p.eof_at is not None and i == p.eof_at:
            kind = "eof"
        else:
            kind, acc = None, 0.0
            for name, prob in (
                ("transient", p.p_transient), ("stall", p.p_stall),
                ("corrupt", p.p_corrupt), ("truncate", p.p_truncate),
            ):
                acc += prob
                if u < acc:
                    kind = name
                    break
        if kind is not None:
            self.injected[kind] += 1
        return kind


def _wrap_attrs(wrapper, inner) -> None:
    """Copy the `BlockSource` attributes (and the device) of ``inner``."""
    wrapper.inner = inner
    wrapper.num_blocks = inner.num_blocks
    wrapper.block_size = inner.block_size
    wrapper.v_z = inner.v_z
    wrapper.v_x = inner.v_x
    wrapper.tuples_per_block = inner.tuples_per_block
    wrapper.device = getattr(inner, "device", None)


class FaultySource:
    """Chaos wrapper: serve ``inner``'s windows through the injector's
    fault schedule. Corruption and truncation are applied to host copies
    of the window (a corrupted window is no longer the resident one)."""

    def __init__(self, inner: BlockSource, plan: FaultPlan = FaultPlan(), *, seed: int = 0):
        _wrap_attrs(self, inner)
        self.injector = FaultInjector(plan, seed=seed)

    @staticmethod
    def _host(wd: WindowData) -> WindowData:
        """A host copy of the window's own rows (a by-id window's rows are
        gathered on the device first, not the whole table copied)."""
        return WindowData(
            wd.indices.cpu(), wd.z.cpu(), wd.x.cpu(), wd.bitmap_rows().cpu(), wd.valid.cpu()
        )

    def _corrupt(self, wd: WindowData) -> WindowData:
        wd = self._host(wd)
        z = wd.z.clone()
        if z.numel():
            z[0, : max(1, z.shape[1] // 8)] = self.v_z + 7  # out of range
        return wd._replace(z=z)

    def _truncate(self, wd: WindowData) -> WindowData:
        wd = self._host(wd)
        return WindowData(*(getattr(wd, f)[:-1] for f in WindowData._fields[:5]))

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        kind = self.injector.next_fault()
        if kind == "crash":
            raise UnrecoverableIOError("injected: device lost")
        if kind == "eof":
            raise TruncatedStreamError("injected: mid-stream EOF")
        if kind == "transient":
            raise TransientIOError("injected: transient fetch failure")
        wd = self.inner.fetch(win, pad_to)
        if kind == "stall":
            time.sleep(self.injector.plan.stall_s)
        elif kind == "corrupt":
            wd = self._corrupt(wd)
        elif kind == "truncate":
            wd = self._truncate(wd)
        return wd

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        # window by window through our own fetch: every window meets the
        # fault schedule
        for win in windows:
            yield self.fetch(win, pad_to)


# --------------------------------------------------------------------------
# The resilient boundary
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + seeded jitter.

    ``deadline_s`` bounds one fetch's total wall (attempts + backoff);
    past it a transient fault is permanent even with retries left. The
    jitter comes from the policy's own seeded RNG."""

    max_retries: int = 4
    backoff_s: float = 0.02
    backoff_mult: float = 2.0
    jitter: float = 0.25  # +- fraction of the delay
    deadline_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"need max_retries >= 0, got {self.max_retries}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"need 0 <= jitter <= 1, got {self.jitter}")


class ResilientSource:
    """Retry + validate + quarantine wrapper around any `BlockSource`.

    Nothing that fails validation, and nothing from a fetch that could
    not be completed, reaches ingest: `stream` skips a quarantined
    window, `fetch` raises `WindowQuarantined`, and every quarantined
    block id waits in `take_quarantined()`. ``cancel_event`` (see
    `set_cancel_event`) makes backoff waits interruptible; cancellation
    raises `FetchCancelled` and quarantines nothing.
    """

    TRANSIENT = (
        TransientIOError,
        TimeoutError,
        ConnectionError,
        InterruptedError,
        EOFError,  # covers TruncatedStreamError
    )

    def __init__(
        self,
        inner: BlockSource,
        *,
        policy: RetryPolicy = RetryPolicy(),
        validate: str = "auto",
        telemetry=None,
        clock=time.monotonic,
        sleep=None,
    ):
        if validate not in ("auto", "structural", "content", "off"):
            raise ValueError(f"unknown validation level {validate!r}")
        _wrap_attrs(self, inner)
        self.policy = policy
        self.validate = validate
        self.telemetry = telemetry
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(policy.seed)
        self.cancel_event: Optional[threading.Event] = None
        self.retries_total = 0
        self.transient_faults = 0
        self.permanent_faults = 0
        self.validation_failures = 0
        self.windows_quarantined = 0
        self.blocks_quarantined = 0
        self._lock = threading.Lock()
        self._pending: List[Tuple[np.ndarray, str]] = []
        if telemetry is not None:
            reg = telemetry.registry
            self._c_retries = reg.counter(
                "io_fetch_retries_total", "fetch attempts repeated after a transient fault")
            self._c_transient = reg.counter(
                "io_transient_faults_total", "transient fetch failures observed")
            self._c_permanent = reg.counter(
                "io_permanent_faults_total",
                "fetches escalated to permanent (retries/deadline exhausted)")
            self._c_validation = reg.counter(
                "io_validation_failures_total", "windows that failed integrity validation")
            self._c_quarantined = reg.counter(
                "io_blocks_quarantined_total", "blocks quarantined at the source boundary")

    def set_cancel_event(self, event: Optional[threading.Event]) -> None:
        """Install (or clear, with None) the cooperative cancellation flag;
        a nested `ResilientSource` gets it too."""
        self.cancel_event = event
        nested = find_resilient(self.inner)
        if nested is not None:
            nested.set_cancel_event(event)

    # -- quarantine bookkeeping --------------------------------------------

    def _quarantine(self, win: np.ndarray, cause: BaseException, kind: str) -> WindowQuarantined:
        ids = np.asarray(win, np.int64).ravel()
        with self._lock:
            self._pending.append((ids, kind))
            self.windows_quarantined += 1
            self.blocks_quarantined += int(ids.size)
        logger.warning("quarantining window of %d blocks (%s): %r", ids.size, kind, cause)
        if self.telemetry is not None:
            self._c_quarantined.inc(int(ids.size))
            self.telemetry.tracer.emit(
                "window_quarantine", blocks=int(ids.size), why=kind, cause=repr(cause)
            )
        return WindowQuarantined(ids, cause)

    def take_quarantined(self) -> np.ndarray:
        """Drain the block ids quarantined since the last call, those of a
        nested `ResilientSource` included (thread-safe: the producer may
        be a prefetch worker)."""
        with self._lock:
            pending, self._pending = self._pending, []
        chunks = [ids for ids, _ in pending]
        nested = find_resilient(self.inner)
        if nested is not None:
            inner_ids = nested.take_quarantined()
            if inner_ids.size:
                chunks.append(inner_ids)
        if not chunks:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(chunks))

    # -- the retry loop ----------------------------------------------------

    def _cancelled(self) -> bool:
        ev = self.cancel_event
        return ev is not None and ev.is_set()

    def _wait(self, delay: float) -> None:
        ev = self.cancel_event
        if ev is not None:
            ev.wait(delay)  # returns early when cancellation fires
        elif self._sleep is not None:
            self._sleep(delay)
        else:
            time.sleep(delay)

    def _validate(self, wd: WindowData, pad_to: Optional[int]) -> None:
        if self.validate == "off":
            return
        validate_window(
            wd, num_blocks=self.num_blocks, block_size=self.block_size,
            v_z=self.v_z, v_x=self.v_x, pad_to=pad_to, level=self.validate,
        )

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        win = np.asarray(win, np.int64).ravel()
        policy = self.policy
        t0 = self._clock()
        delay = policy.backoff_s
        retries = 0
        while True:
            if self._cancelled():
                raise FetchCancelled("fetch cancelled by consumer")
            try:
                wd = self.inner.fetch(win, pad_to)
            except self.TRANSIENT as exc:
                self.transient_faults += 1
                if self.telemetry is not None:
                    self._c_transient.inc(1)
                deadline_hit = (
                    policy.deadline_s is not None and self._clock() - t0 >= policy.deadline_s
                )
                if retries >= policy.max_retries or deadline_hit:
                    self.permanent_faults += 1
                    if self.telemetry is not None:
                        self._c_permanent.inc(1)
                    why = "deadline" if deadline_hit else "retries-exhausted"
                    raise self._quarantine(win, exc, why) from exc
                retries += 1
                self.retries_total += 1
                if self.telemetry is not None:
                    self._c_retries.inc(1)
                jitter = 1.0 + policy.jitter * (2.0 * self._rng.random() - 1.0)
                self._wait(delay * jitter)
                delay *= policy.backoff_mult
                continue
            try:
                self._validate(wd, pad_to)
            except CorruptWindowError as exc:
                # permanent for this window: a re-read of corrupt storage
                # returns the same corruption
                self.validation_failures += 1
                self.permanent_faults += 1
                if self.telemetry is not None:
                    self._c_validation.inc(1)
                    self._c_permanent.inc(1)
                raise self._quarantine(win, exc, "validation") from exc
            return wd

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        """Each window through the resilient fetch; a quarantined window
        is skipped (its blocks are already recorded)."""
        for win in windows:
            try:
                yield self.fetch(win, pad_to)
            except WindowQuarantined:
                continue


def find_resilient(source) -> Optional[ResilientSource]:
    """The `ResilientSource` in a wrapper chain, or None."""
    seen = 0
    while source is not None and seen < 8:
        if isinstance(source, ResilientSource):
            return source
        source = getattr(source, "inner", None)
        seen += 1
    return None


# --------------------------------------------------------------------------
# FASTMATCH_CHAOS: the chaos lane
# --------------------------------------------------------------------------


def maybe_chaos(source: BlockSource, *, env: Optional[dict] = None):
    """Wrap ``source`` in transient-only injected faults when
    ``FASTMATCH_CHAOS=1`` (the reference's variables and plan).

    Only retry-heals-it faults are injected (transient errors and short
    stalls, a generous retry budget), so a run under chaos must be
    bitwise the fault-free run. ``FASTMATCH_CHAOS_SEED`` varies the
    schedule.
    """
    e = os.environ if env is None else env
    if e.get("FASTMATCH_CHAOS", "0") != "1":
        return source
    seed = int(e.get("FASTMATCH_CHAOS_SEED", "0"))
    plan = FaultPlan(p_transient=0.05, p_stall=0.01, stall_s=0.001)
    return ResilientSource(
        FaultySource(source, plan, seed=seed),
        policy=RetryPolicy(max_retries=16, backoff_s=0.001, seed=seed),
    )
