"""Shared-counts multi-query HistSim — the FastMatch scheduling core.

Port of `repro.core.multiquery`, top-k queries only. The counts matrix
``r_i`` is target-independent, so query slots share one counts matrix
and one I/O stream; each slot keeps its own target, (k, eps, delta),
tau, deviations, bounds and active set. The union of the slots' packed
active words drives AnyActive marking.

One `fused_round` per lookahead window does, on the device and without
a host sync: mark (kernel A, one launch for the final marks) + masked
gather + ingest (kernel B) + tau (kernel C) + the deviation assignment
+ the read bookkeeping of the `SampleCursor`. The reference skips ingest and stats with ``lax.cond``
when nothing was marked; here both always run and `torch.where` keeps
the old state unless something was read, so ``round_idx`` advances only
on rounds that read, with no ``.item()``. The host reads state back
only in `SharedCountsScheduler._sync`, every ``poll_every`` windows,
and ``host_syncs`` counts those reads.

Packed words are int32 tensors carrying the uint32 bits; counters are
int64. Still to be ported: closeness queries, pruning, anytime answers
and stop policies, telemetry, fault quarantine, cache snapshots and the
mesh paths.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import deviations as dev
from repro_torch.core import histsim
from repro_torch.core.bitmap import pack_active_mask, words_for
from repro_torch.core.histsim import HistSimState
from repro_torch.core.policies import mark_window
from repro_torch.io import InMemorySource, WindowData, as_block_source
from repro_torch.kernels import metrics, ops

__all__ = [
    "MultiQuerySpec",
    "MultiQueryState",
    "QueryOutcome",
    "SampleCursor",
    "SharedCountsScheduler",
    "apply_stats",
    "fused_round",
    "ingest_round",
    "init_cursor",
    "init_multi_state",
    "admit_slot",
    "clear_slot",
    "ingest",
    "stats_step",
    "slot_state",
]


@dataclasses.dataclass(frozen=True)
class MultiQuerySpec:
    """Static shape/criterion/metric configuration shared by all slots."""

    v_z: int
    v_x: int
    max_queries: int = 8
    criterion: str = "histsim"  # "histsim" | "slowmatch", applies to all slots
    # Static upper bound on any slot's k: the deviation assignment reads
    # the k_cap + 1 smallest order statistics. None = V_Z.
    k_cap: Optional[int] = None
    metric: str = "l1"  # registry distance of the shared tau pass
    bounds_mode: str = "native"  # "native" | "conservative" failure bounds

    def __post_init__(self):
        if self.max_queries < 1:
            raise ValueError(f"need max_queries >= 1, got {self.max_queries}")
        if self.criterion not in ("histsim", "slowmatch"):
            raise ValueError(self.criterion)
        if self.k_cap is not None and not (0 < self.k_cap <= self.v_z):
            raise ValueError(f"need 0 < k_cap <= V_Z, got k_cap={self.k_cap}")
        if self.bounds_mode not in ("native", "conservative"):
            raise ValueError(
                f"bounds_mode must be 'native' or 'conservative', got {self.bounds_mode!r}"
            )
        metrics.coerce_metric(self.metric)


class MultiQueryState(NamedTuple):
    """One shared counts matrix + per-slot query statistics (Q = max_queries)."""

    counts: torch.Tensor  # (V_Z, V_X) f32 — SHARED empirical counts r_i
    n: torch.Tensor  # (V_Z,) f32 — SHARED samples per candidate n_i
    q_hat: torch.Tensor  # (Q, V_X) f32 normalized targets
    k: torch.Tensor  # (Q,) int64 per-query k
    eps: torch.Tensor  # (Q,) f32 per-query eps
    delta: torch.Tensor  # (Q,) f32 per-query delta
    tau: torch.Tensor  # (Q, V_Z) f32 per-query distance estimates
    eps_i: torch.Tensor  # (Q, V_Z) f32 assigned deviations
    log_delta_i: torch.Tensor  # (Q, V_Z) f32
    delta_upper: torch.Tensor  # (Q,) f32 — 0 for empty slots
    active: torch.Tensor  # (Q, V_Z) bool — per-query AnyActive candidates
    active_words: torch.Tensor  # (Q, W) int32 packed per-query active masks
    union_words: torch.Tensor  # (W,) int32 — OR over slots; drives block marking
    in_top_k: torch.Tensor  # (Q, V_Z) bool — per-query matching set M
    occupied: torch.Tensor  # (Q,) bool — slot holds a live query
    round_idx: torch.Tensor  # () int64 — statistics iterations so far


class SampleCursor(NamedTuple):
    """Device-resident sampling state: the without-replacement read_mask
    plus the monotone read counters, updated inside the fused round."""

    read_mask: torch.Tensor  # (num_blocks,) bool
    blocks_read: torch.Tensor  # () int64
    blocks_considered: torch.Tensor  # () int64
    tuples_read: torch.Tensor  # () int64
    rounds: torch.Tensor  # () int64 — windows dispatched


def init_cursor(num_blocks: int, *, device) -> SampleCursor:
    counters = (torch.zeros((), dtype=torch.int64, device=device) for _ in range(4))
    return SampleCursor(torch.zeros((num_blocks,), dtype=torch.bool, device=device), *counters)


def init_multi_state(spec: MultiQuerySpec, *, device) -> MultiQueryState:
    """All slots empty, counts at zero."""
    q, v_z, v_x = spec.max_queries, spec.v_z, spec.v_x
    w = words_for(v_z)
    f32 = dict(dtype=torch.float32, device=device)
    flag = dict(dtype=torch.bool, device=device)
    return MultiQueryState(
        counts=torch.zeros((v_z, v_x), **f32),
        n=torch.zeros((v_z,), **f32),
        q_hat=torch.full((q, v_x), 1.0 / v_x, **f32),
        k=torch.ones((q,), dtype=torch.int64, device=device),
        eps=torch.ones((q,), **f32),
        delta=torch.ones((q,), **f32),
        tau=torch.ones((q, v_z), **f32),
        eps_i=torch.zeros((q, v_z), **f32),
        log_delta_i=torch.zeros((q, v_z), **f32),
        delta_upper=torch.zeros((q,), **f32),
        active=torch.zeros((q, v_z), **flag),
        active_words=torch.zeros((q, w), dtype=torch.int32, device=device),
        union_words=torch.zeros((w,), dtype=torch.int32, device=device),
        in_top_k=torch.zeros((q, v_z), **flag),
        occupied=torch.zeros((q,), **flag),
        round_idx=torch.zeros((), dtype=torch.int64, device=device),
    )


def _set(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of ``t`` with row ``slot`` set to ``value`` (functional)."""
    out = t.clone()
    out[slot] = value
    return out


def admit_slot(
    state: MultiQueryState, slot: int, q_hat, k: int, eps: float, delta: float
) -> MultiQueryState:
    """Install a top-k query into ``slot``. Run `stats_step` before the
    next marking so its active set reflects the accumulated counts."""
    q_hat = torch.as_tensor(q_hat, dtype=torch.float32).to(state.q_hat.device)
    return state._replace(
        q_hat=_set(state.q_hat, slot, q_hat),
        k=_set(state.k, slot, int(k)),
        eps=_set(state.eps, slot, float(eps)),
        delta=_set(state.delta, slot, float(delta)),
        occupied=_set(state.occupied, slot, True),
    )


def _or_reduce(words: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 -> (W,) bitwise OR over the query axis."""
    return functools.reduce(torch.bitwise_or, words.unbind(0))


def clear_slot(state: MultiQueryState, slot: int) -> MultiQueryState:
    """Free a slot (query retired) and drop it from the active union;
    tau goes back to its init value 1.0."""
    active_words = _set(state.active_words, slot, 0)
    return state._replace(
        occupied=_set(state.occupied, slot, False),
        active=_set(state.active, slot, False),
        active_words=active_words,
        tau=_set(state.tau, slot, 1.0),
        delta_upper=_set(state.delta_upper, slot, 0.0),
        union_words=_or_reduce(active_words),
    )


def ingest(state: MultiQueryState, z_idx, x_idx, *, spec: MultiQuerySpec) -> MultiQueryState:
    """Add a padded sample batch into the SHARED counts — one kernel-B
    launch serves every slot and advances ``n_i`` by the row sums."""
    counts, n = ops.ingest_counts(state.counts, state.n, z_idx, x_idx, v_z=spec.v_z, v_x=spec.v_x)
    return state._replace(counts=counts, n=n)


def apply_stats(state: MultiQueryState, tau, n, *, spec: MultiQuerySpec) -> MultiQueryState:
    """Per-slot deviation assignment from (Q, V_Z) distances and the
    shared (V_Z,) sample counts, then the active union."""
    d = dev.assign_deviations_dynamic(
        tau, n, k=state.k, eps=state.eps, delta=state.delta, v_x=spec.v_x,
        criterion=spec.criterion, k_cap=spec.k_cap, metric=spec.metric,
        bounds_mode=spec.bounds_mode,
    )
    occupied = state.occupied[:, None]
    active = d.active & occupied
    words = pack_active_mask(active)
    return state._replace(
        tau=tau,
        eps_i=d.eps_i,
        log_delta_i=d.log_delta_i,
        delta_upper=torch.where(state.occupied, d.delta_upper, 0.0),
        active=active,
        active_words=words,
        union_words=_or_reduce(words),
        in_top_k=d.in_top_k & occupied,
        round_idx=state.round_idx + 1,
    )


def stats_step(state: MultiQueryState, *, spec: MultiQuerySpec) -> MultiQueryState:
    """One statistics iteration for every slot: tau for all slots from
    ONE kernel-C launch over the shared counts (unoccupied slots pinned
    at 1.0), then `apply_stats`."""
    tau = ops.distance_multi(state.counts, state.q_hat, metric=spec.metric)
    tau = torch.where(state.occupied[:, None], tau, 1.0)
    return apply_stats(state, tau, state.n, spec=spec)


def _advance_cursor(cursor: SampleCursor, wd: WindowData, marks: torch.Tensor) -> SampleCursor:
    """Read bookkeeping shared by the sampling and exact-completion rounds."""
    # duplicate-safe scatter-add (padding repeats a real id with a zero
    # contribution), then re-binarize
    read_mask = (
        cursor.read_mask.to(torch.int32).index_put_(
            (wd.indices,), marks.to(torch.int32), accumulate=True
        )
        > 0
    )
    per_block = torch.sum(wd.z >= 0, dim=1)
    return SampleCursor(
        read_mask=read_mask,
        blocks_read=cursor.blocks_read + torch.sum(marks),
        blocks_considered=cursor.blocks_considered + torch.sum(wd.valid),
        tuples_read=cursor.tuples_read + torch.sum(torch.where(marks, per_block, 0)),
        rounds=cursor.rounds + 1,
    )


def _masked_ids(wd: WindowData, marks: torch.Tensor) -> tuple:
    """(z, x) of the marked blocks, flattened; unmarked rows become -1."""
    zw = torch.where(marks[:, None], wd.z, -1).reshape(-1)
    xw = torch.where(marks[:, None], wd.x, -1).reshape(-1)
    return zw, xw


def fused_round(
    state: MultiQueryState,
    cursor: SampleCursor,
    wd: WindowData,
    *,
    spec: MultiQuerySpec,
    policy: str,
) -> tuple:
    """One sampling round: mark + gather-mask + ingest + stats + read
    bookkeeping, all on the device, no host sync.

    Marking uses the union active words (stale by up to ``poll_every``
    windows) and is masked by the window's validity and the read_mask,
    so no block is counted twice. Ingest and stats always run; the new
    state is kept only if something was marked, matching the reference's
    ``lax.cond`` (stats run only after windows that read something).
    """
    marks = mark_window(wd, state.union_words, cursor.read_mask, policy=policy)
    zw, xw = _masked_ids(wd, marks)
    new = stats_step(ingest(state, zw, xw, spec=spec), spec=spec)
    took = torch.any(marks)
    state = MultiQueryState(*(torch.where(took, a, b) for a, b in zip(new, state)))
    return state, _advance_cursor(cursor, wd, marks)


def ingest_round(
    state: MultiQueryState, cursor: SampleCursor, wd: WindowData, *, spec: MultiQuerySpec
) -> tuple:
    """Exact-completion round: ingest every unread block of the window,
    no marking, no stats (the caller runs one `stats_step` at the end)."""
    marks = ops.mark_blocks(wd.indices, wd.valid, cursor.read_mask)
    zw, xw = _masked_ids(wd, marks)
    state = ingest(state, zw, xw, spec=spec)
    return state, _advance_cursor(cursor, wd, marks)


def slot_state(state: MultiQueryState, slot: int) -> HistSimState:
    """Single-query `HistSimState` view of one slot (counts/n are shared)."""
    return HistSimState(
        counts=state.counts,
        n=state.n,
        q_hat=state.q_hat[slot],
        tau=state.tau[slot],
        eps_i=state.eps_i[slot],
        log_delta_i=state.log_delta_i[slot],
        delta_upper=state.delta_upper[slot],
        active=state.active[slot],
        active_words=state.active_words[slot],
        in_top_k=state.in_top_k[slot],
        round_idx=state.round_idx,
    )


# ---------------------------------------------------------------------------
# The shared window-marking / ingest loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ticket:
    """Host-side bookkeeping for one live query slot."""

    qid: int
    slot: int
    k: int
    eps: float
    delta: float
    admit_time: float
    admit_rounds: int
    admit_passes: int
    admit_blocks_read: int
    admit_blocks_considered: int
    admit_tuples_read: int


@dataclasses.dataclass
class QueryOutcome:
    """Per-query result produced at retirement."""

    qid: int
    ids: np.ndarray  # (k,) matching ids, closest first
    state: HistSimState  # single-query view snapshot at retirement
    delta_upper: float
    exact: bool  # the answer rests on a complete read of the data
    terminated: bool  # the statistical rule delta_upper < delta fired
    rounds: int  # windows processed while this query was live
    passes: int
    blocks_read: int
    blocks_considered: int
    tuples_read: int  # tuples ingested while this query was live
    wall_time_s: float


class SharedCountsScheduler:
    """The FastMatch execution loop over a shared counts matrix.

    Owns the cyclic visit order, the device-resident `SampleCursor`, the
    pass structure and the `MultiQueryState`. Queries enter via `admit`,
    leave via `retire` (collected in `outcomes`), and `pump` drives one
    `fused_round` per window until every live query resolves, polling
    the device every ``poll_every`` windows. A pass visits every unread
    block in cyclic order; blocks AnyActive skipped stay eligible for
    later passes. If a pass reads nothing while queries remain live,
    the scheduler completes exactly (reads the remainder) and retires
    them with ``exact=True``; a ``max_rounds`` budget instead stops with
    the queries left best-effort.
    """

    def __init__(
        self,
        dataset,
        spec: MultiQuerySpec,
        *,
        policy: str = "anyactive",
        window: int = 512,
        seed: int = 0,
        start_block: Optional[int] = None,
        poll_every: int = 1,
        device=None,
    ):
        source: InMemorySource = as_block_source(dataset, device=device)
        if spec.v_z != source.v_z or spec.v_x != source.v_x:
            raise ValueError("spec/dataset dimension mismatch")
        if policy not in ("anyactive", "scan"):
            raise ValueError(f"unknown policy {policy!r}")
        if poll_every < 1:
            raise ValueError(f"need poll_every >= 1, got {poll_every}")
        self.source = source
        self.device = source.device
        self.spec = spec
        self.policy = policy
        self.poll_every = poll_every
        nb = source.num_blocks
        self.window = max(1, min(window, nb))

        rng = np.random.default_rng(seed)
        start = start_block if start_block is not None else int(rng.integers(nb))
        self.order = np.roll(np.arange(nb), -start)  # cyclic visit order

        self.state = init_multi_state(spec, device=self.device)
        self.cursor = init_cursor(nb, device=self.device)
        self.tickets: Dict[int, _Ticket] = {}  # slot -> ticket
        self.outcomes: Dict[int, QueryOutcome] = {}  # qid -> outcome
        self._next_qid = 0

        # host mirrors of the device cursor + per-slot bounds, refreshed
        # by `_sync()` (per-query numbers are deltas vs admit)
        self.read_mask = np.zeros(nb, dtype=bool)
        self.rounds = 0
        self.passes = 0  # host-side pass structure, not device state
        self.blocks_read = 0
        self.blocks_considered = 0
        self.tuples_read = 0
        self._delta_upper = np.zeros(spec.max_queries, np.float32)
        self.host_syncs = 0  # number of device->host polls performed

    # -- host/device synchronisation --------------------------------------

    def _sync(self) -> None:
        """One device->host poll: cursor + per-slot bounds. Everything
        the host loop decides on is refreshed here and only here."""
        c = self.cursor
        counters = torch.stack(
            (c.rounds, c.blocks_read, c.blocks_considered, c.tuples_read)
        ).tolist()
        self.rounds, self.blocks_read, self.blocks_considered, self.tuples_read = counters
        self.read_mask = c.read_mask.cpu().numpy()
        self._delta_upper = self.state.delta_upper.cpu().numpy()
        self.host_syncs += 1

    # -- admission / retirement -------------------------------------------

    @property
    def free_slots(self) -> list:
        return [s for s in range(self.spec.max_queries) if s not in self.tickets]

    def admit(self, target: np.ndarray, *, k: int, eps: float, delta: float) -> int:
        """Place a top-k query into a free slot; returns its qid. The
        immediate `stats_step` lets it see the accumulated shared counts
        before the next window is marked."""
        free = self.free_slots
        if not free:
            raise RuntimeError("no free query slot; retire a query first")
        if not (0 < k <= self.spec.v_z):
            raise ValueError(f"need 0 < k <= V_Z, got k={k}")
        if self.spec.k_cap is not None and k > self.spec.k_cap:
            raise ValueError(f"k={k} exceeds spec.k_cap={self.spec.k_cap}")
        slot = free[0]
        target = np.asarray(target, np.float64).ravel()
        if target.shape != (self.spec.v_x,):
            raise ValueError(f"target must have shape ({self.spec.v_x},)")
        q_hat = (target / max(target.sum(), 1e-30)).astype(np.float32)
        self.state = admit_slot(self.state, slot, torch.from_numpy(q_hat), k, eps, delta)
        self.state = stats_step(self.state, spec=self.spec)
        self._sync()  # fresh counters for the ticket + fresh delta_upper
        qid = self._next_qid
        self._next_qid += 1
        self.tickets[slot] = _Ticket(
            qid=qid,
            slot=slot,
            k=int(k),
            eps=float(eps),
            delta=float(delta),
            admit_time=time.perf_counter(),
            admit_rounds=self.rounds,
            admit_passes=self.passes,
            admit_blocks_read=self.blocks_read,
            admit_blocks_considered=self.blocks_considered,
            admit_tuples_read=self.tuples_read,
        )
        return qid

    def retire(self, slot: int, *, exact: bool, terminated: bool) -> QueryOutcome:
        """Snapshot a slot's answer, free the slot, record the outcome.
        ``exact`` is forced True when every block has been read. Call at
        a poll boundary (mirrors fresh)."""
        t = self.tickets.pop(slot)
        exact = exact or bool(self.read_mask.all())
        view = slot_state(self.state, slot)
        ids = histsim.top_k_ids(view, t.k).cpu().numpy()
        # a query admitted and retired inside one running pass still saw
        # sampling activity — count that partial pass
        passes = self.passes - t.admit_passes
        if passes == 0 and self.rounds > t.admit_rounds:
            passes = 1
        outcome = QueryOutcome(
            qid=t.qid,
            ids=ids,
            state=view,
            delta_upper=float(view.delta_upper),
            exact=exact,
            terminated=terminated,
            rounds=self.rounds - t.admit_rounds,
            passes=passes,
            blocks_read=self.blocks_read - t.admit_blocks_read,
            blocks_considered=self.blocks_considered - t.admit_blocks_considered,
            tuples_read=self.tuples_read - t.admit_tuples_read,
            wall_time_s=time.perf_counter() - t.admit_time,
        )
        self.state = clear_slot(self.state, slot)
        self.outcomes[t.qid] = outcome
        return outcome

    def _poll_terminated(self) -> None:
        """Retire every live query whose bound fired at the last poll."""
        du = self._delta_upper
        for slot in list(self.tickets):
            if du[slot] < self.tickets[slot].delta:
                self.retire(slot, exact=False, terminated=True)

    # -- the loop ----------------------------------------------------------

    def _open_pass_stream(self, pass_order: np.ndarray) -> tuple:
        """(window stream, number of windows) for one pass."""
        windows = [
            pass_order[p : p + self.window] for p in range(0, pass_order.size, self.window)
        ]
        return self.source.stream(windows, pad_to=self.window), len(windows)

    def run_window(self, win: np.ndarray) -> int:
        """Mark one window against the union active set, ingest the marked
        blocks, and poll. Returns the number of blocks read."""
        win = np.asarray(win)
        if win.size == 0:
            return 0
        before = self.blocks_read
        wd = self.source.fetch(win, pad_to=max(self.window, win.size))
        self.state, self.cursor = fused_round(
            self.state, self.cursor, wd, spec=self.spec, policy=self.policy
        )
        self._sync()
        return self.blocks_read - before

    def complete_remaining(self) -> None:
        """Exact completion: read every unread block into the shared
        counts (one pass, one round per window), then one `stats_step`.
        The Scan baseline is this path on a fresh scheduler."""
        self._sync()
        remaining = np.flatnonzero(~self.read_mask)
        if remaining.size == 0:
            return
        self.passes += 1
        stream, _ = self._open_pass_stream(remaining)
        try:
            for wd in stream:
                self.state, self.cursor = ingest_round(
                    self.state, self.cursor, wd, spec=self.spec
                )
        finally:
            stream.close()
        self.state = stats_step(self.state, spec=self.spec)
        self._sync()

    def pump(self, *, max_rounds: int = 1_000_000, max_passes: int = 4) -> None:
        """Drive windows until every live query resolves, polling every
        ``poll_every`` windows; retirement and the budget check happen at
        polls. The budgets count this call only."""
        self._sync()
        rounds0, passes0 = self.rounds, self.passes
        self._poll_terminated()
        while self.tickets and self.passes - passes0 < max_passes:
            pass_order = self.order[~self.read_mask[self.order]]
            if pass_order.size == 0:
                break
            self.passes += 1
            pass_start_rounds = self.rounds
            pass_start_blocks = self.blocks_read
            stream, n_rounds = self._open_pass_stream(pass_order)
            try:
                for dispatched, wd in enumerate(stream, start=1):
                    self.state, self.cursor = fused_round(
                        self.state, self.cursor, wd, spec=self.spec, policy=self.policy
                    )
                    if dispatched % self.poll_every == 0 or dispatched == n_rounds:
                        self._sync()
                        self._poll_terminated()
                        if self.rounds - rounds0 >= max_rounds:
                            return  # budget cut: live queries stay best-effort
                        if not self.tickets:
                            break
            finally:
                stream.close()
            if self.blocks_read - pass_start_blocks == 0 and self.tickets:
                # a query admitted in the pass's final windows deserves
                # one fresh pass of its own before sampling gives up
                fresh = any(t.admit_rounds >= pass_start_rounds for t in self.tickets.values())
                if not fresh:
                    break
        if self.tickets:
            # exact fallback for the stragglers
            self.complete_remaining()
            du = self._delta_upper
            for slot in list(self.tickets):
                fired = bool(du[slot] < self.tickets[slot].delta)
                self.retire(slot, exact=True, terminated=fired)
