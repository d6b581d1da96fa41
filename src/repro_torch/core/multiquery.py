"""Shared-counts multi-query HistSim — the FastMatch serving core.

Port of `repro.core.multiquery`. The counts matrix ``r_i`` is
target-independent, so query slots share one counts matrix and one I/O
stream; each slot keeps its own target, query type (top-k or tolerant
closeness) with its (k, eps, delta, gap), tau, deviations, bounds and
active set. The union of the slots' packed active words drives
AnyActive marking.

One `fused_round` per lookahead window does, on the device and without
a host sync: mark (kernel A, one launch for the final marks) + masked
gather + ingest (kernel B) + tau (kernel C) + the deviation assignment
+ the read bookkeeping of the `SampleCursor`. The reference skips ingest and stats with ``lax.cond``
when nothing was marked; here both always run and `torch.where` keeps
the old state unless something was read, so ``round_idx`` advances only
on rounds that read, with no ``.item()``. The host reads state back
only in `SharedCountsScheduler._sync`, every ``poll_every`` windows,
and ``host_syncs`` counts those reads.

`apply_stats` evaluates each slot's retirement rule by its ``qtype``
and selects per slot with `torch.where` (value-exact). The reference's
compiler drops the closeness branch when no slot uses it; here the
caller says so (``closeness=False``), and the scheduler keeps that flag
on the host from admissions and retirements, so an all-top-k workload
launches no closeness work. Pruning runs only under ``spec.prune``.

At every poll the host mirrors tau, n, the matching sets and the
pruned masks beside the cursor and the bounds, so `peek` assembles
anytime answers without device work, and a `StopPolicy` retires a
query with exactly that answer. `export_cache`/`import_cache` carry the
target-independent state (counts, n, read mask, counters, visit order)
between schedulers in memory.

The scheduler resolves its kernel plans (`autotune.PlanPair`: kernel
C's and kernel B's launch choices) once, at construction, from the
plan file of its device's backend, and threads them through every round.

Quarantine (the I/O fault layer's verdicts): at every poll the
scheduler drains the block ids a `ResilientSource` in its source chain
quarantined, drops them from every later pass order, and retires each
query over the surviving blocks, with ``degraded`` and the widened
``eps_effective = eps + 2q`` (q the share of tuples lost) on its
outcome. A window handed over in host memory (a host-resident or fault
injecting source) is moved to the scheduler's device once, where the
scheduler receives it.

Telemetry (``telemetry=``, a `repro_torch.obs.Telemetry`) records at
the polls only: ``_sync`` already copies tau, n and the bounds back for
`peek`, so a poll stages references to those copies and the counter
deltas, and `flush_telemetry` shapes them into curve points and registry
counters in batches, at the end of `pump` or when a reader asks. Between
polls a window costs two ``perf_counter`` pairs (the ``round_batch``
split of gather, dispatch and sync). A run with telemetry on is bitwise
the run with it off, with the same polls (``host_syncs``, and
``loop_syncs``, the polls of the window loop itself) and launches.

Packed words are int32 tensors carrying the uint32 bits; counters and
``qtype`` are int64. Still to be ported: the mesh paths with their
per-worker quarantine drain and timings (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import config_hash as _config_hash
from repro_torch.core import deviations as dev
from repro_torch.core import histsim
from repro_torch.core.bitmap import pack_active_mask, words_for
from repro_torch.core.histsim import HistSimState
from repro_torch.core.policies import mark_window
from repro_torch.data.layout import BlockedDataset
from repro_torch.io.block_source import WindowData, as_block_source
from repro_torch.io.faults import WindowQuarantined, find_resilient
from repro_torch.kernels import autotune, metrics, ops

__all__ = [
    "AnytimeAnswer",
    "CacheSnapshot",
    "MultiQuerySpec",
    "MultiQueryState",
    "QTYPE_TOPK",
    "QTYPE_CLOSENESS",
    "QueryOutcome",
    "SampleCursor",
    "SharedCountsScheduler",
    "StopPolicy",
    "apply_stats",
    "cache_config_hash",
    "fused_round",
    "ingest_round",
    "init_cursor",
    "init_multi_state",
    "admit_slot",
    "clear_slot",
    "ingest",
    "stats_step",
    "run_round",
    "slot_state",
]


# Per-slot query types (MultiQueryState.qtype values).
QTYPE_TOPK = 0
QTYPE_CLOSENESS = 1


@dataclasses.dataclass(frozen=True)
class StopPolicy:
    """SLA-driven early stop for one query (or every query of a scheduler
    through ``MultiQuerySpec.default_stop``). A stopped query retires
    with its anytime answer at that poll — ``exact=False``,
    ``terminated=False``, the achieved ``delta_upper`` — the answer
    `SharedCountsScheduler.peek` gives at that poll. The statistical
    rule (delta_upper < delta) is checked first. Fields left None never
    fire.

      wall_ms    — stop once the query has been live this many ms
                   (checked at polls)
      confidence — stop once 1 - delta_upper reaches this level
      tuples     — stop once this many tuples were read while live
    """

    wall_ms: Optional[float] = None
    confidence: Optional[float] = None
    tuples: Optional[int] = None

    def __post_init__(self):
        if self.wall_ms is None and self.confidence is None and self.tuples is None:
            raise ValueError("StopPolicy needs at least one of wall_ms/confidence/tuples")
        if self.wall_ms is not None and not self.wall_ms >= 0.0:
            raise ValueError(f"need wall_ms >= 0, got {self.wall_ms}")
        if self.confidence is not None and not (0.0 < self.confidence <= 1.0):
            raise ValueError(f"need 0 < confidence <= 1, got {self.confidence}")
        if self.tuples is not None and not self.tuples >= 0:
            raise ValueError(f"need tuples >= 0, got {self.tuples}")

    def fired(self, *, wall_s: float, confidence: float, tuples: int) -> str:
        """The reason this policy fires on the given gauges, or "". When
        several fire at one poll, the strongest answer's reason wins:
        confidence, then tuples, then wall_ms."""
        if self.confidence is not None and confidence >= self.confidence:
            return "confidence"
        if self.tuples is not None and tuples >= self.tuples:
            return "tuples"
        if self.wall_ms is not None and wall_s * 1000.0 >= self.wall_ms:
            return "wall_ms"
        return ""


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
    # Early-reject pruning: certified-far candidates leave the I/O
    # marking (the failure bounds keep summing over every candidate).
    prune: bool = False
    # Scheduler-wide StopPolicy for queries admitted without their own;
    # a host-loop decision, so it takes no part in equality.
    default_stop: Optional[StopPolicy] = dataclasses.field(default=None, compare=False)

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
        if self.default_stop is not None and not isinstance(self.default_stop, StopPolicy):
            raise TypeError(f"default_stop must be a StopPolicy, got {self.default_stop!r}")
        metrics.coerce_metric(self.metric)


class MultiQueryState(NamedTuple):
    """One shared counts matrix + per-slot query statistics (Q = max_queries)."""

    counts: torch.Tensor  # (V_Z, V_X) f32 — SHARED empirical counts r_i
    n: torch.Tensor  # (V_Z,) f32 — SHARED samples per candidate n_i
    q_hat: torch.Tensor  # (Q, V_X) f32 normalized targets
    k: torch.Tensor  # (Q,) int64 per-query k
    eps: torch.Tensor  # (Q,) f32 per-query eps
    delta: torch.Tensor  # (Q,) f32 per-query delta
    gap: torch.Tensor  # (Q,) f32 closeness promise gap (0 for top-k slots)
    qtype: torch.Tensor  # (Q,) int64 QTYPE_TOPK | QTYPE_CLOSENESS
    tau: torch.Tensor  # (Q, V_Z) f32 per-query distance estimates
    eps_i: torch.Tensor  # (Q, V_Z) f32 assigned deviations
    log_delta_i: torch.Tensor  # (Q, V_Z) f32
    delta_upper: torch.Tensor  # (Q,) f32 — 0 for empty slots
    active: torch.Tensor  # (Q, V_Z) bool — per-query AnyActive candidates
    active_words: torch.Tensor  # (Q, W) int32 packed per-query active masks
    union_words: torch.Tensor  # (W,) int32 — OR over slots; drives block marking
    in_top_k: torch.Tensor  # (Q, V_Z) bool — matching set M (close labels for closeness)
    pruned: torch.Tensor  # (Q, V_Z) bool — sticky early-reject mask (spec.prune)
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


class CacheSnapshot(NamedTuple):
    """The target-independent serving state a fresh scheduler needs to
    answer new queries from the accumulated sample: the shared counts
    and row sums, the read mask and its counters, and the pass count
    and visit-order offset. Live query slots are not part of it."""

    counts: torch.Tensor  # (V_Z, V_X) f32
    n: torch.Tensor  # (V_Z,) f32
    read_mask: torch.Tensor  # (num_blocks,) bool
    blocks_read: torch.Tensor  # () int64
    blocks_considered: torch.Tensor  # () int64
    tuples_read: torch.Tensor  # () int64
    rounds: torch.Tensor  # () int64
    passes: torch.Tensor  # () int64 — host-side pass counter
    start: torch.Tensor  # () int64 — cyclic visit-order offset


def cache_config_hash(source, spec: MultiQuerySpec) -> str:
    """Fingerprint binding a `CacheSnapshot` to (dataset layout, spec):
    the layout's dimensions, the per-block tuple counts, the content of
    up to 64 probe blocks spread evenly over the layout, and the spec.
    It hashes the reference's bytes (int32 z and x, the bitmap's uint32
    bits), so both packages give the same hash for the same data. The
    probe is one fetch through ``source``'s wrappers, as the reference's
    (a fault injector counts it as an attempt)."""
    # a dataset is read in place on the host; a source where it lies
    src = as_block_source(source, device="cpu" if isinstance(source, BlockedDataset) else None)
    nb = src.num_blocks
    probe = np.unique(np.linspace(0, nb - 1, min(nb, 64)).astype(np.int64))
    wd = src.fetch(probe, pad_to=len(probe))
    fp = hashlib.sha256()
    fp.update(np.ascontiguousarray(np.asarray(src.tuples_per_block, np.int64)).tobytes())
    for leaf in (wd.z, wd.x, wd.bitmap_rows()):
        fp.update(np.ascontiguousarray(leaf.cpu().numpy()).tobytes())
    payload = (
        "fastmatch-cache-v1",
        (spec.v_z, spec.v_x, spec.max_queries, spec.criterion, spec.k_cap),
        (nb, src.block_size),
        fp.hexdigest(),
    )
    return _config_hash(payload)


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
        gap=torch.zeros((q,), **f32),
        qtype=torch.zeros((q,), dtype=torch.int64, device=device),
        tau=torch.ones((q, v_z), **f32),
        eps_i=torch.zeros((q, v_z), **f32),
        log_delta_i=torch.zeros((q, v_z), **f32),
        delta_upper=torch.zeros((q,), **f32),
        active=torch.zeros((q, v_z), **flag),
        active_words=torch.zeros((q, w), dtype=torch.int32, device=device),
        union_words=torch.zeros((w,), dtype=torch.int32, device=device),
        in_top_k=torch.zeros((q, v_z), **flag),
        pruned=torch.zeros((q, v_z), **flag),
        occupied=torch.zeros((q,), **flag),
        round_idx=torch.zeros((), dtype=torch.int64, device=device),
    )


def _set(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of ``t`` with row ``slot`` set to ``value`` (functional)."""
    out = t.clone()
    out[slot] = value
    return out


def admit_slot(
    state: MultiQueryState,
    slot: int,
    q_hat,
    k: int,
    eps: float,
    delta: float,
    *,
    qtype: int = QTYPE_TOPK,
    gap: float = 0.0,
) -> MultiQueryState:
    """Install a query into ``slot``: top-k by default, or with
    ``qtype=QTYPE_CLOSENESS`` and a positive ``gap`` a closeness test
    (eps the close radius, eps + gap the far one; k unused). Run
    `stats_step` before the next marking so its active set reflects the
    accumulated counts."""
    q_hat = torch.as_tensor(q_hat, dtype=torch.float32).to(state.q_hat.device)
    return state._replace(
        q_hat=_set(state.q_hat, slot, q_hat),
        k=_set(state.k, slot, int(k)),
        eps=_set(state.eps, slot, float(eps)),
        delta=_set(state.delta, slot, float(delta)),
        gap=_set(state.gap, slot, float(gap)),
        qtype=_set(state.qtype, slot, int(qtype)),
        pruned=_set(state.pruned, slot, False),
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
        gap=_set(state.gap, slot, 0.0),
        qtype=_set(state.qtype, slot, QTYPE_TOPK),
        pruned=_set(state.pruned, slot, False),
        union_words=_or_reduce(active_words),
    )


def ingest(
    state: MultiQueryState, z_idx, x_idx, *, spec: MultiQuerySpec, plan=None
) -> MultiQueryState:
    """Add a padded sample batch into the SHARED counts — one kernel-B
    launch serves every slot and advances ``n_i`` by the row sums (or
    the two-step form, when the ingest ``plan`` measured it faster; None
    consults the plan registry)."""
    counts, n = ops.ingest_counts(
        state.counts, state.n, z_idx, x_idx, v_z=spec.v_z, v_x=spec.v_x,
        plan=plan if plan is not None else "auto",
    )
    return state._replace(counts=counts, n=n)


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` of a (Q,) condition against (Q, ...) leaves."""
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def apply_stats(
    state: MultiQueryState, tau, n, *, spec: MultiQuerySpec, closeness: bool = True
) -> MultiQueryState:
    """Per-slot deviation assignment from (Q, V_Z) distances and the
    shared (V_Z,) sample counts, then the active union.

    Both retirement rules are evaluated and selected per slot by its
    ``qtype``. ``closeness=False`` skips the closeness rule, which is
    value-exact only when no slot holds a closeness query (the
    scheduler's host flag). With ``spec.prune`` the sticky ``pruned``
    mask grows by `dev.prune_far` (far edge eps + gap for closeness,
    split + eps/2 for top-k) and leaves the active set.
    """
    d = dev.assign_deviations_dynamic(
        tau, n, k=state.k, eps=state.eps, delta=state.delta, v_x=spec.v_x,
        criterion=spec.criterion, k_cap=spec.k_cap, metric=spec.metric,
        bounds_mode=spec.bounds_mode,
    )
    top_split = d.split
    if closeness or spec.prune:
        is_close = state.qtype == QTYPE_CLOSENESS
    if closeness:
        c = dev.assign_closeness(
            tau, n, eps=state.eps, gap=state.gap, delta=state.delta, v_x=spec.v_x,
            metric=spec.metric, bounds_mode=spec.bounds_mode,
        )
        d = dev.DeviationState(*(_select(is_close, a, b) for a, b in zip(c, d)))
    occupied = state.occupied[:, None]
    pruned = state.pruned
    if spec.prune:
        far_edge = torch.where(is_close, state.eps + state.gap, top_split + 0.5 * state.eps)
        far = dev.prune_far(
            tau, n, far_edge=far_edge, delta=state.delta, v_x=spec.v_x, metric=spec.metric
        )
        pruned = pruned | (far & occupied)
        active = d.active & occupied & ~pruned
    else:
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
        pruned=pruned,
        round_idx=state.round_idx + 1,
    )


def stats_step(
    state: MultiQueryState, *, spec: MultiQuerySpec, closeness: bool = True, plan=None
) -> MultiQueryState:
    """One statistics iteration for every slot: tau for all slots from
    ONE kernel-C launch over the shared counts (unoccupied slots pinned
    at 1.0), then `apply_stats`. ``plan`` pins the tau plan
    (`autotune.TauPlan`); None consults the plan registry."""
    tau = ops.distance_multi(
        state.counts, state.q_hat, metric=spec.metric,
        plan=plan if plan is not None else "auto",
    )
    tau = torch.where(state.occupied[:, None], tau, 1.0)
    return apply_stats(state, tau, state.n, spec=spec, closeness=closeness)


def run_round(
    state: MultiQueryState,
    z_idx,
    x_idx,
    *,
    spec: MultiQuerySpec,
    plans: Optional[autotune.PlanPair] = None,
) -> MultiQueryState:
    """Shared ingest + per-slot stats: one full multi-query round, in the
    kernel ``plans`` given (None consults the plan registry)."""
    return stats_step(
        ingest(state, z_idx, x_idx, spec=spec, plan=plans.ingest if plans else None),
        spec=spec,
        plan=plans.tau if plans else None,
    )


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
    closeness: bool = True,
    plans: Optional[autotune.PlanPair] = None,
) -> tuple:
    """One sampling round: mark + gather-mask + ingest + stats + read
    bookkeeping, all on the device, no host sync, in the kernel
    ``plans`` given (None consults the plan registry).

    Marking uses the union active words (stale by up to ``poll_every``
    windows) and is masked by the window's validity and the read_mask,
    so no block is counted twice. Ingest and stats always run; the new
    state is kept only if something was marked, matching the reference's
    ``lax.cond`` (stats run only after windows that read something).
    Leaves the round passes through unchanged (targets, per-slot
    parameters) need no select.
    """
    marks = mark_window(wd, state.union_words, cursor.read_mask, policy=policy)
    zw, xw = _masked_ids(wd, marks)
    new = stats_step(
        ingest(state, zw, xw, spec=spec, plan=plans.ingest if plans else None),
        spec=spec, closeness=closeness, plan=plans.tau if plans else None,
    )
    took = torch.any(marks)
    state = MultiQueryState(
        *(b if a is b else torch.where(took, a, b) for a, b in zip(new, state))
    )
    return state, _advance_cursor(cursor, wd, marks)


def ingest_round(
    state: MultiQueryState,
    cursor: SampleCursor,
    wd: WindowData,
    *,
    spec: MultiQuerySpec,
    plans: Optional[autotune.PlanPair] = None,
) -> tuple:
    """Exact-completion round: ingest every unread block of the window,
    no marking, no stats (the caller runs one `stats_step` at the end)."""
    marks = ops.mark_blocks(wd.indices, wd.valid, cursor.read_mask)
    zw, xw = _masked_ids(wd, marks)
    state = ingest(state, zw, xw, spec=spec, plan=plans.ingest if plans else None)
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
    qtype: str  # "topk" | "closeness"
    gap: float  # closeness promise gap; 0.0 for top-k
    admit_time: float
    admit_rounds: int
    admit_passes: int
    admit_blocks_read: int
    admit_blocks_considered: int
    admit_tuples_read: int
    stop: Optional[StopPolicy] = None  # SLA policy; None = run to the bound


@dataclasses.dataclass
class QueryOutcome:
    """Per-query result produced at retirement."""

    qid: int
    ids: np.ndarray  # (k,) matching ids, closest first; for a closeness
    # query every candidate labeled close (variable length, tau order)
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
    # I/O quarantine: with blocks quarantined while this query was served
    # the guarantee holds over the surviving blocks (``exact`` means a
    # complete read of them), and ``eps_effective`` is the radius against
    # the full data, eps + 2q for a share q of tuples lost; fault-free it
    # is the query's eps
    degraded: bool = False
    eps_effective: float = float("nan")
    blocks_quarantined: int = 0
    qtype: str = "topk"  # "topk" | "closeness"
    # SLA early stop: the answer is then the anytime statement of that
    # poll (exact=False, terminated=False, the achieved delta_upper)
    stopped: bool = False
    stop_reason: str = ""  # "confidence" | "tuples" | "wall_ms"
    anytime: Optional["AnytimeAnswer"] = None  # `peek` at the retirement poll


@dataclasses.dataclass
class AnytimeAnswer:
    """A poll-boundary answer with its Theorem-1-style statement: the
    current best set ``ids`` (closest first), each candidate's empirical
    distance within ``eps_n`` of its true one w.p. > 1 - delta/|V_Z|, the
    set wrong w.p. at most ``delta_upper``, and each listed candidate's
    decision ``margin`` in metric space."""

    qid: int
    qtype: str  # "topk" | "closeness"
    status: str  # "queued" | "live" | "done"
    ids: np.ndarray  # current best set, closest first
    tau: np.ndarray  # (len(ids),) empirical distances of the best set
    margin: np.ndarray  # (len(ids),) per-candidate decision margin
    split: float  # current split point / closeness threshold
    n_min: float  # weakest per-candidate sample count
    tau_min: float
    eps_n: float  # metric-space eps(n_min) at per-candidate budget delta/V_Z
    delta_upper: float  # union failure bound of the current labeling
    confidence: float  # max(0, 1 - delta_upper)
    round: int
    tuples: int
    tuples_live: int  # tuples read while this query was live
    eps: float
    delta: float
    metric: str
    exact: bool = False
    stopped: bool = False
    stop_reason: str = ""
    result: Optional[object] = None  # final MatchResult once status == "done"

    def curve_point(self) -> dict:
        """This answer as a confidence-curve point (the reference's
        telemetry columns)."""
        return dict(
            round=self.round,
            tuples=self.tuples,
            tuples_live=self.tuples_live,
            n_min=self.n_min,
            tau_min=self.tau_min,
            eps_n=self.eps_n,
            delta_upper=self.delta_upper,
            confidence=self.confidence,
        )


def _theorem1_eps_np(n: float, delta_i: float, v_x: int) -> float:
    """Host-side scalar Theorem 1 eps(n), the mirror of
    `bounds.theorem1_epsilon`, so a poll never launches device work."""
    n = max(float(n), 1.0)
    return math.sqrt((2.0 / n) * (v_x * math.log(2.0) - math.log(delta_i)))


def _metric_eps_np(n: float, delta_i: float, v_x: int, metric: str) -> float:
    """`_theorem1_eps_np` through the metric's budget inverse (the host
    mirror of `bounds.metric_epsilon`)."""
    eps1 = _theorem1_eps_np(n, delta_i, v_x)
    if metric == "l1":
        return eps1
    if metric == "chi2":
        return 3.0 * eps1
    if metric == "hellinger":
        return 2.0 * math.sqrt(eps1)
    raise ValueError(f"unknown metric {metric!r}")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


class _BatchAcc:
    """Host wall-time accumulators of one poll's round batch: filled
    between polls (two `perf_counter` reads a window, the only telemetry
    cost off the polls), drained into one ``round_batch`` event a poll."""

    __slots__ = ("windows", "gather_s", "dispatch_s", "sync_s")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.windows = 0
        self.gather_s = 0.0
        self.dispatch_s = 0.0
        self.sync_s = 0.0


def _timed_iter(stream, acc: _BatchAcc):
    """Yield from ``stream``, adding each window's wait to ``acc.gather_s``
    (behind a `PrefetchSource` this is the stall left over, not the
    whole fetch)."""
    it = iter(stream)
    while True:
        t0 = time.perf_counter()
        try:
            wd = next(it)
        except StopIteration:
            return
        acc.gather_s += time.perf_counter() - t0
        yield wd


class SharedCountsScheduler:
    """The FastMatch execution loop over a shared counts matrix.

    Owns the cyclic visit order, the device-resident `SampleCursor`, the
    pass structure and the `MultiQueryState`. Queries enter via `admit`
    (top-k or closeness, any time, into a free slot), leave via `retire`
    (collected in `outcomes`), and `pump` drives one `fused_round` per
    window until every live query resolves, polling the device every
    ``poll_every`` windows; a poll retires queries whose bound fired,
    then those whose `StopPolicy` fired, and calls ``on_round``. A pass
    visits every unread block in cyclic order; blocks AnyActive skipped
    stay eligible for later passes. If a pass reads nothing while
    queries remain live, the scheduler completes exactly (reads the
    remainder) and retires them with ``exact=True``; a ``max_rounds``
    budget instead stops with the queries left best-effort
    (``budget_exhausted``). ``telemetry`` (a `repro_torch.obs.Telemetry`)
    records the polls, the queries' lifecycles and the round batches
    (see the module docstring).
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
        telemetry=None,
        plans: Optional[autotune.PlanPair] = None,
    ):
        source = as_block_source(dataset, device=device)
        if spec.v_z != source.v_z or spec.v_x != source.v_x:
            raise ValueError("spec/dataset dimension mismatch")
        if policy not in ("anyactive", "scan"):
            raise ValueError(f"unknown policy {policy!r}")
        if poll_every < 1:
            raise ValueError(f"need poll_every >= 1, got {poll_every}")
        self.source = source
        self.device = getattr(source, "device", None) or resolve_device(device)
        self.spec = spec
        self.policy = policy
        self.poll_every = poll_every
        # kernel plans, resolved once here (under FASTMATCH_TORCH_AUTOTUNE=1
        # this may tune and save missing keys), so one scheduler's whole
        # lifetime runs one consistent plan
        self.plans = plans if plans is not None else autotune.resolve_plans(
            spec.v_z, spec.v_x, spec.max_queries, metric=spec.metric, device=self.device
        )
        if not isinstance(self.plans, autotune.PlanPair):
            raise TypeError(f"plans must be an autotune.PlanPair, got {self.plans!r}")
        self.plans.tau.validate()
        self.plans.ingest.validate()
        nb = source.num_blocks
        self.window = max(1, min(window, nb))

        rng = np.random.default_rng(seed)
        start = start_block if start_block is not None else int(rng.integers(nb))
        self._start = start  # the visit order's offset, carried by export_cache
        self.order = np.roll(np.arange(nb), -start)  # cyclic visit order

        self.state = init_multi_state(spec, device=self.device)
        self.cursor = init_cursor(nb, device=self.device)
        self.tickets: Dict[int, _Ticket] = {}  # slot -> ticket
        self.outcomes: Dict[int, QueryOutcome] = {}  # qid -> outcome
        self._next_qid = 0
        # live closeness slots: while 0 the rounds skip the closeness rule
        self._closeness_live = 0

        # host mirrors of the device cursor + per-slot bounds, refreshed
        # by `_sync()` (per-query numbers are deltas vs admit)
        self.read_mask = np.zeros(nb, dtype=bool)
        self.rounds = 0
        self.passes = 0  # host-side pass structure, not device state
        self.blocks_read = 0
        self.blocks_considered = 0
        self.tuples_read = 0
        self._delta_upper = np.zeros(spec.max_queries, np.float32)
        # anytime mirrors: `peek` assembles answers from these
        self._tel_tau = np.ones((spec.max_queries, spec.v_z), np.float32)
        self._tel_n = np.zeros(spec.v_z, np.float32)
        self._in_top_k_host = np.zeros((spec.max_queries, spec.v_z), bool)
        self._pruned_host = np.zeros((spec.max_queries, spec.v_z), bool)
        # quarantine (host side: a quarantined block leaves every later
        # pass order and never reaches a round); all False fault-free,
        # where every eligibility mask below is the unquarantined one
        self.quarantined = np.zeros(nb, dtype=bool)
        self.blocks_quarantined = 0
        self.tuples_quarantined = 0
        self.total_tuples = int(np.sum(np.asarray(source.tuples_per_block, np.int64)))
        self.budget_exhausted = False
        self.host_syncs = 0  # number of device->host polls performed
        # the polls of the window loop itself (pump, run_window): the
        # cadence poll_every sets, without admission's fixed polls
        self.loop_syncs = 0

        # telemetry records at polls only (see the module docstring)
        self.telemetry = telemetry
        if telemetry is not None:
            reg = telemetry.registry
            self._tel_last = {"rounds": 0, "blocks": 0, "tuples": 0, "passes": 0}
            # a poll stages two appends (`_record_poll`); the shaping into
            # dicts and registry calls happens in `flush_telemetry`, in
            # batches, where it does not run cold between device phases
            self._poll_buf: list = []
            self._tel_pending = {"syncs": 0, "rounds": 0, "blocks": 0, "tuples": 0, "passes": 0}
            telemetry.add_flush_hook(self.flush_telemetry)
            self._c_syncs = reg.counter(
                "fastmatch_host_syncs_total", "device-host polls performed")
            self._c_rounds = reg.counter(
                "fastmatch_rounds_total", "windows dispatched (stats iterations)")
            self._c_blocks = reg.counter(
                "fastmatch_blocks_read_total", "blocks ingested into shared counts")
            self._c_tuples = reg.counter(
                "fastmatch_tuples_read_total", "tuples drawn (m of Theorem 1)")
            self._c_passes = reg.counter(
                "fastmatch_passes_total", "cyclic passes over the block layout")
            self._c_admitted = reg.counter(
                "fastmatch_queries_admitted_total", "queries admitted into slots")
            self._c_retired = reg.counter(
                "fastmatch_queries_retired_total", "queries retired with an answer")
            self._c_quarantined = reg.counter(
                "fastmatch_blocks_quarantined_total",
                "blocks dropped from the probe set after I/O quarantine")
            self._h_batch = reg.histogram(
                "fastmatch_round_batch_seconds",
                help="host wall per round batch (gather+dispatch+sync)")
            self._h_q_tuples = reg.histogram(
                "fastmatch_query_tuples", edges=tuple(float(10 ** e) for e in range(2, 11)),
                help="tuples read while a query was live (per-query m)")
            self._h_q_rounds = reg.histogram(
                "fastmatch_query_rounds", edges=tuple(float(2 ** e) for e in range(0, 14)),
                help="rounds to retirement (paper Fig. 5)")
            self._h_q_wall = reg.histogram(
                "fastmatch_query_wall_seconds", help="admit-to-retire wall time")

    # -- quarantine (degraded guarantees) ----------------------------------

    def quarantine_blocks(self, ids, *, reason: str = "io") -> int:
        """Drop blocks from the probe set (an I/O quarantine verdict of
        `repro_torch.io.faults.ResilientSource`); returns how many newly
        left it. Blocks already read stay: their tuples were validated
        when fetched and sit in the counts. Every (eps, delta) after this
        is over the surviving blocks; `eps_inflation` is the widening
        against the full data that retirement adds to ``eps_effective``.
        ``reason`` names the verdict's origin (telemetry records it)."""
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size:
            ids = ids[~self.quarantined[ids] & ~self.read_mask[ids]]
        if ids.size == 0:
            return 0
        self.quarantined[ids] = True
        tuples = int(np.sum(np.asarray(self.source.tuples_per_block, np.int64)[ids]))
        self.blocks_quarantined += int(ids.size)
        self.tuples_quarantined += tuples
        if self.telemetry is not None:
            self._c_quarantined.inc(int(ids.size))
            self.telemetry.tracer.emit(
                "blocks_quarantine", blocks=int(ids.size), tuples=tuples, reason=reason,
                total_blocks=self.blocks_quarantined, population_frac=self.quarantine_fraction,
            )
        return int(ids.size)

    def _drain_quarantine(self) -> None:
        """Pull the quarantined block ids out of the `ResilientSource` in
        the source chain (at every poll; fault-free, an attribute probe)."""
        resilient = find_resilient(self.source)
        if resilient is not None:
            ids = resilient.take_quarantined()
            if ids.size:
                self.quarantine_blocks(ids, reason="source")

    @property
    def quarantine_fraction(self) -> float:
        """The share of the dataset's tuples lost to quarantine (the q of
        eps + 2q)."""
        return self.tuples_quarantined / max(self.total_tuples, 1)

    @property
    def eps_inflation(self) -> float:
        """The additive l1 widening against the full data: the layout
        assigns tuples to blocks independently of their content, so
        dropping a share q of the tuples moves any candidate's normalised
        histogram by at most 2q in l1."""
        return 2.0 * self.quarantine_fraction

    # -- host/device synchronisation --------------------------------------

    def _sync(self) -> None:
        """One device->host poll: cursor, per-slot bounds, and the anytime
        mirrors (tau, n, matching sets, pruned masks), in two copies: one
        f32 buffer and one byte buffer. Everything the host loop decides
        on is refreshed here and only here."""
        c, st = self.cursor, self.state
        q, v_z = self.spec.max_queries, self.spec.v_z
        floats = torch.cat((st.delta_upper, st.tau.reshape(-1), st.n)).cpu().numpy()
        counters = (c.rounds, c.blocks_read, c.blocks_considered, c.tuples_read)
        raw = torch.cat(
            [_bytes(t) for t in counters] + [_bytes(c.read_mask), _bytes(st.in_top_k),
                                              _bytes(st.pruned)]
        ).cpu().numpy()
        self._delta_upper = floats[:q]
        self._tel_tau = floats[q : q + q * v_z].reshape(q, v_z)
        self._tel_n = floats[q + q * v_z :]
        head = 8 * len(counters)
        self.rounds, self.blocks_read, self.blocks_considered, self.tuples_read = (
            int(v) for v in raw[:head].view(np.int64)
        )
        nb = self.read_mask.size
        self.read_mask = raw[head : head + nb].view(bool)
        flags = raw[head + nb :].view(bool).reshape(2, q, v_z)
        self._in_top_k_host, self._pruned_host = flags[0], flags[1]
        self.host_syncs += 1
        self._drain_quarantine()
        if self.telemetry is not None:
            self._record_poll()

    def _record_poll(self) -> None:
        """Stage this poll for telemetry (from `_sync` only): counter deltas
        into plain ints and one tuple of array references into the poll
        buffer; `flush_telemetry` shapes them later.

        The buffer holds references, not copies: `_sync` makes fresh host
        arrays at every poll (``.cpu().numpy()`` of a fresh ``torch.cat``),
        so each staged entry keeps its own poll's values. If `_sync` ever
        reuses its host buffers (pinned staging, say), copy the arrays
        here, or every staged point would read the last poll."""
        last = self._tel_last
        p = self._tel_pending
        p["syncs"] += 1
        p["rounds"] += self.rounds - last["rounds"]
        p["blocks"] += self.blocks_read - last["blocks"]
        p["tuples"] += self.tuples_read - last["tuples"]
        p["passes"] += self.passes - last["passes"]
        last.update(rounds=self.rounds, blocks=self.blocks_read, tuples=self.tuples_read,
                    passes=self.passes)
        if self.tickets:
            # the entry carries the live ticket set of its poll (tickets do
            # not change after admission), so a flush at any later time
            # shapes it under the queries that were live when it was taken
            self._poll_buf.append(
                (self.rounds, self.tuples_read, self._tel_n, self._tel_tau,
                 self._delta_upper, list(self.tickets.items()))
            )
            if len(self._poll_buf) >= 256:
                self.flush_telemetry()  # bound the buffer on a long pump

    def flush_telemetry(self) -> None:
        """Drain the staged polls into the registry and the per-query
        trajectories. Each staged poll carries its own live ticket set, so
        a flush may run at any time: at the end of `pump`, when the buffer
        reaches its bound, and from `Telemetry`'s read accessors."""
        tel = self.telemetry
        if tel is None:
            return
        p = self._tel_pending
        if p["syncs"]:
            self._c_syncs.inc(p["syncs"])
            self._c_rounds.inc(p["rounds"])
            self._c_blocks.inc(p["blocks"])
            self._c_tuples.inc(p["tuples"])
            self._c_passes.inc(p["passes"])
            for key in p:
                p[key] = 0
        buf = self._poll_buf
        if not buf:
            return
        self._poll_buf = []
        v_z, v_x = self.spec.v_z, self.spec.v_x
        for rounds, tuples, n, tau, du, live in buf:
            # each poll's reductions in place: stacking the batch first
            # would copy every staged (Q, V_Z) tau
            n_min = float(n.min())
            tau_mins = tau.min(axis=1)
            for slot, t in live:
                d_up = float(du[slot])
                tel.record_curve_point(t.qid, dict(
                    round=rounds,
                    tuples=tuples,
                    tuples_live=tuples - t.admit_tuples_read,
                    n_min=n_min,
                    tau_min=float(tau_mins[slot]),
                    # eps(n) at the per-candidate budget delta / V_Z: the
                    # AnyActive threshold of the stats tail
                    eps_n=_metric_eps_np(n_min, t.delta / v_z, v_x, self.spec.metric),
                    delta_upper=d_up,
                    confidence=max(0.0, 1.0 - d_up),
                ))

    def _round_batch_extra(self) -> dict:
        """Extra ``round_batch`` fields: the data-parallel pump's per-worker
        timings (ROADMAP A9); none here."""
        return {}

    def _emit_round_batch(self, acc: _BatchAcc) -> None:
        """Drain one poll's timing accumulators into a ``round_batch`` event."""
        self._h_batch.observe(acc.gather_s + acc.dispatch_s + acc.sync_s)
        self.telemetry.tracer.emit(
            "round_batch", windows=acc.windows, rounds=self.rounds,
            blocks_read=self.blocks_read, tuples_read=self.tuples_read,
            gather_s=acc.gather_s, dispatch_s=acc.dispatch_s, sync_s=acc.sync_s,
            **self._round_batch_extra(),
        )
        acc.reset()

    # -- warm cache ----------------------------------------------------------

    def export_cache(self) -> CacheSnapshot:
        """The target-independent serving state (see `CacheSnapshot`).
        Counts and cursor come out of the same round, so a snapshot is
        consistent at any time; live slots are not exported."""
        c = self.cursor
        as_counter = dict(dtype=torch.int64, device=self.device)
        return CacheSnapshot(
            counts=self.state.counts,
            n=self.state.n,
            read_mask=c.read_mask,
            blocks_read=c.blocks_read,
            blocks_considered=c.blocks_considered,
            tuples_read=c.tuples_read,
            rounds=c.rounds,
            passes=torch.tensor(self.passes, **as_counter),
            start=torch.tensor(self._start, **as_counter),
        )

    def import_cache(self, snap: CacheSnapshot) -> None:
        """Adopt a warm cache: shared counts, sampling cursor, pass count
        and visit order. Refused under live queries, whose admission-time
        counters it would invalidate."""
        if self.tickets:
            raise RuntimeError("import_cache requires a scheduler with no live queries")
        nb = self.source.num_blocks
        shape = (self.spec.v_z, self.spec.v_x)
        if tuple(snap.counts.shape) != shape:
            raise ValueError(
                f"snapshot counts shape {tuple(snap.counts.shape)} != {shape} — "
                "wrong dataset/spec for this cache"
            )
        if tuple(snap.read_mask.shape) != (nb,):
            raise ValueError(
                f"snapshot read_mask covers {snap.read_mask.shape[0]} blocks, "
                f"dataset has {nb} — wrong layout for this cache"
            )

        def put(t, dtype):
            return torch.as_tensor(t).to(device=self.device, dtype=dtype)

        self.state = self.state._replace(
            counts=put(snap.counts, torch.float32), n=put(snap.n, torch.float32)
        )
        self.cursor = SampleCursor(
            read_mask=put(snap.read_mask, torch.bool),
            **{f: put(getattr(snap, f), torch.int64) for f in SampleCursor._fields[1:]},
        )
        self._start = int(snap.start)
        self.order = np.roll(np.arange(nb), -self._start)
        self.passes = int(snap.passes)
        self._sync()  # every host mirror from the restored cursor

    # -- admission / retirement -------------------------------------------

    @property
    def free_slots(self) -> list:
        return [s for s in range(self.spec.max_queries) if s not in self.tickets]

    @property
    def num_live(self) -> int:
        return len(self.tickets)

    def _stats_step(self) -> None:
        self.state = stats_step(
            self.state, spec=self.spec, closeness=self._closeness_live > 0, plan=self.plans.tau
        )

    def admit(
        self,
        target: np.ndarray,
        *,
        k: int,
        eps: float,
        delta: float,
        qtype: str = "topk",
        gap: float = 0.0,
        stop: Optional[StopPolicy] = None,
    ) -> int:
        """Place a query into a free slot; returns its qid. The immediate
        `stats_step` lets it see the accumulated shared counts before the
        next window is marked.

        ``qtype="closeness"`` admits a tolerant closeness test: every
        candidate within ``eps`` of the target is labeled close, every
        one beyond ``eps + gap`` far, w.p. >= 1 - delta (k unused).
        ``stop`` attaches a `StopPolicy` (None inherits
        ``spec.default_stop``)."""
        free = self.free_slots
        if not free:
            raise RuntimeError("no free query slot; retire a query first")
        if qtype not in ("topk", "closeness"):
            raise ValueError(f"qtype must be 'topk' or 'closeness', got {qtype!r}")
        if qtype == "closeness":
            if not gap > 0.0:
                raise ValueError(f"closeness needs gap > 0, got gap={gap}")
            if not eps >= 0.0:
                raise ValueError(f"closeness needs eps >= 0, got eps={eps}")
        else:
            if gap != 0.0:
                raise ValueError("gap is only meaningful for qtype='closeness'")
            if not (0 < k <= self.spec.v_z):
                raise ValueError(f"need 0 < k <= V_Z, got k={k}")
            if self.spec.k_cap is not None and k > self.spec.k_cap:
                raise ValueError(f"k={k} exceeds spec.k_cap={self.spec.k_cap}")
        slot = free[0]
        target = np.asarray(target, np.float64).ravel()
        if target.shape != (self.spec.v_x,):
            raise ValueError(f"target must have shape ({self.spec.v_x},)")
        q_hat = (target / max(target.sum(), 1e-30)).astype(np.float32)
        code = QTYPE_CLOSENESS if qtype == "closeness" else QTYPE_TOPK
        self.state = admit_slot(
            self.state, slot, torch.from_numpy(q_hat), k, eps, delta, qtype=code, gap=gap
        )
        self._closeness_live += code == QTYPE_CLOSENESS
        self._stats_step()
        self._sync()  # fresh counters for the ticket + fresh delta_upper
        qid = self._next_qid
        self._next_qid += 1
        self.tickets[slot] = _Ticket(
            qid=qid,
            slot=slot,
            k=int(k),
            eps=float(eps),
            delta=float(delta),
            qtype=qtype,
            gap=float(gap),
            admit_time=time.perf_counter(),
            admit_rounds=self.rounds,
            admit_passes=self.passes,
            admit_blocks_read=self.blocks_read,
            admit_blocks_considered=self.blocks_considered,
            admit_tuples_read=self.tuples_read,
            stop=stop if stop is not None else self.spec.default_stop,
        )
        if self.telemetry is not None:
            self._c_admitted.inc(1)
            self.telemetry.tracer.emit(
                "query_admit", qid=qid, slot=slot, k=int(k), eps=float(eps),
                delta=float(delta), qtype=qtype, gap=float(gap),
                round=self.rounds, tuples=self.tuples_read,
            )
            # admission's poll ran before the ticket existed, so its staged
            # entry does not carry this query: stage its first point (on a
            # warm cache perhaps already terminal) from the same mirrors
            self._poll_buf.append(
                (self.rounds, self.tuples_read, self._tel_n, self._tel_tau,
                 self._delta_upper, [(slot, self.tickets[slot])])
            )
        return qid

    def peek(self, slot: int) -> AnytimeAnswer:
        """The current anytime answer of a live slot, from the last poll's
        host mirrors only (no device work). Selection and margins repeat
        the device's f32 arithmetic in the same association, with its
        tie rule (stable ascending sort), so at a poll the set equals
        what retirement reports; `retire` calls this too."""
        t = self.tickets[slot]
        tau = self._tel_tau[slot]
        du = float(self._delta_upper[slot])
        eps32 = np.float32(t.eps)
        if t.qtype == "closeness":
            close = np.flatnonzero(self._in_top_k_host[slot])
            ids = close[np.argsort(tau[close], kind="stable")]
            gap32 = np.float32(t.gap)
            split32 = eps32 + np.float32(0.5) * gap32
            sel = tau[ids]
            margin = np.maximum(np.maximum(sel - eps32, (eps32 + gap32) - sel), np.float32(0.0))
        else:
            order = np.argsort(tau, kind="stable")
            ids = order[: t.k].copy()
            if t.k >= self.spec.v_z:
                split32 = np.float32(tau.max())
            else:
                split32 = np.float32(0.5) * (tau[order[t.k - 1]] + tau[order[t.k]])
            sel = tau[ids]
            margin = np.maximum(
                np.minimum(eps32, (split32 + np.float32(0.5) * eps32) - sel), np.float32(0.0)
            )
        n_min = float(self._tel_n.min())
        return AnytimeAnswer(
            qid=t.qid,
            qtype=t.qtype,
            status="live",
            ids=ids,
            tau=sel.copy(),
            margin=margin,
            split=float(split32),
            n_min=n_min,
            tau_min=float(tau.min()),
            eps_n=_metric_eps_np(n_min, t.delta / self.spec.v_z, self.spec.v_x, self.spec.metric),
            delta_upper=du,
            confidence=max(0.0, 1.0 - du),
            round=self.rounds,
            tuples=self.tuples_read,
            tuples_live=self.tuples_read - t.admit_tuples_read,
            eps=t.eps,
            delta=t.delta,
            metric=self.spec.metric,
        )

    def retire(
        self,
        slot: int,
        *,
        exact: bool,
        terminated: bool,
        stopped: bool = False,
        stop_reason: str = "",
    ) -> QueryOutcome:
        """Snapshot a slot's answer, free the slot, record the outcome.
        ``exact`` is forced True when every block has been read;
        ``stopped``/``stop_reason`` record an SLA stop. Call at a poll
        boundary (mirrors fresh)."""
        anytime = self.peek(slot)
        t = self.tickets.pop(slot)
        degraded = self.blocks_quarantined > 0
        if degraded:
            exact = exact or bool(self.read_mask[~self.quarantined].all())
        else:
            exact = exact or bool(self.read_mask.all())
        view = slot_state(self.state, slot)
        if t.qtype == "closeness":
            # the close labels, nearest first; their number is data-dependent
            close = np.flatnonzero(view.in_top_k.cpu().numpy())
            ids = close[np.argsort(view.tau.cpu().numpy()[close], kind="stable")]
        else:
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
            degraded=degraded,
            eps_effective=t.eps + (self.eps_inflation if degraded else 0.0),
            blocks_quarantined=self.blocks_quarantined,
            qtype=t.qtype,
            stopped=stopped,
            stop_reason=stop_reason,
            anytime=anytime,
        )
        anytime.status = "done"
        anytime.exact = outcome.exact
        anytime.stopped = stopped
        anytime.stop_reason = stop_reason
        self.state = clear_slot(self.state, slot)
        self._closeness_live -= t.qtype == "closeness"
        self.outcomes[t.qid] = outcome
        if self.telemetry is not None:
            self._c_retired.inc(1)
            self._h_q_tuples.observe(outcome.tuples_read)
            self._h_q_rounds.observe(outcome.rounds)
            self._h_q_wall.observe(outcome.wall_time_s)
            self.telemetry.tracer.emit(
                "query_retire", qid=t.qid, slot=slot, exact=outcome.exact,
                terminated=outcome.terminated, rounds=outcome.rounds, passes=outcome.passes,
                blocks=outcome.blocks_read, tuples=outcome.tuples_read,
                delta_upper=outcome.delta_upper, wall_s=outcome.wall_time_s,
                stopped=outcome.stopped, stop_reason=outcome.stop_reason,
            )
        return outcome

    def _poll_terminated(self) -> None:
        """Retire every live query whose bound fired at the last poll,
        then every one whose `StopPolicy` fires (the statistical rule
        wins a tie)."""
        du = self._delta_upper
        now = time.perf_counter()
        for slot in list(self.tickets):
            t = self.tickets[slot]
            if du[slot] < t.delta:
                self.retire(slot, exact=False, terminated=True)
                continue
            if t.stop is None:
                continue
            reason = t.stop.fired(
                wall_s=now - t.admit_time,
                confidence=max(0.0, 1.0 - float(du[slot])),
                tuples=self.tuples_read - t.admit_tuples_read,
            )
            if reason:
                self.retire(slot, exact=False, terminated=False, stopped=True, stop_reason=reason)

    # -- the loop ----------------------------------------------------------

    def _open_pass_stream(self, pass_order: np.ndarray) -> tuple:
        """(window stream, number of windows) for one pass."""
        windows = [
            pass_order[p : p + self.window] for p in range(0, pass_order.size, self.window)
        ]
        return self.source.stream(windows, pad_to=self.window), len(windows)

    def _on_device(self, wd: WindowData) -> WindowData:
        """The window on the scheduler's device: a window handed over in
        host memory is moved here, once, before any round reads it."""
        if wd.indices.device.type != "cpu" or self.device.type == "cpu":
            return wd
        return WindowData(
            *(getattr(wd, f).to(self.device) for f in WindowData._fields[:5]),
            bitmap_by_id=wd.bitmap_by_id,
        )

    def _dispatch_round(self, wd: WindowData) -> None:
        self.state, self.cursor = fused_round(
            self.state, self.cursor, self._on_device(wd), spec=self.spec, policy=self.policy,
            closeness=self._closeness_live > 0, plans=self.plans,
        )

    def _fetch_window_or_quarantine(self, win: np.ndarray) -> Optional[WindowData]:
        """Fetch an ad-hoc window; a `WindowQuarantined` verdict drops its
        blocks from the probe set instead (None: the window is gone)."""
        try:
            return self.source.fetch(win, pad_to=max(self.window, win.size))
        except WindowQuarantined as exc:
            self.quarantine_blocks(exc.block_ids, reason="fetch")
            return None

    def run_window(self, win: np.ndarray) -> int:
        """Mark one window against the union active set, ingest the marked
        blocks, and poll. Returns the number of blocks read."""
        win = np.asarray(win)
        if win.size == 0:
            return 0
        before = self.blocks_read
        if self.telemetry is None:
            wd = self._fetch_window_or_quarantine(win)
            if wd is not None:
                self._dispatch_round(wd)
            self._sync()
        else:
            acc = _BatchAcc()
            t0 = time.perf_counter()
            wd = self._fetch_window_or_quarantine(win)
            acc.gather_s = time.perf_counter() - t0
            if wd is not None:
                t0 = time.perf_counter()
                self._dispatch_round(wd)
                acc.dispatch_s = time.perf_counter() - t0
                acc.windows = 1
            t0 = time.perf_counter()
            self._sync()
            acc.sync_s = time.perf_counter() - t0
            self._emit_round_batch(acc)
        self.loop_syncs += 1
        return self.blocks_read - before

    def complete_remaining(self) -> None:
        """Exact completion: read every unread block into the shared
        counts (one pass, one round per window), then one `stats_step`.
        The Scan baseline is this path on a fresh scheduler."""
        self._sync()
        remaining = np.flatnonzero(~self.read_mask & ~self.quarantined)
        if remaining.size == 0:
            return
        self.passes += 1
        t0 = time.perf_counter()
        windows = 0
        stream, _ = self._open_pass_stream(remaining)
        try:
            for wd in stream:
                self.state, self.cursor = ingest_round(
                    self.state, self.cursor, self._on_device(wd), spec=self.spec,
                    plans=self.plans,
                )
                windows += 1
        finally:
            stream.close()
        self._stats_step()
        self._sync()
        if self.telemetry is not None:
            self.telemetry.tracer.emit(
                "exact_completion", windows=windows, blocks=int(remaining.size),
                rounds=self.rounds, tuples_read=self.tuples_read,
                dur_s=time.perf_counter() - t0,
            )

    def pump(
        self,
        *,
        max_rounds: int = 1_000_000,
        max_passes: int = 4,
        on_round: Optional[Callable[["SharedCountsScheduler"], None]] = None,
    ) -> None:
        """Drive windows until every live query resolves, polling every
        ``poll_every`` windows; retirement, ``on_round`` (the serving
        front end admits queued queries there) and the budget check
        happen at polls. The budgets count this call only; a budget cut
        leaves the live queries best-effort and sets
        ``budget_exhausted``. Telemetry staged during the call is
        flushed when it returns."""
        self.budget_exhausted = False
        try:
            self._pump(max_rounds=max_rounds, max_passes=max_passes, on_round=on_round)
        finally:
            self.flush_telemetry()

    def _loop_poll(self, acc: Optional[_BatchAcc], on_round) -> None:
        """A poll of the window loop: sync (timed into ``acc`` under
        telemetry), retire what fired, then ``on_round``."""
        if acc is None:
            self._sync()
        else:
            t0 = time.perf_counter()
            self._sync()
            acc.sync_s += time.perf_counter() - t0
            self._emit_round_batch(acc)
        self.loop_syncs += 1
        self._poll_terminated()
        if on_round is not None:
            on_round(self)

    def _pump(
        self,
        *,
        max_rounds: int,
        max_passes: int,
        on_round: Optional[Callable[["SharedCountsScheduler"], None]],
    ) -> None:
        tel = self.telemetry
        self._sync()
        rounds0, passes0 = self.rounds, self.passes
        # a late query may already terminate on the accumulated counts
        self._poll_terminated()
        while self.tickets and self.passes - passes0 < max_passes:
            pass_order = self.order[~self.read_mask[self.order] & ~self.quarantined[self.order]]
            if pass_order.size == 0:
                break
            self.passes += 1
            pass_start_rounds = self.rounds
            pass_start_blocks = self.blocks_read
            stream, n_rounds = self._open_pass_stream(pass_order)
            dispatched = 0
            if tel is None:
                acc, windows = None, stream
            else:
                tel.tracer.emit("pass_start", passes=self.passes, windows=n_rounds,
                                unread=int(pass_order.size))
                acc = _BatchAcc()
                windows = _timed_iter(stream, acc)
            try:
                for dispatched, wd in enumerate(windows, start=1):
                    if acc is None:
                        self._dispatch_round(wd)
                    else:
                        t0 = time.perf_counter()
                        self._dispatch_round(wd)
                        acc.dispatch_s += time.perf_counter() - t0
                        acc.windows += 1
                    if dispatched % self.poll_every == 0 or dispatched == n_rounds:
                        self._loop_poll(acc, on_round)
                        if self.rounds - rounds0 >= max_rounds:
                            # budget cut: live queries stay best-effort
                            self.budget_exhausted = True
                            if tel is not None:
                                tel.tracer.emit("budget_exhausted", rounds=self.rounds,
                                                live=len(self.tickets))
                            return
                        if not self.tickets:
                            break
            finally:
                stream.close()
            if dispatched == 0 or (dispatched % self.poll_every != 0 and dispatched != n_rounds):
                # the stream ended short of its last scheduled poll, which
                # only a resilient source skipping quarantined trailing
                # windows does: poll now, or the zero-progress check below
                # would judge stale mirrors
                self._loop_poll(acc, on_round)
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
            if on_round is not None:
                on_round(self)
