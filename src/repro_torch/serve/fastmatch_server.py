"""FastMatch query server: N concurrent matching queries, one I/O stream.

Port of `repro.serve.fastmatch_server`. `MatchServer` is a request
queue feeding a fixed pool of ``max_queries`` slots over one
`SharedCountsScheduler`. It serves top-k matching (`submit`) and
tolerant closeness testing (`submit_closeness`) through the same queue
and counts matrix, in the metric chosen at construction:

  admission  — queued requests enter free slots at every poll, mid-
               stream; a new query starts from the shared counts
               accumulated so far (sampling is target-independent)
  serving    — one AnyActive marking (kernel A) per window against the
               union of the slots' active sets, one shared ingest
               (kernel B), one tau launch for all slots (kernel C)
  retirement — a query leaves its slot when its own bound fires (or its
               `StopPolicy` does) and becomes a `MatchResult`
  cache      — the shared counts and read mask live as long as the
               server: once they cover a later query's needs it answers
               with no new I/O

Anytime serving: `poll_result(rid)` returns the current `AnytimeAnswer`
of a request from the last poll's host mirrors, without device work;
`iter_results(rid)` drives `step()` and yields each answer as it
tightens, ending with the final one. A stopped query retires with the
answer of its stopping poll.

Per-query counters (blocks/tuples/rounds) count what was read while
that query was live. Runs on CUDA unless ``device="cpu"``.

``kernel_plans`` pins the kernel plans (`autotune.PlanPair`) of every
round the server dispatches; by default the scheduler resolves them
from the plan file of the device's backend, and `kernel_plans` reports
what it resolved.

Faults and restarts: the built source goes through `io.maybe_chaos`
(``FASTMATCH_CHAOS=1`` serves through retry-heals-it faults) and, with
``prefetch=True``, a `PrefetchSource`. A `ResilientSource` among the
sources quarantines what it cannot serve; the scheduler retires queries
over the surviving blocks and says so (``degraded``, ``eps_effective =
eps + 2q``). With ``checkpoint_dir`` the server snapshots its warm cache
(`multiquery.CacheSnapshot`: counts, n, read mask, counters, passes,
visit order) through `checkpoint.CheckpointManager` after every
``autosave_every`` retirements and every ``autosave_rounds`` rounds, in
the reference's files and dtypes, bound to the layout and spec by
`cache_config_hash`; `restore` builds a server on the newest verified
snapshot, written by either package. Live queries are not persisted:
sampling is target-independent, so a re-submitted query loses nothing.
`serve.ServeSupervisor` adds deadlines, shedding and crash recovery;
``last_error`` and ``queries_shed`` in `metrics` are what it reports.

Telemetry: ``telemetry=True`` builds a `repro_torch.obs.Telemetry` on
the server's device (an instance is adopted as it is; None or False
leaves it off) and threads it into the scheduler, the `PrefetchSource`
and the `CheckpointManager`; the server adds the submitted counter and
the ``query_enqueue`` and ``query_done`` events (the rid <-> qid join).
`export_trace` and `prometheus_metrics` export it. A server with
telemetry on serves bitwise as one with it off.

Not ported yet, and refused with `NotImplementedError` naming the
ROADMAP item: the mesh and data-parallel pump servers and restoring onto
another mesh (A9).
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import MatchResult
from repro_torch.core.multiquery import (
    AnytimeAnswer,
    CacheSnapshot,
    MultiQuerySpec,
    QueryOutcome,
    SharedCountsScheduler,
    StopPolicy,
    cache_config_hash,
)
from repro_torch.io import PrefetchSource, as_block_source, maybe_chaos
from repro_torch.kernels.autotune import PlanPair
from repro_torch.obs import Telemetry

__all__ = [
    "AnytimeAnswer",
    "MatchQuery",
    "MatchServer",
    "StopPolicy",
    "answer_from_result",
]

# Reference options this port does not have yet: name -> (the value that
# leaves the feature off, the ROADMAP item that ports it).
_UNPORTED = {
    "mesh": (None, "A9"),
    "model_axis": ("model", "A9"),
    "pump": (False, "A9"),
    "data_axes": (("data",), "A9"),
}

# the reference's dtypes of a snapshot's counters (int32); the port's
# are int64 and widen again on import
_INT32_MAX = np.iinfo(np.int32).max


def _on_disk(snap: CacheSnapshot) -> CacheSnapshot:
    """``snap`` with the reference's leaf dtypes, so either package can
    restore the files."""
    counters = {}
    for f in CacheSnapshot._fields[3:]:
        v = getattr(snap, f)
        if int(v) > _INT32_MAX:
            raise ValueError(f"snapshot counter {f}={int(v)} does not fit the int32 on disk")
        counters[f] = v.to(torch.int32)
    return snap._replace(**counters)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def answer_from_result(res: MatchResult, *, metric: str) -> AnytimeAnswer:
    """A blocking `MatchResult` as a ``status="done"`` anytime answer.
    The per-poll fields it cannot recover (split, eps_n, the query's eps
    and delta) come back NaN; the set, tau, margin and delta_upper are
    exact."""
    ids = np.asarray(res.ids)
    tau_full = res.state.tau.cpu().numpy()
    du = float(res.delta_upper)
    return AnytimeAnswer(
        qid=-1, qtype=res.qtype, status="done", ids=ids,
        tau=tau_full[ids], margin=res.state.eps_i.cpu().numpy()[ids],
        split=float("nan"), n_min=float(res.state.n.min()),
        tau_min=float(tau_full.min()), eps_n=float("nan"),
        delta_upper=du, confidence=max(0.0, 1.0 - du),
        round=res.rounds, tuples=res.tuples_read,
        tuples_live=res.tuples_read, eps=float("nan"),
        delta=float("nan"), metric=metric,
        exact=res.exact, stopped=res.stopped,
        stop_reason=res.stop_reason, result=res,
    )


@dataclasses.dataclass
class MatchQuery:
    """One queued request: a top-k match or a tolerant closeness test
    (qtype="closeness", k unused, gap > 0)."""

    rid: int
    target: np.ndarray  # (V_X,) unnormalized or normalized target histogram
    k: int
    eps: float
    delta: float
    submit_time: float
    qtype: str = "topk"  # "topk" | "closeness"
    gap: float = 0.0  # closeness promise gap
    stop: Optional[StopPolicy] = None  # SLA policy; None = server default


class MatchServer:
    """Serve top-k and closeness queries over one shared sample stream."""

    def __init__(
        self,
        dataset,
        *,
        device=None,
        max_queries: int = 8,
        criterion: str = "histsim",
        policy: str = "anyactive",
        lookahead: int = 512,
        seed: int = 0,
        start_block: Optional[int] = None,
        max_passes: int = 64,
        poll_every: int = 1,
        k_cap: Optional[int] = None,
        metric: str = "l1",
        bounds_mode: str = "native",
        prune: bool = False,
        default_stop: Optional[StopPolicy] = None,
        kernel_plans: Optional[PlanPair] = None,
        prefetch: bool = False,
        checkpoint_dir: Optional[str] = None,
        autosave_every: int = 8,
        autosave_rounds: Optional[int] = None,
        checkpoint_keep_last: int = 3,
        telemetry=None,
        **unported,
    ):
        # k_cap: static bound on any query's k (the deviation assignment
        # then reads k_cap + 1 order statistics). metric: the distance
        # every query is stated in. bounds_mode: "native" (tau-aware
        # per-metric budgets) or "conservative". prune: early-reject of
        # certified-far candidates from the I/O marking. default_stop:
        # StopPolicy for queries submitted without one. kernel_plans: the
        # PlanPair of every round; None resolves it from the plan file.
        # prefetch: fetch the next window on a worker thread while the
        # current round runs. checkpoint_dir: keep warm-cache snapshots
        # there; autosave_every: snapshot after this many retirements (0
        # never); autosave_rounds: also after this many new rounds;
        # checkpoint_keep_last: snapshots kept. telemetry: True builds a
        # Telemetry on the server's device, an instance is adopted (one
        # server to a handle: query ids key its curves), None or False
        # leaves every layer on its untouched path.
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"MatchServer() got an unexpected keyword argument {name!r}")
            off, item = _UNPORTED[name]
            if (tuple(value) if name == "data_axes" else value) != off:
                raise _not_ported(f"MatchServer({name}=...)", item)
        source = maybe_chaos(as_block_source(dataset, device=device))
        if telemetry is True:
            telemetry = Telemetry(device=getattr(source, "device", None) or resolve_device(device))
        elif telemetry is False:
            telemetry = None
        self.telemetry = telemetry
        if telemetry is not None:
            self._c_submitted = telemetry.registry.counter(
                "fastmatch_queries_submitted_total", "requests accepted into the queue")
        if prefetch:
            source = PrefetchSource(source, telemetry=telemetry)
        self.spec = MultiQuerySpec(
            v_z=source.v_z,
            v_x=source.v_x,
            max_queries=max_queries,
            criterion=criterion,
            k_cap=k_cap,
            metric=metric,
            bounds_mode=bounds_mode,
            prune=prune,
            default_stop=default_stop,
        )
        self.scheduler = SharedCountsScheduler(
            source,
            self.spec,
            policy=policy,
            window=lookahead,
            seed=seed,
            start_block=start_block,
            poll_every=poll_every,
            device=device,
            telemetry=telemetry,
            plans=kernel_plans,
        )
        self.max_passes = max_passes
        self._manager: Optional[CheckpointManager] = None
        if checkpoint_dir is not None:
            self._manager = CheckpointManager(
                checkpoint_dir,
                keep_last=checkpoint_keep_last,
                config_hash=cache_config_hash(self.scheduler.source, self.spec),
                telemetry=telemetry,
            )
        self.autosave_every = autosave_every
        self.autosave_rounds = autosave_rounds
        self._retired_since_save = 0
        self._rounds_at_save = 0
        # the health surface of `metrics`; the supervisor writes these
        self.last_error = ""
        self.queries_shed = 0
        self.pending: Deque[MatchQuery] = deque()
        self.results: Dict[int, MatchResult] = {}
        self._rid_of_qid: Dict[int, int] = {}
        self._qid_of_rid: Dict[int, int] = {}  # live queries only
        # retirement-time anytime answers, so a done poll replays the final one
        self._anytime: Dict[int, AnytimeAnswer] = {}
        self._submit_time: Dict[int, float] = {}
        self._next_rid = 0
        # step()'s pass cursor (None = start a fresh pass next step)
        self._pass_order: Optional[np.ndarray] = None
        self._pass_pos = 0
        self._pass_read = 0
        self._pass_start_rounds = 0

    @property
    def kernel_plans(self) -> PlanPair:
        """The `autotune.PlanPair` this server's rounds run."""
        return self.scheduler.plans

    # -- request queue -----------------------------------------------------

    def submit(
        self,
        target: np.ndarray,
        *,
        k: int,
        eps: float = 0.06,
        delta: float = 0.01,
        stop: Optional[StopPolicy] = None,
    ) -> int:
        """Queue a top-k query; returns a request id resolved in
        `results`. Validated here, so a malformed request never waits in
        the queue."""
        target = np.asarray(target, np.float64).ravel()
        if target.shape != (self.spec.v_x,):
            raise ValueError(f"target must have shape ({self.spec.v_x},), got {target.shape}")
        if not (0 < k <= self.spec.v_z):
            raise ValueError(f"need 0 < k <= V_Z={self.spec.v_z}, got k={k}")
        if self.spec.k_cap is not None and k > self.spec.k_cap:
            raise ValueError(f"k={k} exceeds the server's k_cap={self.spec.k_cap}")
        return self._enqueue(target, k=k, eps=eps, delta=delta, stop=stop)

    def submit_closeness(
        self,
        target: np.ndarray,
        *,
        eps: float,
        gap: float,
        delta: float = 0.01,
        stop: Optional[StopPolicy] = None,
    ) -> int:
        """Queue a tolerant closeness test; returns a request id. The
        result's ``ids`` are every candidate labeled close, nearest
        first: w.p. >= 1 - delta none beyond ``eps + gap`` is among them
        and none within ``eps`` is missing."""
        target = np.asarray(target, np.float64).ravel()
        if target.shape != (self.spec.v_x,):
            raise ValueError(f"target must have shape ({self.spec.v_x},), got {target.shape}")
        if not gap > 0.0:
            raise ValueError(f"closeness needs gap > 0, got gap={gap}")
        if not eps >= 0.0:
            raise ValueError(f"closeness needs eps >= 0, got eps={eps}")
        return self._enqueue(
            target, k=1, eps=eps, delta=delta, qtype="closeness", gap=gap, stop=stop
        )

    def _enqueue(
        self, target, *, k, eps, delta, qtype: str = "topk", gap: float = 0.0,
        stop: Optional[StopPolicy] = None,
    ) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(
            MatchQuery(
                rid=rid, target=target, k=k, eps=eps, delta=delta,
                submit_time=time.perf_counter(), qtype=qtype, gap=gap, stop=stop,
            )
        )
        if self.telemetry is not None:
            self._c_submitted.inc(1)
            self.telemetry.tracer.emit(
                "query_enqueue", rid=rid, k=k, eps=eps, delta=delta, qtype=qtype, gap=gap,
                queued=len(self.pending),
            )
        return rid

    def _admit_free(self, _sched: Optional[SharedCountsScheduler] = None) -> None:
        """Fill free slots from the queue (the scheduler's on_round hook)."""
        while self.pending and self.scheduler.free_slots:
            q = self.pending.popleft()
            qid = self.scheduler.admit(
                q.target, k=q.k, eps=q.eps, delta=q.delta, qtype=q.qtype, gap=q.gap,
                stop=q.stop,
            )
            self._rid_of_qid[qid] = q.rid
            self._qid_of_rid[q.rid] = qid
            self._submit_time[q.rid] = q.submit_time
        self._collect()

    def _collect(self) -> None:
        """Turn freshly retired scheduler outcomes into MatchResults."""
        for qid, out in list(self.scheduler.outcomes.items()):
            rid = self._rid_of_qid.pop(qid, None)
            if rid is None:
                continue  # already collected
            self._qid_of_rid.pop(rid, None)
            del self.scheduler.outcomes[qid]
            res = self.results[rid] = self._to_result(rid, out)
            if out.anytime is not None:
                out.anytime.result = res
                self._anytime[rid] = out.anytime
            self._retired_since_save += 1
            if self.telemetry is not None:
                # the rid <-> qid join: query_enqueue carries the request id,
                # the scheduler's admit and retire events the qid
                self.telemetry.tracer.emit(
                    "query_done", rid=rid, qid=qid, exact=res.exact, tuples=res.tuples_read,
                    wall_s=res.wall_time_s,
                )
        self._maybe_autosave()

    def _to_result(self, rid: int, out: QueryOutcome) -> MatchResult:
        return MatchResult(
            ids=out.ids,
            state=out.state,
            rounds=out.rounds,
            blocks_read=out.blocks_read,
            blocks_considered=out.blocks_considered,
            tuples_read=out.tuples_read,
            wall_time_s=time.perf_counter() - self._submit_time.pop(rid),
            exact=out.exact,
            passes=out.passes,
            degraded=out.degraded,
            eps_effective=out.eps_effective,
            qtype=out.qtype,
            stopped=out.stopped,
            stop_reason=out.stop_reason,
        )

    # -- warm-start persistence ----------------------------------------------

    def _maybe_autosave(self) -> None:
        """The autosave cadence, checked at retirement and poll boundaries
        (from `_collect`), never inside the window loop."""
        if self._manager is None:
            return
        if self.autosave_every and self._retired_since_save >= self.autosave_every:
            self.save_cache()
            return
        if self.autosave_rounds:
            # the round counter's host mirror, fresh as of the last poll
            if self.scheduler.rounds - self._rounds_at_save >= self.autosave_rounds:
                self.save_cache()

    def save_cache(self) -> pathlib.Path:
        """Persist the warm cache crash-atomically; returns the step dir.

        The step is the round counter, so steps grow across restarts; a
        save with no new rounds since the newest step takes the next step
        instead of rewriting the one LATEST points at."""
        if self._manager is None:
            raise RuntimeError("MatchServer was constructed without checkpoint_dir")
        snap = _on_disk(self.scheduler.export_cache())
        step = int(snap.rounds)
        newest = self._manager.latest_step()
        if newest is not None and step <= newest:
            step = newest + 1
        path = self._manager.save(snap, step)
        self._retired_since_save = 0
        self._rounds_at_save = step
        return path

    def restore_cache(self, step: Optional[int] = None) -> None:
        """Adopt the newest verified snapshot (or ``step``) from
        ``checkpoint_dir``, written by either package. A snapshot of
        another layout or spec is refused with ValueError through the
        config hash; none at all raises FileNotFoundError."""
        if self._manager is None:
            raise RuntimeError("MatchServer was constructed without checkpoint_dir")
        snap = self._manager.restore(self.scheduler.export_cache(), step=step)
        self.scheduler.import_cache(snap)
        self._retired_since_save = 0
        self._rounds_at_save = self.scheduler.rounds
        self._pass_order = None  # step()'s cursor rebuilds from the restored mask

    @classmethod
    def restore(
        cls, dataset, *, checkpoint_dir: str, step: Optional[int] = None, **kwargs
    ) -> "MatchServer":
        """Warm construction: a server over ``dataset`` (``kwargs`` as in
        `__init__`) that adopts the newest snapshot in ``checkpoint_dir``."""
        server = cls(dataset, checkpoint_dir=checkpoint_dir, **kwargs)
        server.restore_cache(step=step)
        return server

    # -- serving loop ------------------------------------------------------

    def step(self) -> None:
        """Admit + one window + retire: the unit of incremental serving.

        Keeps `pump`'s cyclic pass structure: a pass visits every unread,
        unquarantined block window by window; when a whole pass reads
        nothing for the live queries (or no such block is left), they are
        completed exactly.
        """
        self._admit_free()
        sched = self.scheduler
        if not sched.tickets:
            return
        if self._pass_order is None or self._pass_pos >= len(self._pass_order):
            unread = sched.order[~sched.read_mask[sched.order] & ~sched.quarantined[sched.order]]
            # a zero-read pass proves sampling exhausted only for the
            # queries live during it: a query admitted in its final
            # windows gets a fresh pass first
            fresh = any(t.admit_rounds >= self._pass_start_rounds for t in sched.tickets.values())
            stalled = self._pass_order is not None and self._pass_read == 0 and not fresh
            if unread.size == 0 or stalled:
                sched.complete_remaining()
                du = sched._delta_upper  # fresh: complete_remaining polls
                for slot in list(sched.tickets):
                    fired = bool(du[slot] < sched.tickets[slot].delta)
                    sched.retire(slot, exact=True, terminated=fired)
                self._pass_order = None
                self._collect()
                return
            self._pass_order = unread
            self._pass_pos = 0
            self._pass_read = 0
            self._pass_start_rounds = sched.rounds
            sched.passes += 1
        win = self._pass_order[self._pass_pos : self._pass_pos + sched.window]
        self._pass_pos += len(win)
        # blocks read or quarantined since this pass was planned (a
        # run_until_idle in between) are skipped
        win = win[~sched.read_mask[win] & ~sched.quarantined[win]]
        if win.size:
            self._pass_read += sched.run_window(win)
            sched._poll_terminated()
        self._collect()

    def run_until_idle(self, *, max_rounds: int = 1_000_000) -> Dict[int, MatchResult]:
        """Drain the queue: serve until every submitted query has a result."""
        self._pass_order = None  # invalidate step()'s cursor
        while self.pending or self.scheduler.tickets:
            self._admit_free()
            if not self.scheduler.tickets:
                break
            self.scheduler.pump(
                max_rounds=max_rounds, max_passes=self.max_passes, on_round=self._admit_free
            )
            if self.scheduler.budget_exhausted:
                # a query admitted in the budget's last round may already
                # hold its bound on the warm counts
                self.scheduler._poll_terminated()
                for slot in list(self.scheduler.tickets):
                    self.scheduler.retire(slot, exact=False, terminated=False)
            self._collect()
        return dict(self.results)

    # -- anytime API -------------------------------------------------------

    def poll_result(self, rid: int) -> AnytimeAnswer:
        """The current answer for ``rid``, from host mirrors only.

        status="live": the best set so far with its statement
        (`SharedCountsScheduler.peek` of the last poll). "queued": a
        vacuous statement (delta_upper=1, empty set). "done": the final
        statement of the retirement poll, ``.result`` the `MatchResult`.
        Unknown request ids raise KeyError.
        """
        self._collect()
        if rid in self._anytime:
            return self._anytime[rid]
        if rid in self.results:
            return answer_from_result(self.results[rid], metric=self.spec.metric)
        qid = self._qid_of_rid.get(rid)
        if qid is not None:
            sched = self.scheduler
            for slot, t in sched.tickets.items():
                if t.qid == qid:
                    return sched.peek(slot)
        for q in self.pending:
            if q.rid == rid:
                return AnytimeAnswer(
                    qid=-1, qtype=q.qtype, status="queued",
                    ids=np.zeros(0, np.int64), tau=np.zeros(0, np.float32),
                    margin=np.zeros(0, np.float32), split=float("nan"),
                    n_min=0.0, tau_min=float("nan"), eps_n=float("inf"),
                    delta_upper=1.0, confidence=0.0,
                    round=self.scheduler.rounds,
                    tuples=self.scheduler.tuples_read, tuples_live=0,
                    eps=q.eps, delta=q.delta, metric=self.spec.metric,
                )
        raise KeyError(f"unknown request id {rid}")

    def iter_results(self, rid: int, *, max_steps: int = 100_000):
        """Stream refining answers for ``rid``: drives `step()` between
        polls (other queries advance too) and yields an answer whenever
        the statement changes, ending with the ``status="done"`` one.
        ``max_steps`` bounds the drive; the query keeps its slot."""
        last = None
        for _ in range(max_steps):
            ans = self.poll_result(rid)
            key = (ans.status, ans.round, ans.delta_upper, ans.ids.tobytes())
            if key != last:
                last = key
                yield ans
            if ans.status == "done":
                return
            self.step()
        ans = self.poll_result(rid)
        if ans.status == "done":
            yield ans

    # -- observability -----------------------------------------------------

    @property
    def metrics(self) -> Dict[str, object]:
        sched = self.scheduler
        done = len(self.results)
        return {
            "queries_done": done,
            "queries_queued": len(self.pending),
            "queries_live": sched.num_live,
            "queries_pending": len(self.pending) + sched.num_live,
            "total_blocks_read": sched.blocks_read,
            "total_tuples_read": sched.tuples_read,
            "total_rounds": sched.rounds,
            "fraction_read": float(sched.read_mask.mean()) if sched.read_mask.size else 0.0,
            "tuples_per_query": float(sched.tuples_read / done) if done else 0.0,
            # the health surface: "" / 0 / False on a healthy server
            "last_error": self.last_error,
            "queries_shed": self.queries_shed,
            "blocks_quarantined": sched.blocks_quarantined,
            "degraded": sched.blocks_quarantined > 0,
            "eps_inflation": float(sched.eps_inflation),
        }

    def export_trace(self, path) -> int:
        """Write the lifecycle and round trace as JSONL; returns the event count."""
        if self.telemetry is None:
            raise RuntimeError("MatchServer was constructed without telemetry")
        self.scheduler.flush_telemetry()
        return self.telemetry.tracer.export_jsonl(path)

    def prometheus_metrics(self) -> str:
        """The registry in Prometheus text exposition format."""
        if self.telemetry is None:
            raise RuntimeError("MatchServer was constructed without telemetry")
        self.scheduler.flush_telemetry()
        return self.telemetry.registry.to_prometheus()
