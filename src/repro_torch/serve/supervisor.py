"""Crash recovery and QoS supervision of a `MatchServer` loop.

Port of `repro.serve.supervisor`. `MatchServer` owns the answers'
correctness; `ServeSupervisor` owns the service's liveness. It wraps the
incremental loop (`MatchServer.step`) with three policies:

  per-query deadlines — a request still queued at its deadline is shed
      (it spent no I/O); a live one is retired early with its current
      best-effort answer (``exact=False``, ``stop_reason="deadline"``)
  overload shedding — with ``max_queue`` requests waiting, a new one is
      shed at the door and listed in ``shed`` with its reason
  crash recovery — a round that fails with anything a retry cannot heal
      (`io.faults.UnrecoverableIOError`, ...) discards the wounded
      server, builds a new one, restores the newest verified snapshot
      and re-submits every incomplete request. Sampling is
      target-independent, so a re-submitted query starts from the
      restored counts with its full ``n_i``: it loses the rounds since
      the snapshot, never its statistical position.

Rebuilds reuse the dataset object the supervisor was given: pass a
resident `InMemorySource` so a rebuild uploads nothing. Every reference
to the wounded server, the failed call's frames included, is dropped
before the new one allocates. The supervisor's request ids stay stable
across rebuilds; ``results`` and ``shed`` are keyed by them.

Every decision is observable through one `repro_torch.obs.Telemetry`
shared by every server the supervisor builds (``telemetry=True`` makes
it, on the servers' device): the ``serve_crashes_total``,
``serve_recoveries_total`` and ``serve_queries_shed_total`` counters, the
``serve_recovery_seconds`` histogram, and the ``serve_crash``,
``serve_recovered``, ``query_shed`` and ``query_deadline_retire`` events.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import traceback
from typing import Dict, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.engine import MatchResult
from repro_torch.obs import Telemetry
from repro_torch.serve.fastmatch_server import (
    AnytimeAnswer,
    MatchServer,
    StopPolicy,
    answer_from_result,
)

__all__ = ["ServeSupervisor", "SupervisorPolicy"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """Liveness knobs. ``max_restarts`` bounds crash recoveries per
    supervisor (the next crash propagates with its exception);
    ``max_queue`` bounds the server's queue (None: unbounded);
    ``default_deadline_s`` applies to submissions that set none."""

    max_restarts: int = 3
    restart_backoff_s: float = 0.0
    max_queue: Optional[int] = None
    default_deadline_s: Optional[float] = None


@dataclasses.dataclass
class _Request:
    """One supervised request across server rebuilds."""

    rid: int  # supervisor rid
    target: np.ndarray
    k: int
    eps: float
    delta: float
    deadline: Optional[float]  # absolute monotonic time, None = none
    submit_time: float
    stop: Optional[StopPolicy] = None  # SLA stop policy, survives rebuilds
    server_rid: Optional[int] = None  # rid on the current server


class ServeSupervisor:
    """Run a `MatchServer` with deadlines, shedding and crash recovery.

    ``server_kwargs`` are `MatchServer`'s and are replayed on every
    rebuild; with ``checkpoint_dir`` recovery is warm (it restores the
    newest verified snapshot), without it cold but still lossless.
    """

    def __init__(self, dataset, *, policy: SupervisorPolicy = SupervisorPolicy(),
                 **server_kwargs):
        self.policy = policy
        self._dataset = dataset
        self._server_kwargs = dict(server_kwargs)
        # one telemetry handle across rebuilds: a crash must not reset the
        # counters that count crashes
        tel = self._server_kwargs.get("telemetry")
        if tel is True:
            device = (getattr(dataset, "device", None)
                      or resolve_device(self._server_kwargs.get("device")))
            tel = Telemetry(device=device)
            self._server_kwargs["telemetry"] = tel
        self.telemetry = tel or None
        if self.telemetry is not None:
            reg = self.telemetry.registry
            self._c_crashes = reg.counter(
                "serve_crashes_total", "unrecoverable serving-loop failures")
            self._c_recoveries = reg.counter(
                "serve_recoveries_total", "successful crash recoveries")
            self._c_shed = reg.counter(
                "serve_queries_shed_total", "requests shed (overload or deadline)")
            self._h_recovery = reg.histogram(
                "serve_recovery_seconds", help="crash-to-serving recovery wall time")
        self.restarts = 0
        self.last_error = ""
        self.recovery_s_total = 0.0
        self.results: Dict[int, MatchResult] = {}
        self.shed: Dict[int, str] = {}  # rid -> reason
        self._requests: Dict[int, _Request] = {}
        self._next_rid = 0
        self.server = self._build_server()

    # -- server lifecycle --------------------------------------------------

    def _build_server(self) -> MatchServer:
        """A server on the newest snapshot, if one is on disk."""
        server = MatchServer(self._dataset, **self._server_kwargs)
        if server._manager is not None:
            try:
                server.restore_cache()
            except FileNotFoundError:
                pass  # nothing on disk yet: a cold start
        server.last_error = self.last_error
        server.queries_shed = len(self.shed)
        return server

    def _recover(self, exc: BaseException) -> None:
        self.restarts += 1
        self.last_error = repr(exc)
        logger.warning("serving loop crashed (%r); recovery %d/%d",
                       exc, self.restarts, self.policy.max_restarts)
        if self.telemetry is not None:
            self._c_crashes.inc(1)
            self.telemetry.tracer.emit("serve_crash", error=repr(exc), restarts=self.restarts)
        if self.restarts > self.policy.max_restarts:
            raise exc
        if self.policy.restart_backoff_s:
            time.sleep(self.policy.restart_backoff_s)
        t0 = time.perf_counter()
        # after a failure mid-round the wounded server's mirrors and pass
        # cursor are not to be trusted: drop it, and the finished frames
        # of the failed call (whose locals hold its scheduler and
        # windows), before the new server allocates
        traceback.clear_frames(exc.__traceback__)
        if self.telemetry is not None:
            self.telemetry.remove_flush_hook(self.server.scheduler.flush_telemetry)
        self.server = None
        self.server = self._build_server()
        resubmitted = 0
        for req in self._requests.values():
            if req.rid in self.results or req.rid in self.shed:
                continue
            req.server_rid = self.server.submit(
                req.target, k=req.k, eps=req.eps, delta=req.delta, stop=req.stop
            )
            resubmitted += 1
        recovery_s = time.perf_counter() - t0
        self.recovery_s_total += recovery_s
        if self.telemetry is not None:
            self._c_recoveries.inc(1)
            self._h_recovery.observe(recovery_s)
            self.telemetry.tracer.emit(
                "serve_recovered", recovery_s=recovery_s,
                resumed_step=self.server.scheduler.rounds, resubmitted=resubmitted,
            )

    # -- requests ----------------------------------------------------------

    def submit(self, target, *, k: int, eps: float = 0.06, delta: float = 0.01,
               deadline_s: Optional[float] = None,
               stop: Optional[StopPolicy] = None) -> int:
        """Queue a supervised top-k query; returns a supervisor rid
        resolved in ``results`` (answered) or ``shed`` (refused or
        expired). ``stop`` is carried across rebuilds; a deadline and a
        stop compose (whichever fires first retires the query)."""
        rid = self._next_rid
        self._next_rid += 1
        if deadline_s is None:
            deadline_s = self.policy.default_deadline_s
        now = time.monotonic()
        req = _Request(
            rid=rid, target=np.asarray(target, np.float64).ravel(), k=k, eps=eps, delta=delta,
            deadline=None if deadline_s is None else now + deadline_s,
            submit_time=now, stop=stop,
        )
        self._requests[rid] = req
        if self.policy.max_queue is not None and len(self.server.pending) >= self.policy.max_queue:
            self._shed(req, "overload")
            return rid
        req.server_rid = self.server.submit(target, k=k, eps=eps, delta=delta, stop=stop)
        return rid

    def _shed(self, req: _Request, reason: str) -> None:
        self.shed[req.rid] = reason
        self.server.queries_shed = len(self.shed)
        if self.telemetry is not None:
            self._c_shed.inc(1)
            self.telemetry.tracer.emit("query_shed", rid=req.rid, reason=reason)

    def _enforce_deadlines(self) -> None:
        now = time.monotonic()
        expired = [
            r for r in self._requests.values()
            if r.deadline is not None and now >= r.deadline
            and r.rid not in self.results and r.rid not in self.shed
        ]
        if not expired:
            return
        server = self.server
        sched = server.scheduler
        queued = {q.rid: q for q in server.pending}
        qid_by_srv_rid = {srv_rid: qid for qid, srv_rid in server._rid_of_qid.items()}
        retired_any = False
        for req in expired:
            if req.server_rid in queued:
                # never admitted: no I/O spent, nothing to answer
                server.pending = type(server.pending)(
                    q for q in server.pending if q.rid != req.server_rid
                )
                server._submit_time.pop(req.server_rid, None)
                self._shed(req, "deadline")
            elif req.server_rid in qid_by_srv_rid:
                # live: retire early with the current best-effort answer
                qid = qid_by_srv_rid[req.server_rid]
                slot = next(s for s, t in sched.tickets.items() if t.qid == qid)
                if not retired_any:
                    sched._sync()  # fresh mirrors: retire() reads them
                    retired_any = True
                fired = bool(sched._delta_upper[slot] < sched.tickets[slot].delta)
                sched.retire(slot, exact=False, terminated=fired, stopped=True,
                             stop_reason="deadline")
                if self.telemetry is not None:
                    self.telemetry.tracer.emit("query_deadline_retire", rid=req.rid, qid=qid)
            # else: resolved between the scan and here
        if retired_any:
            server._collect()

    def _collect(self) -> None:
        """Map newly finished server results to supervisor rids."""
        srv_results = self.server.results
        for req in self._requests.values():
            if req.rid in self.results or req.rid in self.shed:
                continue
            if req.server_rid is not None and req.server_rid in srv_results:
                self.results[req.rid] = srv_results[req.server_rid]

    def poll_result(self, rid: int) -> AnytimeAnswer:
        """The current anytime answer of supervisor request ``rid``. A shed
        or unknown request raises KeyError; one resolved before a rebuild
        is answered from its stored `MatchResult`."""
        if rid in self.shed:
            raise KeyError(f"request {rid} was shed ({self.shed[rid]})")
        req = self._requests[rid]
        if rid in self.results:
            ans = self.server._anytime.get(req.server_rid)
            if ans is not None and ans.result is self.results[rid]:
                return ans
            return answer_from_result(self.results[rid], metric=self.server.spec.metric)
        return self.server.poll_result(req.server_rid)

    # -- the supervised loop -----------------------------------------------

    @property
    def unresolved(self) -> int:
        return len(self._requests) - len(self.results) - len(self.shed)

    def run_until_idle(self, *, max_steps: int = 1_000_000) -> Dict[int, MatchResult]:
        """Drive `MatchServer.step` until every supervised request is
        answered or shed, recovering from crashes on the way."""
        steps = 0
        while self.unresolved:
            self._enforce_deadlines()
            self._collect()
            if not self.unresolved:
                break
            try:
                self.server.step()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:
                self._recover(exc)
            self._collect()
            steps += 1
            if steps >= max_steps:
                break
        return dict(self.results)

    # -- observability -----------------------------------------------------

    @property
    def metrics(self) -> Dict[str, object]:
        m = dict(self.server.metrics)
        m.update(
            restarts=self.restarts,
            recovery_s_total=self.recovery_s_total,
            queries_shed=len(self.shed),
            last_error=self.last_error or m.get("last_error", ""),
        )
        return m
