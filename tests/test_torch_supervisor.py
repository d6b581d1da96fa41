"""The port's `ServeSupervisor` against the JAX reference's.

Twins of tests/test_supervisor.py on its fixture (120K tuples, V_Z = 32,
V_X = 16), on the CPU: killed mid-round by an injected unrecoverable
fault, the supervisor restores the autosaved snapshot, re-submits and
answers as a run that never crashed, and as the reference's supervisor
under the same fault plan (the same restarts, and results within the
tolerance contract); cold recovery without a checkpoint directory; the
restart bound; overload shedding, deadlines while queued and while
live, the default deadline, and the merged metrics. Under
``telemetry=True`` one `repro_torch.obs.Telemetry` outlives the rebuilds
and counts the crash, the recovery and the shed requests, with the
reference's ``serve_*`` counters and events.
"""

import time

import numpy as np
import pytest
import torch

from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.io import InMemorySource as JSource
from repro.io import faults as jfaults
from repro.serve import ServeSupervisor as JSupervisor
from repro.serve import SupervisorPolicy as JPolicy
from repro_torch import convert
from repro_torch.io import InMemorySource
from repro_torch.io.faults import (
    FaultPlan,
    FaultySource,
    ResilientSource,
    RetryPolicy,
    UnrecoverableIOError,
)
from repro_torch.obs import Telemetry
from repro_torch.serve import ServeSupervisor, SupervisorPolicy

TAU_ATOL = 2e-5
K, EPS, DELTA = 5, 0.08, 0.05
SERVER_KW = dict(max_queries=2, lookahead=64, poll_every=2, seed=11)


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(v_z=32, v_x=16, num_tuples=120_000, k=K, n_close=5,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=3)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=5)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return ds, blocked, ported


@pytest.fixture(scope="module")
def targets(dataset):
    ds, _, _ = dataset
    rng = np.random.default_rng(9)
    return [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.04, 0.1)]


def _host(ported):
    return InMemorySource(ported, device_resident=False, device="cpu")


def _chaos_source(ported, *, crash_at=None, seed=0):
    return ResilientSource(
        FaultySource(_host(ported), FaultPlan(crash_at=crash_at), seed=seed),
        policy=RetryPolicy(max_retries=2, backoff_s=0.0005),
    )


def _ref_chaos_source(blocked, *, crash_at=None, seed=0):
    return jfaults.ResilientSource(
        jfaults.FaultySource(JSource(blocked, device_resident=False),
                             jfaults.FaultPlan(crash_at=crash_at), seed=seed),
        policy=jfaults.RetryPolicy(max_retries=2, backoff_s=0.0005),
    )


def _supervise(sup, targets):
    rids = [sup.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
    res = sup.run_until_idle()
    return [res[r] for r in rids]


def _assert_same_result(got, want):
    for f in ("ids", "rounds", "passes", "blocks_read", "tuples_read", "exact", "degraded",
              "eps_effective", "stopped", "stop_reason"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_allclose(got.state.tau.numpy(), np.asarray(want.state.tau), atol=TAU_ATOL)
    np.testing.assert_allclose(got.delta_upper, want.delta_upper, rtol=1e-5, atol=1e-12)


class TestCrashRecovery:
    def test_kill_mid_round_recovers_bit_identical(self, dataset, targets, tmp_path):
        """Crash at fetch attempt 2: the supervisor restores the autosaved
        snapshot, re-queues and completes, with the answers of the run
        that never crashed and of the reference's supervisor."""
        _, blocked, ported = dataset
        clean_sup = ServeSupervisor(_chaos_source(ported), checkpoint_dir=tmp_path / "clean",
                                    autosave_rounds=2, device="cpu", **SERVER_KW)
        clean = _supervise(clean_sup, targets)
        assert clean_sup.restarts == 0

        sup = ServeSupervisor(_chaos_source(ported, crash_at=2),
                              policy=SupervisorPolicy(max_restarts=2),
                              checkpoint_dir=tmp_path / "crash", autosave_rounds=2,
                              telemetry=True, device="cpu", **SERVER_KW)
        tel = sup.telemetry
        got = _supervise(sup, targets)
        assert sup.restarts == 1 and "UnrecoverableIOError" in sup.last_error
        assert sup.server.telemetry is tel  # one handle across the rebuild
        # the wounded scheduler was flushed and let go
        assert tel._flush_hooks == [sup.server.scheduler.flush_telemetry]
        reg = tel.registry
        assert reg.get("serve_crashes_total").value == 1
        assert reg.get("serve_recoveries_total").value == 1
        assert reg.get("serve_recovery_seconds").count == 1
        (crash_ev,) = tel.tracer.events("serve_crash")
        assert "UnrecoverableIOError" in crash_ev["error"]
        (rec_ev,) = tel.tracer.events("serve_recovered")
        assert rec_ev["resubmitted"] >= 1 and rec_ev["recovery_s"] > 0.0
        assert sup.unresolved == 0 and sup.recovery_s_total > 0.0
        for a, b in zip(got, clean):
            np.testing.assert_array_equal(a.ids, b.ids)

        jsup = JSupervisor(_ref_chaos_source(blocked, crash_at=2),
                           policy=JPolicy(max_restarts=2), checkpoint_dir=tmp_path / "ref",
                           autosave_rounds=2, telemetry=True, **SERVER_KW)
        want = _supervise(jsup, targets)
        assert jsup.restarts == 1
        for kind in ("serve_crash", "serve_recovered", "checkpoint_save", "query_enqueue"):
            got_ev = [{k: v for k, v in e.items() if k not in ("seq", "recovery_s")}
                      for e in tel.tracer.skeleton(kind)]
            want_ev = [{k: v for k, v in e.items() if k not in ("seq", "recovery_s")}
                       for e in jsup.telemetry.tracer.skeleton(kind)]
            assert got_ev == want_ev, kind
        for a, b in zip(got, want):
            _assert_same_result(a, b)
        assert sorted(p.name for p in (tmp_path / "crash").glob("step_*")) == sorted(
            p.name for p in (tmp_path / "ref").glob("step_*"))
        m = sup.metrics
        assert m["restarts"] == 1 and m["recovery_s_total"] > 0.0
        assert "UnrecoverableIOError" in m["last_error"]
        assert m["total_tuples_read"] == jsup.metrics["total_tuples_read"]

    def test_recovery_keeps_the_dataset_object(self, dataset, targets, tmp_path):
        """A rebuild reuses the source it was given (a resident table is
        not uploaded again) and drops the wounded server."""
        _, _, ported = dataset
        source = _chaos_source(ported, crash_at=2)
        sup = ServeSupervisor(source, checkpoint_dir=tmp_path, autosave_rounds=2, device="cpu",
                              **SERVER_KW)
        first = sup.server
        _supervise(sup, targets[:2])
        assert sup.restarts == 1 and sup.server is not first
        assert sup.server.scheduler.source is source

    def test_cold_recovery_without_checkpoint_dir(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_chaos_source(ported, crash_at=2),
                              policy=SupervisorPolicy(max_restarts=1), device="cpu", **SERVER_KW)
        got = _supervise(sup, targets[:2])
        assert sup.restarts == 1
        plain = _supervise(ServeSupervisor(_chaos_source(ported), device="cpu", **SERVER_KW),
                           targets[:2])
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a.ids, b.ids)

    def test_max_restarts_exhausted_reraises(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_chaos_source(ported, crash_at=2),
                              policy=SupervisorPolicy(max_restarts=0), device="cpu", **SERVER_KW)
        sup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        with pytest.raises(UnrecoverableIOError):
            sup.run_until_idle()
        assert sup.restarts == 1


class TestSheddingAndDeadlines:
    def test_overload_sheds_at_the_door(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_host(ported), policy=SupervisorPolicy(max_queue=1),
                              max_queries=1, lookahead=64, poll_every=2, seed=11, device="cpu",
                              telemetry=True)
        rids = [sup.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
        res = sup.run_until_idle()
        shed = [r for r in rids if r in sup.shed]
        assert shed and sup.shed[shed[0]] == "overload"
        assert len([r for r in rids if r in res]) + len(shed) == len(rids)
        assert sup.metrics["queries_shed"] == len(shed)
        assert sup.server.metrics["queries_shed"] == len(shed)
        assert sup.telemetry.registry.get("serve_queries_shed_total").value == len(shed)
        assert [e["rid"] for e in sup.telemetry.tracer.events("query_shed")] == shed
        assert {e["reason"] for e in sup.telemetry.tracer.events("query_shed")} == {"overload"}

    def test_queued_query_shed_at_deadline(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_host(ported), device="cpu", **SERVER_KW)
        ok = sup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        late = sup.submit(targets[1], k=K, eps=EPS, delta=DELTA, deadline_s=0.0)
        res = sup.run_until_idle()
        assert sup.shed[late] == "deadline" and late not in res
        assert ok in res and len(res[ok].ids) == K
        with pytest.raises(KeyError, match="shed"):
            sup.poll_result(late)

    def test_live_query_early_retired_at_deadline(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_host(ported), max_queries=2, lookahead=16, poll_every=2, seed=11,
                              device="cpu", telemetry=True)
        rid = sup.submit(targets[2], k=K, eps=EPS, delta=DELTA)
        sup.server.step()
        assert sup.server.scheduler.tickets
        sup._requests[rid].deadline = time.monotonic() - 1.0
        res = sup.run_until_idle()
        assert rid in res and rid not in sup.shed
        assert res[rid].exact is False and len(res[rid].ids) == K
        (ev,) = sup.telemetry.tracer.events("query_deadline_retire")
        assert ev["rid"] == rid and ev["qid"] == 0
        (retire,) = sup.telemetry.tracer.events("query_retire")
        assert retire["stopped"] and retire["stop_reason"] == "deadline"
        assert res[rid].stopped and res[rid].stop_reason == "deadline"
        assert sup.poll_result(rid).status == "done"

    def test_default_deadline_from_policy(self, dataset, targets):
        _, _, ported = dataset
        sup = ServeSupervisor(_host(ported), policy=SupervisorPolicy(default_deadline_s=0.0),
                              max_queries=2, lookahead=64, seed=11, device="cpu")
        rid = sup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        sup.run_until_idle()
        assert sup.shed[rid] == "deadline"

    def test_metrics_surface_merges_server_and_supervisor(self, dataset, targets):
        _, blocked, ported = dataset
        sup = ServeSupervisor(_host(ported), device="cpu", **SERVER_KW)
        sup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        sup.run_until_idle()
        jsup = JSupervisor(JSource(blocked, device_resident=False), **SERVER_KW)
        jsup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        jsup.run_until_idle()
        m, jm = sup.metrics, jsup.metrics
        assert sorted(m) == sorted(jm)
        jm["recovery_s_total"] = m["recovery_s_total"] = 0.0
        assert m == pytest.approx(jm)
        assert m["queries_done"] == 1 and m["restarts"] == 0

    def test_telemetry_refused(self, dataset, targets):
        """``telemetry=True`` makes one handle on the servers' device that
        the server records into; a handle passed in is adopted as it is;
        a request queued past its deadline is counted as shed."""
        _, _, ported = dataset
        sup = ServeSupervisor(_host(ported), telemetry=True, device="cpu", **SERVER_KW)
        tel = sup.telemetry
        assert tel.registry.device == torch.device("cpu") and sup.server.telemetry is tel
        ok = sup.submit(targets[0], k=K, eps=EPS, delta=DELTA)
        late = sup.submit(targets[1], k=K, eps=EPS, delta=DELTA, deadline_s=0.0)
        res = sup.run_until_idle()
        assert ok in res and sup.shed[late] == "deadline"
        assert tel.registry.get("serve_queries_shed_total").value == 1
        assert [(e["rid"], e["reason"]) for e in tel.tracer.events("query_shed")] == [
            (late, "deadline")]
        assert tel.registry.get("fastmatch_queries_retired_total").value == 1
        assert tel.registry.get("serve_crashes_total").value == 0
        mine = Telemetry(device="cpu")
        assert ServeSupervisor(_host(ported), telemetry=mine, device="cpu",
                               **SERVER_KW).server.telemetry is mine


def test_outcome_tuples_match_on_the_device_the_server_runs(dataset, targets):
    """A host-resident source hands over host windows; the scheduler
    moves each to its device once, and the answers do not change."""
    _, _, ported = dataset
    sups = [ServeSupervisor(src, device="cpu", **SERVER_KW)
            for src in (_host(ported), InMemorySource(ported, device="cpu"))]
    a, b = (_supervise(s, targets) for s in sups)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.ids, y.ids)
        assert torch.equal(x.state.counts, y.state.counts) and x.tuples_read == y.tuples_read
