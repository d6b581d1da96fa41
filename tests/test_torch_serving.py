"""The port's `MatchServer` against the JAX reference's, twin by twin.

Each twin drives the reference server and the port's (on the CPU,
through the kernels' plain versions) with the same requests on the
same numpy-seeded dataset, carried over by `convert.dataset_from_numpy`,
and asserts equal ids, rounds, passes, blocks, tuples, ``exact``,
``stopped`` and ``stop_reason`` (``terminated`` where the scheduler's
outcome carries it), the counts bitwise and tau within 2e-5. The twins
are the port of tests/test_multiquery.py (server equivalence, outcome
accounting, slot masking), tests/test_metrics.py::TestMixedServe,
tests/test_anytime.py (stop == poll, the stream ends at the blocking
answer, sound pruning) and tests/test_device_loop.py::TestGoldenEquivalence
(the port's fused loop against the reference's host-stepped golden
loop). Only `StopPolicy(tuples=...)` and ``confidence`` stops are held
across packages: a wall-clock stop depends on time.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import multiquery as jmq
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import histsim as thistsim
from repro_torch.core import multiquery as tmq
from repro_torch.kernels import metrics as tmetrics
from repro_torch.serve import MatchServer
from repro_torch.serve import fastmatch_server as tserver

TAU_ATOL = 2e-5
K, EPS, DELTA = 5, 0.08, 0.05
RESULT_FIELDS = (
    "ids", "rounds", "passes", "blocks_read", "blocks_considered", "tuples_read", "exact",
    "stopped", "stop_reason", "qtype",
)
OUTCOME_FIELDS = (
    "ids", "rounds", "passes", "blocks_read", "blocks_considered", "tuples_read", "exact",
    "terminated", "stopped", "stop_reason", "qtype",
)


@dataclasses.dataclass
class Side:
    """One package's side of a twin: its server, scheduler and stop
    policy, and the dataset in its form."""

    name: str
    Server: type
    Scheduler: type
    Spec: type
    Stop: type
    data: object

    def server(self, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.Server(self.data, **kw)

    def scheduler(self, spec_kw: dict, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.Scheduler(self.data, self.Spec(**spec_kw), **kw)


def _sides(blocked, ported) -> tuple:
    ref = Side("ref", JServer, jmq.SharedCountsScheduler, jmq.MultiQuerySpec, jmq.StopPolicy,
               blocked)
    port = Side("port", MatchServer, tmq.SharedCountsScheduler, tmq.MultiQuerySpec,
                tmq.StopPolicy, ported)
    return ref, port


def _twin(fn, sides):
    """Run ``fn(side)`` on both packages: (port's result, reference's)."""
    ref, port = sides
    return fn(port), fn(ref)


def _data(spec: SynthSpec, rng_seed: int, dists) -> tuple:
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=spec.seed)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    rng = np.random.default_rng(rng_seed)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in dists]
    return ds, _sides(blocked, ported), targets


def _assert_same(got, want, fields=RESULT_FIELDS, msg=""):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f"{f} {msg}"
        )
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_allclose(
        got.state.tau.numpy(), np.asarray(want.state.tau), atol=TAU_ATOL, err_msg=msg
    )
    np.testing.assert_allclose(
        got.delta_upper, want.delta_upper, rtol=1e-5, atol=1e-12, err_msg=msg
    )


def _assert_same_results(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for rid in want:
        _assert_same(got[rid], want[rid], msg=f"rid {rid}")


def _tiny(num_tuples):
    spec = SynthSpec(v_z=30, v_x=8, num_tuples=num_tuples, k=3, n_close=3, seed=11)
    return _data(spec, 0, ())


# ---------------------------------------------------------------------------
# tests/test_multiquery.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mq_data():
    spec = SynthSpec(
        v_z=64, v_x=16, num_tuples=300_000, k=K, n_close=5,
        close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=5,
    )
    return _data(spec, 9, (0.01, 0.03, 0.05))


class TestServerEquivalence:
    def test_matches_independent_engines(self, mq_data):
        _, sides, targets = mq_data

        def serve(side):
            server = side.server(max_queries=len(targets), lookahead=512, seed=100)
            for t in targets:
                server.submit(t, k=K, eps=EPS, delta=DELTA)
            return server.run_until_idle(), server.metrics["total_tuples_read"]

        (got, shared), (want, ref_shared) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert shared == ref_shared
        params = thistsim.HistSimParams(v_z=64, v_x=16, k=K, eps=EPS, delta=DELTA)
        solo = [
            tengine.run_engine(sides[1].data, t, params,
                               tengine.EngineConfig(variant="fastmatch", seed=100 + i),
                               device="cpu")
            for i, t in enumerate(targets)
        ]
        assert shared < sum(r.tuples_read for r in solo)
        for i, r in enumerate(got.values()):
            assert sorted(r.ids.tolist()) == sorted(solo[i].ids.tolist()), i
            assert r.exact or r.delta_upper < DELTA

    def test_more_queries_than_slots_queue_up(self, mq_data):
        _, sides, targets = mq_data
        keys = ("queries_queued", "queries_live", "queries_pending", "queries_done")

        def serve(side):
            server = side.server(max_queries=2, lookahead=256, seed=3)
            for t in targets:
                server.submit(t, k=K, eps=EPS, delta=DELTA)
            before = {k: server.metrics[k] for k in keys}
            results = server.run_until_idle()
            return results, before, server.metrics

        (got, before, metrics), (want, ref_before, ref_metrics) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert before == ref_before == dict(
            queries_queued=4, queries_live=0, queries_pending=4, queries_done=0
        )
        assert metrics == pytest.approx(ref_metrics)
        assert all(len(r.ids) == K for r in got.values())

    def test_late_admission_starts_from_shared_counts(self, mq_data):
        _, sides, targets = mq_data

        def serve(side):
            server = side.server(max_queries=2, lookahead=512, seed=7)
            server.submit(targets[0], k=K, eps=EPS, delta=DELTA)
            server.run_until_idle()
            warm = server.metrics["total_tuples_read"]
            late = server.submit(targets[1], k=K, eps=EPS, delta=DELTA)
            results = server.run_until_idle()
            return results, server.metrics["total_tuples_read"] - warm, late

        (got, new_io, late), (want, ref_new_io, _) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert new_io == ref_new_io
        assert got[late].tuples_read == new_io

    def test_step_driven_serving_terminates(self, mq_data):
        _, sides, targets = mq_data

        def serve(side):
            server = side.server(max_queries=2, lookahead=128, seed=0)
            rids = [server.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets[:2]]
            steps = 0
            while not all(rid in server.results for rid in rids):
                server.step()
                steps += 1
                assert steps < 10_000, "step() made no progress"
            return server.results, steps

        (got, steps), (want, ref_steps) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert steps == ref_steps
        assert all(r.exact or r.delta_upper < DELTA for r in got.values())

    def test_step_stalled_pass_falls_back_to_exact(self):
        _, sides, _ = _tiny(40_000)
        ds = make_dataset(SynthSpec(v_z=30, v_x=8, num_tuples=40_000, k=3, n_close=3, seed=11))

        def serve(side):
            server = side.server(max_queries=1, lookahead=64, seed=0)
            rid = server.submit(ds.target, k=3, eps=0.02, delta=1e-6)  # unreachable bound
            steps = 0
            while rid not in server.results:
                server.step()
                steps += 1
                assert steps < 10_000, "step() livelocked on a zero-read pass"
            return server.results, steps

        (got, steps), (want, ref_steps) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert steps == ref_steps and got[0].exact

    def test_exhausted_dataset_serves_exactly(self):
        ds, sides, _ = _tiny(20_000)

        def serve(side):
            server = side.server(max_queries=2, seed=0)
            server.submit(ds.target, k=3, eps=0.02, delta=0.001)
            server.run_until_idle()
            before = server.metrics["total_tuples_read"]
            server.submit(ds.target, k=3, eps=0.02, delta=0.001)
            server.submit(ds.target, k=3, eps=0.2, delta=0.5)  # bound fires, still exact
            results = server.run_until_idle()
            return results, server.metrics["total_tuples_read"] - before

        (got, new_io), (want, ref_new_io) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert new_io == ref_new_io == 0
        assert all(r.exact for r in got.values())
        assert sorted(got[1].ids.tolist()) == sorted(ds.true_top_k.tolist())


class TestOutcomeAccounting:
    def test_retire_before_any_window_reports_zero_passes(self, mq_data):
        _, sides, targets = mq_data

        def run(side):
            sched = side.scheduler(dict(v_z=64, v_x=16, max_queries=2), window=64, seed=0)
            q0 = sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)
            sched.pump()
            q1 = sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)  # warm: bound holds
            sched.pump()
            return sched.outcomes[q0], sched.outcomes[q1]

        got, want = _twin(run, sides)
        for g, w in zip(got, want):
            _assert_same(g, w, OUTCOME_FIELDS)
        assert got[0].passes >= 1
        assert got[1].terminated and got[1].rounds == 0 and got[1].passes == 0

    def test_mid_pass_query_counts_its_partial_pass(self, mq_data):
        _, sides, targets = mq_data

        def run(side):
            sched = side.scheduler(dict(v_z=64, v_x=16, max_queries=2), window=64, seed=0)
            qid = sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)
            sched.pump()
            return sched.outcomes[qid]

        got, want = _twin(run, sides)
        _assert_same(got, want, OUTCOME_FIELDS)
        assert got.rounds >= 1 and got.passes >= 1


class TestSlotMasking:
    def test_readmission_into_retired_slot_matches_fresh_server(self, mq_data):
        _, sides, targets = mq_data

        def serve(side):
            server = side.server(max_queries=1, lookahead=256, seed=42)
            server.submit(targets[0], k=K, eps=EPS, delta=DELTA)
            server.run_until_idle()  # slot 0 retires here
            late = server.submit(targets[2], k=3, eps=0.1, delta=DELTA)
            return server.run_until_idle(), late

        (got, late), (want, _) = _twin(serve, sides)
        _assert_same_results(got, want)
        # the same warm counts through a slot never cleared: same answer
        port = sides[1]
        sched = port.scheduler(dict(v_z=64, v_x=16, max_queries=2), window=256, seed=42)
        sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)
        sched.pump(max_passes=64)
        qid = sched.admit(targets[2], k=3, eps=0.1, delta=DELTA)  # lands in slot 1
        sched.pump(max_passes=64)
        np.testing.assert_array_equal(sched.outcomes[qid].ids, got[late].ids)
        assert sched.outcomes[qid].tuples_read == got[late].tuples_read

    def test_cleared_slot_tau_masked_at_init_value(self, mq_data):
        _, sides, targets = mq_data

        def run(side):
            spec_kw = dict(v_z=64, v_x=16, max_queries=2)
            sched = side.scheduler(spec_kw, window=64, seed=0)
            sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)
            sched.admit(targets[1], k=K, eps=EPS, delta=DELTA)
            sched.run_window(sched.order[: sched.window])
            sched.retire(1, exact=False, terminated=False)
            mod = tmq if side.name == "port" else jmq
            return mod.stats_step(sched.state, spec=side.Spec(**spec_kw))

        got, want = _twin(run, sides)
        np.testing.assert_array_equal(got.tau[1].numpy(), np.ones(64, np.float32))
        assert float(got.delta_upper[1]) == 0.0
        np.testing.assert_array_equal(got.tau[1].numpy(), np.asarray(want.tau[1]))
        np.testing.assert_allclose(got.tau[0].numpy(), np.asarray(want.tau[0]), atol=TAU_ATOL)

    def test_k_cap_validated_at_admission(self, mq_data):
        _, sides, targets = mq_data
        server = sides[1].server(max_queries=2, lookahead=64, seed=0, k_cap=4)
        with pytest.raises(ValueError, match="k_cap"):
            server.submit(targets[0], k=5, eps=EPS, delta=DELTA)
        rid = server.submit(targets[0], k=4, eps=EPS, delta=DELTA)
        assert len(server.run_until_idle()[rid].ids) == 4


# ---------------------------------------------------------------------------
# tests/test_metrics.py::TestMixedServe and tests/test_anytime.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    spec = SynthSpec(
        v_z=48, v_x=16, num_tuples=120_000, k=K, n_close=6,
        close_distance=0.03, far_distance=0.4, zipf_a=1.0, seed=3,
    )
    return _data(spec, 0, ())


def _true_dists(ds, metric) -> np.ndarray:
    """Distances of the generator's true histograms to the target."""
    q_hat = torch.from_numpy((ds.target / ds.target.sum()).astype(np.float32))[None]
    hists = torch.from_numpy(np.asarray(ds.true_hists, np.float32))
    return tmetrics.distance_multi_ref(hists, q_hat, metric=metric)[0].numpy()


# closeness radii per metric, each metric's distances on its own scale
CLOSE = {"l1": (0.10, 0.25), "chi2": (0.02, 0.08), "hellinger": (0.01, 0.04)}
TOPK_EPS = {"l1": 0.08, "chi2": 0.3, "hellinger": 0.3}


class TestMixedServe:
    @pytest.mark.parametrize("metric", ["l1", "chi2", "hellinger"])
    def test_topk_and_closeness_share_stream(self, served, metric):
        ds, sides, _ = served
        eps_c, gap = CLOSE[metric]

        def serve(side):
            srv = side.server(max_queries=4, lookahead=64, seed=3, metric=metric)
            srv.submit(ds.target, k=5, eps=TOPK_EPS[metric], delta=0.05)
            srv.submit_closeness(ds.target, eps=eps_c, gap=gap, delta=0.05)
            return srv.run_until_idle()

        got, want = _twin(serve, sides)
        _assert_same_results(got, want)
        rt, rc = got[0], got[1]
        assert rt.qtype == "topk" and rc.qtype == "closeness"
        tau = _true_dists(ds, metric)
        assert sorted(rt.ids.tolist()) == sorted(np.argsort(tau, kind="stable")[:5].tolist())
        close_set = set(rc.ids.tolist())
        assert set(np.flatnonzero(tau <= eps_c).tolist()) <= close_set
        assert close_set.isdisjoint(np.flatnonzero(tau >= eps_c + gap).tolist())
        est = rc.state.tau.numpy()
        assert list(rc.ids) == sorted(rc.ids.tolist(), key=lambda i: est[i])

    @pytest.mark.parametrize("metric", ["l1", "chi2", "hellinger"])
    def test_mid_stream_admission(self, served, metric):
        ds, sides, _ = served
        eps_c, gap = CLOSE[metric]

        def serve(side):
            srv = side.server(max_queries=2, lookahead=32, seed=3, metric=metric)
            srv.submit(ds.target, k=5, eps=TOPK_EPS[metric], delta=0.05)
            for _ in range(3):
                srv.step()
            before = srv.scheduler.tuples_read
            srv.submit_closeness(ds.target, eps=eps_c, gap=gap, delta=0.05)
            return srv.run_until_idle(), before, srv.scheduler.tuples_read

        (got, before, after), (want, *_) = _twin(serve, sides)
        _assert_same_results(got, want)
        assert before > 0 and got[1].tuples_read <= after - before
        tau = _true_dists(ds, metric)
        close_set = set(got[1].ids.tolist())
        assert set(np.flatnonzero(tau <= eps_c).tolist()) <= close_set
        assert close_set.isdisjoint(np.flatnonzero(tau >= eps_c + gap).tolist())

    def test_closeness_rejects_bad_args(self, served):
        _, sides, _ = served
        srv = sides[1].server(max_queries=2, lookahead=64)
        target = np.ones(16)
        with pytest.raises(ValueError, match="gap"):
            srv.submit_closeness(target, eps=0.1, gap=0.0)
        with pytest.raises(ValueError, match="eps"):
            srv.submit_closeness(target, eps=-0.1, gap=0.1)
        with pytest.raises(ValueError, match="gap is only"):
            srv.scheduler.admit(target, k=1, eps=0.1, delta=0.05, gap=0.1)
        with pytest.raises(ValueError, match="qtype"):
            srv.scheduler.admit(target, k=1, eps=0.1, delta=0.05, qtype="range")


def _anytime_server(side, **kw):
    kw.setdefault("max_queries", 2)
    kw.setdefault("lookahead", 8)
    kw.setdefault("seed", 3)
    return side.server(**kw)


def _same_statement(a, b):
    """Two anytime answers say the same thing, bit for bit."""
    assert a.ids.tolist() == b.ids.tolist()
    for f in ("tau", "margin"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    for f in ("split", "delta_upper", "n_min", "tuples", "eps_n", "round"):
        assert getattr(a, f) == getattr(b, f), f


class TestStopEqualsPoll:
    @pytest.mark.parametrize(
        "stop,query",
        [(dict(tuples=20_000), dict(k=K, eps=0.02, delta=0.01)),
         # the six planted matches: confidence 0.5 comes before delta 1e-6
         (dict(confidence=0.5), dict(k=6, eps=0.08, delta=1e-6))],
        ids=["tuples", "confidence"],
    )
    def test_stopped_answer_is_the_poll_at_that_round(self, served, stop, query):
        ds, sides, _ = served
        reason = next(iter(stop))

        def serve(side):
            srv = _anytime_server(side)
            rid = srv.submit(ds.target, **query, stop=side.Stop(**stop))
            return srv.run_until_idle(), srv.poll_result(rid)

        (got, ans), (want, ref_ans) = _twin(serve, sides)
        _assert_same_results(got, want)
        res = got[0]
        assert res.stopped and res.stop_reason == reason and not res.exact
        assert ans.status == "done" and ans.result is res and ans.stopped
        assert ans.ids.tolist() == np.asarray(ref_ans.ids).tolist()
        assert (ans.round, ans.tuples) == (ref_ans.round, ref_ans.tuples)
        np.testing.assert_allclose(ans.delta_upper, ref_ans.delta_upper, rtol=1e-5)

        # an unstopped twin of the same stream, stepped to the stopping
        # round and polled, says the same thing bit for bit
        b = _anytime_server(sides[1])
        rid_b = b.submit(ds.target, **query)
        while b.scheduler.rounds < ans.round and rid_b not in b.results:
            b.step()
        live = b.poll_result(rid_b)
        assert live.status == "live"
        _same_statement(ans, live)
        assert np.array_equal(ans.ids, np.asarray(res.ids))

    def test_statistical_convergence_beats_the_sla(self, served):
        ds, sides, _ = served

        def serve(side):
            srv = _anytime_server(side, lookahead=64)
            srv.submit(ds.target, k=K, eps=0.08, delta=DELTA, stop=side.Stop(tuples=10**9))
            return srv.run_until_idle()

        got, want = _twin(serve, sides)
        _assert_same_results(got, want)
        assert not got[0].stopped and got[0].stop_reason == ""

    def test_default_stop_applies_to_every_query(self, served):
        ds, sides, _ = served

        def serve(side):
            srv = _anytime_server(side, default_stop=side.Stop(tuples=15_000))
            srv.submit(ds.target, k=K, eps=0.02, delta=0.01)
            srv.submit_closeness(ds.target, eps=0.01, gap=0.02, delta=0.01)
            return srv.run_until_idle()

        got, want = _twin(serve, sides)
        _assert_same_results(got, want)
        assert all(r.stopped and r.stop_reason == "tuples" for r in got.values())


class TestStreamEndsAtBlocking:
    @pytest.mark.parametrize("metric", ["l1", "chi2"])
    def test_stream_matches_reference_and_blocking_twin(self, served, metric):
        ds, sides, _ = served
        eps = 0.08 if metric == "l1" else 0.15

        def stream(side):
            srv = _anytime_server(side, metric=metric)
            rid = srv.submit(ds.target, k=K, eps=eps, delta=DELTA)
            return list(srv.iter_results(rid)), srv.scheduler.rounds

        (got, rounds), (want, ref_rounds) = _twin(stream, sides)
        assert rounds == ref_rounds
        assert [(a.status, a.round, a.ids.tolist()) for a in got] == [
            (a.status, a.round, np.asarray(a.ids).tolist()) for a in want
        ]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.delta_upper, b.delta_upper, rtol=1e-5)
        final = got[-1]
        assert final.status == "done"
        assert [a.status for a in got[:-1]].count("done") == 0

        b = _anytime_server(sides[1], metric=metric)
        rid_b = b.submit(ds.target, k=K, eps=eps, delta=DELTA)
        blocking = b.run_until_idle()[rid_b]
        assert final.ids.tolist() == blocking.ids.tolist()
        assert final.result.state.tau.numpy().tobytes() == blocking.state.tau.numpy().tobytes()
        assert final.delta_upper == blocking.delta_upper
        assert final.exact == blocking.exact
        assert final.round == rounds == b.scheduler.rounds

    def test_stream_is_at_poll_granularity_and_dedups(self, served):
        ds, sides, _ = served
        srv = _anytime_server(sides[1])
        rid = srv.submit(ds.target, k=K, eps=0.08, delta=DELTA)
        rounds = [a.round for a in srv.iter_results(rid) if a.status == "live"]
        assert rounds == sorted(set(rounds))

    def test_queued_statement_is_vacuous(self, served):
        ds, sides, _ = served
        srv = _anytime_server(sides[1], max_queries=1, lookahead=64)
        ra = srv.submit(ds.target, k=K, eps=0.08, delta=DELTA)
        rb = srv.submit(ds.target, k=3, eps=0.08, delta=DELTA)
        srv.step()
        live, queued = srv.poll_result(ra), srv.poll_result(rb)
        assert live.status == "live" and live.ids.size == K
        assert queued.status == "queued"
        assert queued.delta_upper == 1.0 and queued.confidence == 0.0
        assert queued.ids.size == 0 and queued.n_min == 0.0
        with pytest.raises(KeyError):
            srv.poll_result(999)
        srv.run_until_idle()
        done = srv.poll_result(rb)
        assert done.status == "done" and done.result is srv.results[rb]
        # a result with no anytime record degrades to a done statement
        again = tserver.answer_from_result(srv.results[rb], metric="l1")
        assert again.ids.tolist() == done.ids.tolist() and again.delta_upper == done.delta_upper


class TestPruneSound:
    def test_pruned_never_reappears_and_answer_unchanged(self, served):
        ds, sides, _ = served

        def run(side, prune):
            srv = _anytime_server(side, metric="chi2", prune=prune)
            rid = srv.submit(ds.target, k=K, eps=0.15, delta=DELTA)
            best_sets, masks = [], []
            for ans in srv.iter_results(rid):
                if ans.status == "live":
                    best_sets.append(set(np.asarray(ans.ids).tolist()))
                    masks.append(np.array(srv.scheduler._pruned_host[0]))
            return srv.results[rid], best_sets, masks

        res, best_sets, masks = run(sides[1], True)
        ref_res, ref_sets, ref_masks = run(sides[0], True)
        _assert_same(res, ref_res)
        assert best_sets == ref_sets
        assert len(masks) == len(ref_masks)
        for a, b in zip(masks, ref_masks):
            np.testing.assert_array_equal(a, b)
        assert masks[-1].any(), "chi2 at this radius must prune"
        for a, b in zip(masks, masks[1:]):
            assert not (a & ~b).any()  # sticky
        final_set = set(res.ids.tolist())
        for i, m in enumerate(masks):
            pruned = set(np.flatnonzero(m).tolist())
            for later in best_sets[i:] + [final_set]:
                assert not (pruned & later)
        unpruned = run(sides[1], False)[0]
        assert sorted(res.ids.tolist()) == sorted(unpruned.ids.tolist())

    def test_prune_off_is_the_default_and_mask_stays_empty(self, served):
        ds, sides, _ = served
        srv = _anytime_server(sides[1])
        assert srv.spec.prune is False
        rid = srv.submit(ds.target, k=K, eps=0.08, delta=DELTA)
        srv.run_until_idle()
        assert not srv.scheduler._pruned_host.any() and rid in srv.results
        assert not bool(srv.scheduler.state.pruned.any())


# ---------------------------------------------------------------------------
# tests/test_device_loop.py::TestGoldenEquivalence
# ---------------------------------------------------------------------------


def _golden_loop():
    """The reference's host-stepped golden loop (`run_reference`) from
    tests/test_device_loop.py, loaded without collecting its tests."""
    path = Path(__file__).with_name("test_device_loop.py")
    spec = importlib.util.spec_from_file_location("_reference_device_loop", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.run_reference


@pytest.fixture(scope="module")
def loop_data():
    spec = SynthSpec(
        v_z=48, v_x=16, num_tuples=300_000, k=K, n_close=5,
        close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=13,
    )
    ds, sides, targets = _data(spec, 21, (0.01, 0.04))
    return ds, sides, targets, _golden_loop()


def _port_fused(ported, initial, *, window, start_block, poll_every=1, admit_plan=()):
    """The workload through the port's fused scheduler (the reference
    test's `run_fused`)."""
    spec = tmq.MultiQuerySpec(v_z=ported.v_z, v_x=ported.v_x, max_queries=4)
    sched = tmq.SharedCountsScheduler(
        ported, spec, window=window, seed=0, start_block=start_block, poll_every=poll_every,
        device="cpu",
    )
    pending = sorted(admit_plan, key=lambda p: p[:2])
    slot_of_qid = {}

    def on_round(s):
        while pending and pending[0][0] <= s.rounds and s.free_slots:
            _, slot, t, k, e, d = pending.pop(0)
            assert s.free_slots[0] == slot
            slot_of_qid[s.admit(t, k=k, eps=e, delta=d)] = slot

    for slot, t, k, e, d in initial:
        slot_of_qid[sched.admit(t, k=k, eps=e, delta=d)] = slot
    sched.pump(max_passes=4, on_round=on_round)
    assert not pending, "admit_plan rounds were never reached"
    return sched, {slot_of_qid[qid]: out.ids for qid, out in sched.outcomes.items()}


def _assert_golden(sched, out, ref_state, ref_mask, ref_out):
    np.testing.assert_array_equal(sched.state.counts.numpy(), np.asarray(ref_state.counts))
    np.testing.assert_array_equal(sched.state.n.numpy(), np.asarray(ref_state.n))
    np.testing.assert_array_equal(sched.read_mask, ref_mask)
    assert set(out) == set(ref_out)
    for slot in ref_out:
        np.testing.assert_array_equal(out[slot], np.asarray(ref_out[slot]))


class TestGoldenEquivalence:
    def test_identical_to_host_stepped_loop(self, loop_data):
        _, sides, targets, run_reference = loop_data
        initial = [(s, t, K, EPS, DELTA) for s, t in enumerate(targets)]
        golden = run_reference(sides[0].data, initial, window=64, start_block=17)
        _assert_golden(*_port_fused(sides[1].data, initial, window=64, start_block=17), *golden)

    def test_identical_with_mid_stream_admission(self, loop_data):
        _, sides, targets, run_reference = loop_data
        initial = [(0, targets[0], K, EPS, DELTA)]
        plan = [(2, 1, targets[1], K, EPS, DELTA), (4, 2, targets[2], 3, 0.1, DELTA)]
        golden = run_reference(sides[0].data, initial, window=48, start_block=5, admit_plan=plan)
        port = _port_fused(sides[1].data, initial, window=48, start_block=5, admit_plan=plan)
        _assert_golden(*port, *golden)

    def test_identical_on_exact_completion_fallback(self, loop_data):
        run_reference = loop_data[3]
        spec = SynthSpec(v_z=24, v_x=8, num_tuples=30_000, k=3, n_close=3, seed=4)
        ds, sides, _ = _data(spec, 0, ())
        initial = [(0, ds.target, 3, 0.02, 1e-9)]
        ref_state, ref_mask, ref_out = run_reference(
            sides[0].data, initial, window=32, start_block=3
        )
        sched, out = _port_fused(sides[1].data, initial, window=32, start_block=3)
        assert ref_mask.all() and sched.read_mask.all()
        _assert_golden(sched, out, ref_state, ref_mask, ref_out)
        assert sched.outcomes[0].exact

    def test_poll_every_staleness_preserves_answers(self, loop_data):
        _, sides, targets, _ = loop_data
        initial = [(s, t, K, EPS, DELTA) for s, t in enumerate(targets)]
        s1, out1 = _port_fused(sides[1].data, initial, window=16, start_block=17, poll_every=1)
        s8, out8 = _port_fused(sides[1].data, initial, window=16, start_block=17, poll_every=8)
        for slot in out1:
            assert sorted(out1[slot].tolist()) == sorted(out8[slot].tolist()), slot
        assert s8.blocks_read >= s1.blocks_read
        assert s1.host_syncs >= s1.rounds
        assert s8.host_syncs < s1.host_syncs / 2
        # and the stale loop reads what the reference's stale loop reads
        spec = jmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=4)
        ref = jmq.SharedCountsScheduler(
            sides[0].data, spec, window=16, seed=0, start_block=17, poll_every=8
        )
        for _, t, k, e, d in initial:
            ref.admit(t, k=k, eps=e, delta=d)
        ref.pump(max_passes=4)
        np.testing.assert_array_equal(s8.read_mask, ref.read_mask)
        np.testing.assert_array_equal(s8.state.counts.numpy(), np.asarray(ref.state.counts))
        assert (s8.host_syncs, s8.rounds) == (ref.host_syncs, ref.rounds)
        for qid, o in ref.outcomes.items():
            _assert_same(s8.outcomes[qid], o, OUTCOME_FIELDS)


# ---------------------------------------------------------------------------
# what this slice does not port
# ---------------------------------------------------------------------------


class TestNotPorted:
    @pytest.mark.parametrize(
        "option,value,item",
        [("mesh", object(), "A9"), ("pump", True, "A9"), ("model_axis", "m", "A9"),
         ("data_axes", ("x",), "A9")],
        ids=lambda v: v if isinstance(v, str) else "",
    )
    def test_option_raises_naming_its_item(self, served, option, value, item):
        _, sides, _ = served
        with pytest.raises(NotImplementedError, match=item):
            sides[1].server(**{option: value})

    def test_options_left_off_are_accepted(self, served):
        _, sides, _ = served
        srv = sides[1].server(mesh=None, pump=False, prefetch=False, telemetry=None,
                              data_axes=["data"], kernel_plans=None)
        assert srv.metrics["queries_done"] == 0
        with pytest.raises(TypeError, match="unexpected keyword"):
            sides[1].server(meshes=None)

    @pytest.mark.parametrize(
        "call,item",
        [(lambda s: s.export_trace("t.jsonl"), "without telemetry"),
         (lambda s: s.prometheus_metrics(), "without telemetry")],
        ids=["export_trace", "prometheus_metrics"],
    )
    def test_method_raises_naming_its_item(self, served, call, item):
        """A server built without telemetry has nothing to export: both
        packages raise the same RuntimeError."""
        _, sides, _ = served
        errors = []
        for side in sides:
            with pytest.raises(RuntimeError, match=item) as info:
                call(side.server())
            errors.append(str(info.value))
        assert errors[0] == errors[1]

    def test_health_keys_report_a_healthy_server(self, served):
        ds, sides, _ = served

        def serve(side):
            srv = side.server(max_queries=2, lookahead=64, seed=3)
            srv.submit(ds.target, k=K, eps=0.08, delta=DELTA)
            srv.run_until_idle()
            return srv.metrics

        got, want = _twin(serve, sides)
        assert got == pytest.approx(want)

    def test_default_device_raises_without_gpu(self, served):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present, so the default device is valid")
        _, sides, _ = served
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MatchServer(sides[1].data)
