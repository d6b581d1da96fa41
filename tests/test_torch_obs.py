"""The port's telemetry (`repro_torch.obs`) against the JAX reference's.

One twin for each test of tests/test_obs.py, on its fixture (200K
tuples, V_Z = 32, V_X = 16, seed 3), each run through both packages on
the CPU: the registry, tracer and curve units record the same operations
in both and compare values, snapshots, Prometheus text and CSV files,
which must be equal byte for byte (the port's registry bins on the CPU
through `ref.histogram_ref`, on the card through kernel B); the server
twins serve the same seeded workload through both servers and compare
the trace skeletons, the confidence curves, the registry snapshots and
the exports. The bit-equivalence of telemetry on and off is the port's
own contract and runs in the port alone.

The tolerance contract: every key, kind, order, int, bool and string of
a skeleton and every curve point's round, tuples, n_min and eps_n are
equal (eps_n is `_metric_eps_np` of an equal n_min); ``tau_min`` agrees
to ``atol=2e-5``; ``delta_upper`` (and ``confidence``) to the Theorem-1
bound of tests/test_torch_rounds.py, ``|Δ log delta_upper| <= max_i
n_i (eps_i + 2D) 2D + 1e-6`` with D the measured tau difference and n_i
at most the point's shared tuples. A timing histogram (``*_seconds``)
holds host walls, so only its count, kind and edges are compared.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.checkpoint import CheckpointManager as JManager
from repro.core.bounds import theorem1_epsilon
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.io import PrefetchSource as JPrefetch
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import multiquery as tmq
from repro_torch.io import PrefetchSource
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
K, EPS, DELTA = 5, 0.08, 0.05


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(v_z=32, v_x=16, num_tuples=200_000, k=K, n_close=5,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=3)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=5)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return spec, ds, blocked, ported


@pytest.fixture(scope="module")
def targets(dataset):
    _, ds, _, _ = dataset
    rng = np.random.default_rng(9)
    return [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.04)]


# the two packages' factories: the port's registry is told its device
PKGS = {
    "ref": dict(registry=jobs.MetricsRegistry, telemetry=jobs.Telemetry, Tracer=jobs.Tracer,
                columns=jobs.CURVE_COLUMNS),
    "port": dict(registry=lambda: tobs.MetricsRegistry(device="cpu"),
                 telemetry=lambda **kw: tobs.Telemetry(device="cpu", **kw), Tracer=tobs.Tracer,
                 columns=tobs.CURVE_COLUMNS),
}


def _both(fn):
    """``fn(pkg)`` for each package: {"ref": ..., "port": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


# ---------------------------------------------------------------- registry


class TestRegistry:
    def test_counter_monotone(self):
        def run(pkg):
            reg = pkg["registry"]()
            c = reg.counter("x_total", "help text")
            c.inc()
            c.inc(2.5)
            with pytest.raises(ValueError, match="cannot decrease"):
                c.inc(-1)
            assert reg.counter("x_total") is c  # get-or-create
            return c.value, reg.to_prometheus(), reg.to_json()

        out = _both(run)
        assert out["port"][0] == 3.5
        assert out["port"] == out["ref"]

    def test_gauge_last_write_wins(self):
        def run(pkg):
            g = pkg["registry"]().gauge("depth")
            g.set(4)
            g.inc(-1)
            return g.value, g.snapshot()

        out = _both(run)
        assert out["port"][0] == 3.0 and out["port"] == out["ref"]

    def test_kind_conflict_raises(self):
        def run(pkg):
            reg = pkg["registry"]()
            reg.counter("m")
            with pytest.raises(ValueError, match="already registered") as info:
                reg.gauge("m")
            return str(info.value)

        out = _both(run)
        assert out["port"] == out["ref"]

    def test_bad_name_rejected(self):
        def run(pkg):
            with pytest.raises(ValueError, match="invalid metric name") as info:
                pkg["registry"]().counter("has space")
            return str(info.value)

        out = _both(run)
        assert out["port"] == out["ref"]

    def test_histogram_binning_dogfoods_kernel(self):
        """The port's bins through its histogram op equal a plain numpy
        count and the reference's, the v == edge boundary included (le
        semantics: a sample on an edge belongs to that edge's bucket)."""
        samples = [0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 7.0, 0.2]

        def run(pkg):
            h = pkg["registry"]().histogram("lat_seconds", edges=(0.01, 0.1, 1.0))
            for s in samples:
                h.observe(s)
            return h.bucket_counts(), h.count, h.sum, h.snapshot()

        out = _both(run)
        want = np.zeros(4, np.int64)
        for s in samples:
            want[int(np.searchsorted((0.01, 0.1, 1.0), s, side="left"))] += 1
        counts, count, total, snap = out["port"]
        assert counts.dtype == np.int64
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(counts, out["ref"][0])
        assert count == len(samples) and total == pytest.approx(sum(samples))
        assert (count, total, snap) == out["ref"][1:]

    def test_histogram_thread_safe_observe(self):
        def run(pkg):
            h = pkg["registry"]().histogram("t_seconds", edges=(0.5,))

            def burst():
                for _ in range(500):
                    h.observe(0.1)

            threads = [threading.Thread(target=burst) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            return h.count, h.bucket_counts().tolist()

        out = _both(run)
        assert out["port"] == (2000, [2000, 0]) and out["port"] == out["ref"]

    def test_prometheus_exposition(self):
        def run(pkg):
            reg = pkg["registry"]()
            reg.counter("reads_total", "total reads").inc(7)
            reg.gauge("queue_depth").set(2)
            h = reg.histogram("lat_seconds", edges=(0.1, 1.0))
            for v in (0.05, 0.5, 5.0):
                h.observe(v)
            return reg.to_prometheus()

        out = _both(run)
        lines = out["port"].splitlines()
        for want in ("# HELP reads_total total reads", "# TYPE reads_total counter",
                     "reads_total 7", "queue_depth 2", 'lat_seconds_bucket{le="0.1"} 1',
                     'lat_seconds_bucket{le="1"} 2', 'lat_seconds_bucket{le="+Inf"} 3',
                     "lat_seconds_count 3"):
            assert want in lines, want
        assert out["port"] == out["ref"]  # byte for byte

    def test_snapshot_is_json_able(self):
        def run(pkg):
            reg = pkg["registry"]()
            reg.counter("a_total").inc()
            reg.histogram("b_seconds", edges=(1.0,)).observe(0.5)
            return reg.to_json()

        out = _both(run)
        back = json.loads(out["port"])
        assert back["a_total"]["value"] == 1.0 and back["b_seconds"]["buckets"] == [1, 0]
        assert out["port"] == out["ref"]


# ------------------------------------------------------------------ tracer


class TestTracer:
    def test_emit_sequencing_and_ring_bound(self):
        def run(pkg):
            tr = pkg["Tracer"](capacity=3, clock=lambda: 0.0)
            for i in range(5):
                tr.emit("e", i=i)
            return tr.events(), tr.events_total

        out = _both(run)
        evs, total = out["port"]
        assert [e["i"] for e in evs] == [2, 3, 4] and [e["seq"] for e in evs] == [2, 3, 4]
        assert total == 5 and out["port"] == out["ref"]

    def test_skeleton_strips_timing_only(self):
        def run(pkg):
            tr = pkg["Tracer"](clock=lambda: 0.0)
            tr.emit("round_batch", rounds=4, gather_s=0.1, sync_s=0.2, stall_frac=0.3)
            return tr.skeleton()

        out = _both(run)
        assert out["port"] == [{"seq": 0, "kind": "round_batch", "rounds": 4}] == out["ref"]
        assert tobs.TIMING_FIELDS == jobs.TIMING_FIELDS

    def test_span_records_duration(self):
        def run(pkg):
            ticks = iter([0.0, 0.0, 1.5, 1.5])  # epoch, enter, exit, the emit's ts
            tr = pkg["Tracer"](clock=lambda: next(ticks))
            with tr.span("work", tag="x") as ev:
                ev["extra"] = 1
            return tr.events("work")

        out = _both(run)
        (e,) = out["port"]
        assert e["dur_s"] == 1.5 and e["tag"] == "x" and e["extra"] == 1
        assert out["port"] == out["ref"]

    def test_export_jsonl_round_trip(self, tmp_path):
        def run(pkg):
            tr = pkg["Tracer"](clock=lambda: 0.0)
            tr.emit("a", v=1)
            tr.emit("b", v=[1, 2])
            p = tmp_path / f"trace_{pkg['Tracer'].__module__}.jsonl"
            assert tr.export_jsonl(p) == 2
            return p.read_bytes()

        out = _both(run)
        back = [json.loads(line) for line in out["port"].decode().splitlines()]
        assert [e["kind"] for e in back] == ["a", "b"] and back[1]["v"] == [1, 2]
        assert out["port"] == out["ref"]


# ----------------------------------------------------------- the curve store


class TestTelemetryCurves:
    def test_dedupe_and_cap(self):
        def run(pkg):
            tel = pkg["telemetry"](max_curve_points=3)
            pt = dict.fromkeys(pkg["columns"], 0.0)
            tel.record_curve_point(1, dict(pt))
            tel.record_curve_point(1, dict(pt))  # the same (round, tuples, delta_upper)
            first = len(tel.trajectory(1))
            for r in (1, 2, 3, 4):
                tel.record_curve_point(1, dict(pt, round=r))
            return first, tel.trajectory(1), tel.curve_drops

        out = _both(run)
        first, traj, drops = out["port"]
        assert first == 1 and len(traj) == 3 and drops == 2  # the earliest kept
        assert out["port"] == out["ref"]

    def test_confidence_curve_array_and_csv(self, tmp_path):
        assert tobs.CURVE_COLUMNS == jobs.CURVE_COLUMNS

        def run(pkg):
            tel = pkg["telemetry"]()
            for r in (0, 1):
                tel.record_curve_point(7, dict.fromkeys(pkg["columns"], float(r)))
            p = tmp_path / f"curve_{id(pkg)}.csv"
            rows = tel.export_confidence_csv(p)
            return tel.confidence_curve(7), tel.confidence_curve(99).shape, rows, p.read_text()

        out = _both(run)
        arr, empty, rows, text = out["port"]
        assert arr.shape == (2, len(tobs.CURVE_COLUMNS)) and empty == (0, len(tobs.CURVE_COLUMNS))
        header, *lines = text.splitlines()
        assert header == "qid," + ",".join(tobs.CURVE_COLUMNS)
        assert rows == 2 and len(lines) == 2 and lines[0].startswith("7,")
        np.testing.assert_array_equal(arr, out["ref"][0])
        assert out["port"][1:] == out["ref"][1:]


# ---------------------------------------------------- server integration


def _drain(dataset, targets, pkg, *, telemetry, seed=11):
    _, _, blocked, ported = dataset
    if pkg == "port":
        srv = MatchServer(ported, device="cpu", max_queries=2, lookahead=64, poll_every=2,
                          seed=seed, telemetry=telemetry)
    else:
        srv = JServer(blocked, max_queries=2, lookahead=64, poll_every=2, seed=seed,
                      telemetry=telemetry)
    rids = [srv.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
    return srv, rids, srv.run_until_idle()


@pytest.fixture(scope="module")
def served(dataset, targets):
    """The telemetry-on run of each package (the port's twice)."""
    return dict(port=_drain(dataset, targets, "port", telemetry=True),
                port_again=_drain(dataset, targets, "port", telemetry=True),
                ref=_drain(dataset, targets, "ref", telemetry=True))


def _tau_gap(served) -> float:
    """D: the largest tau difference between the packages' answers."""
    (_, p_rids, p_res), (_, r_rids, r_res) = served["port"], served["ref"]
    return max(float(np.abs(p_res[a].state.tau.numpy().astype(np.float64)
                            - np.asarray(r_res[b].state.tau, np.float64)).max())
               for a, b in zip(p_rids, r_rids))


def _du_close(got: float, want: float, *, tuples: int, eps: float, d: float) -> bool:
    """delta_upper within the Theorem-1 bound (module docstring)."""
    if got == want:
        return True
    bound = tuples * (eps + 2 * d) * 2 * d + 1e-6
    return abs(np.log(got) - np.log(want)) <= bound


def _assert_skeletons_match(got, want, *, tuples: int, d: float):
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for g, w in zip(got, want):
        assert list(g) == list(w), (g, w)
        for key, wv in w.items():
            gv = g[key]
            assert type(gv) is type(wv), (key, g, w)
            if key == "delta_upper":
                assert _du_close(gv, wv, tuples=tuples, eps=EPS, d=d), (g, w)
            else:
                assert gv == wv, (key, g, w)


def _assert_snapshots_match(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if w["kind"] == "histogram" and name.endswith("_seconds"):
            g, w = ({k: v for k, v in s.items() if k not in ("buckets", "sum")} for s in (g, w))
        assert g == w, name


class TestServerTelemetry:
    SCHEMA = {
        "queries_done": int,
        "queries_queued": int,
        "queries_live": int,
        "queries_pending": int,
        "total_blocks_read": int,
        "total_tuples_read": int,
        "total_rounds": int,
        "fraction_read": float,
        "tuples_per_query": float,
        "last_error": str,
        "queries_shed": int,
        "blocks_quarantined": int,
        "degraded": bool,
        "eps_inflation": float,
    }

    def test_metrics_schema_pinned(self, dataset, targets):
        _, _, blocked, ported = dataset
        for srv in (MatchServer(ported, device="cpu", max_queries=2, lookahead=64),
                    JServer(blocked, max_queries=2, lookahead=64)):
            m = srv.metrics
            assert set(m) == set(self.SCHEMA)
            for key, typ in self.SCHEMA.items():
                assert isinstance(m[key], typ), (key, type(m[key]))
            assert m["tuples_per_query"] == 0.0
            json.loads(json.dumps(m, allow_nan=False))
            srv.submit(targets[0], k=K, eps=EPS, delta=DELTA)
            srv.run_until_idle()
            m = srv.metrics
            assert m["queries_done"] == 1 and m["tuples_per_query"] > 0.0
            for key, typ in self.SCHEMA.items():
                assert isinstance(m[key], typ), (key, type(m[key]))

    def test_bit_equivalence_on_off(self, dataset, targets, served):
        """Telemetry observes, never perturbs: the same results, the same
        polls (host and loop), and a bitwise equal exported cache."""
        srv_on, rids_on, res_on = served["port"]
        srv_off, rids_off, res_off = _drain(dataset, targets, "port", telemetry=None)
        assert srv_off.telemetry is None and rids_on == rids_off
        for rid in rids_on:
            a, b = res_on[rid], res_off[rid]
            np.testing.assert_array_equal(a.ids, b.ids)
            assert (a.rounds, a.blocks_read, a.tuples_read, a.exact, a.passes) == (
                b.rounds, b.blocks_read, b.tuples_read, b.exact, b.passes)
            assert torch.equal(a.state.tau, b.state.tau)
        on, off = srv_on.scheduler, srv_off.scheduler
        assert (on.host_syncs, on.loop_syncs) == (off.host_syncs, off.loop_syncs)
        assert on.loop_syncs > 0
        for leaf_on, leaf_off in zip(on.export_cache(), off.export_cache()):
            assert torch.equal(leaf_on, leaf_off)

    def test_golden_span_tree(self, served):
        """Two identically seeded port servers give equal skeletons, and
        they equal the reference's (the tolerance contract); each query
        reads enqueue -> admit -> retire -> done."""
        srv_a, rids, _ = served["port"]
        sk_a = srv_a.telemetry.tracer.skeleton()
        assert sk_a == served["port_again"][0].telemetry.tracer.skeleton()
        for ev in sk_a:
            assert not tobs.TIMING_FIELDS.intersection(ev)
        kinds = [e["kind"] for e in sk_a]
        for kind in ("query_enqueue", "query_admit", "query_retire", "query_done"):
            assert kinds.count(kind) == len(rids), kind
        assert kinds.count("pass_start") >= 1 and kinds.count("round_batch") >= 1
        admits = [e["qid"] for e in sk_a if e["kind"] == "query_admit"]
        assert admits == sorted(admits)
        for qid in admits:
            seqs = {e["kind"]: e["seq"] for e in sk_a if e.get("qid") == qid
                    and e["kind"] in ("query_admit", "query_retire", "query_done")}
            assert seqs["query_admit"] < seqs["query_retire"] < seqs["query_done"]
        last_rb = [e for e in sk_a if e["kind"] == "round_batch"][-1]
        assert last_rb["rounds"] == srv_a.scheduler.rounds
        ref = served["ref"][0]
        _assert_skeletons_match(sk_a, ref.telemetry.tracer.skeleton(),
                                tuples=ref.scheduler.tuples_read, d=_tau_gap(served))

    def test_confidence_curve_matches_stats_tail(self, dataset, served):
        """eps_n is Theorem 1's bound at the polled n_min and the budget
        delta / V_Z; delta_upper falls below delta for a terminated query;
        the counters equal the scheduler's mirrors; every point equals the
        reference's under the tolerance contract."""
        spec = dataset[0]
        srv, rids, res = served["port"]
        tel, sched = srv.telemetry, srv.scheduler
        assert tel.query_ids() == sorted(e["qid"] for e in tel.tracer.skeleton("query_admit"))
        jtel = served["ref"][0].telemetry
        assert tel.query_ids() == jtel.query_ids()
        d = _tau_gap(served)
        for qid in tel.query_ids():
            traj, jtraj = tel.trajectory(qid), jtel.trajectory(qid)
            assert traj and len(traj) == len(jtraj), qid
            for p, jp in zip(traj, jtraj):
                want = float(theorem1_epsilon(max(p["n_min"], 1.0), DELTA / spec.v_z, spec.v_x))
                np.testing.assert_allclose(p["eps_n"], want, rtol=1e-4)
                assert p["eps_n"] == tmq._metric_eps_np(p["n_min"], DELTA / spec.v_z, spec.v_x,
                                                        "l1")
                assert p["confidence"] == pytest.approx(max(0.0, 1.0 - p["delta_upper"]))
                assert list(p) == list(tobs.CURVE_COLUMNS)
                for c in ("round", "tuples", "tuples_live", "n_min", "eps_n"):
                    assert p[c] == jp[c], (qid, c)
                assert abs(p["tau_min"] - jp["tau_min"]) <= TAU_ATOL
                assert _du_close(p["delta_upper"], jp["delta_upper"], tuples=p["tuples"],
                                 eps=EPS, d=d), (p, jp)
            assert traj[-1]["delta_upper"] <= traj[0]["delta_upper"]
            assert traj[-1]["tuples"] >= traj[0]["tuples"]
        for ev in tel.tracer.skeleton("query_retire"):
            if ev["terminated"]:
                assert tel.trajectory(ev["qid"])[-1]["delta_upper"] < DELTA
        reg = tel.registry
        assert reg.get("fastmatch_rounds_total").value == sched.rounds
        assert reg.get("fastmatch_tuples_read_total").value == sched.tuples_read
        assert reg.get("fastmatch_host_syncs_total").value == sched.host_syncs
        assert reg.get("fastmatch_queries_retired_total").value == len(res)
        _assert_snapshots_match(reg.snapshot(), jtel.registry.snapshot())

    def test_trace_and_prometheus_exports(self, dataset, served, tmp_path):
        srv = served["port"][0]
        p = tmp_path / "trace.jsonl"
        n = srv.export_trace(p)
        lines = p.read_text().splitlines()
        assert n == len(lines) > 0
        back = [json.loads(line) for line in lines]
        assert [{k: v for k, v in e.items() if k not in tobs.TIMING_FIELDS} for e in back] == (
            srv.telemetry.tracer.skeleton())
        text = srv.prometheus_metrics()
        assert "# TYPE fastmatch_rounds_total counter" in text
        assert "# TYPE fastmatch_round_batch_seconds histogram" in text
        # the reference's text, but for the timing histograms' buckets and sums
        jtext = served["ref"][0].prometheus_metrics()

        def steady(t):
            return [line for line in t.splitlines() if "_seconds_bucket" not in line
                    and "_seconds_sum" not in line]

        assert steady(text) == steady(jtext)
        plain = MatchServer(dataset[3], device="cpu", max_queries=2, lookahead=64)
        with pytest.raises(RuntimeError, match="without telemetry"):
            plain.export_trace(p)


# ------------------------------------------------------------- prefetch


class _SlowSource:
    """Minimal BlockSource: fetch sleeps, so waits are guaranteed."""

    def __init__(self, *, fetch_delay=0.02, fail_at=None, windows=6):
        self.num_blocks = windows
        self.block_size = 4
        self.v_z = 2
        self.v_x = 2
        self.tuples_per_block = np.full(windows, 4, np.int64)
        self.fetch_delay = fetch_delay
        self.fail_at = fail_at
        self.calls = 0

    def fetch(self, win, pad_to=None):
        self.calls += 1
        if self.fail_at is not None and self.calls >= self.fail_at:
            raise RuntimeError("disk on fire")
        time.sleep(self.fetch_delay)
        return ("window", int(np.asarray(win)[0]))

    def stream(self, windows, pad_to=None):
        for w in windows:
            yield self.fetch(w, pad_to)


def _prefetch(pkg, inner, tel, **kw):
    cls = PrefetchSource if pkg == "port" else JPrefetch
    return cls(inner, telemetry=tel, **kw)


def _tel(pkg):
    return tobs.Telemetry(device="cpu") if pkg == "port" else jobs.Telemetry()


class TestPrefetchTelemetry:
    def test_slow_source_records_nonzero_wait(self):
        """A source slower than its consumer shows as waits and a stall
        share; the stream event's keys and counts equal the reference's."""
        wins = [np.array([i]) for i in range(6)]
        events = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            out = list(_prefetch(pkg, _SlowSource(fetch_delay=0.02), tel).stream(wins))
            assert [o[1] for o in out] == list(range(6))
            h_wait = tel.registry.get("prefetch_wait_seconds")
            h_fetch = tel.registry.get("prefetch_fetch_seconds")
            assert h_wait.count >= len(wins) and h_wait.sum > 0.0
            assert h_fetch.count == len(wins) and h_fetch.sum >= 6 * 0.02
            (ev,) = tel.tracer.events("prefetch_stream")
            assert ev["windows"] == len(wins) + 1  # + the "done" hand-off
            assert ev["wait_s"] > 0.0 and ev["fetch_s"] > 0.0
            assert 0.0 <= ev["stall_frac"] <= 1.0
            assert ev["hidden_s"] == pytest.approx(max(ev["fetch_s"] - ev["wait_s"], 0.0))
            events[pkg] = tel.tracer.skeleton()
        assert events["port"] == events["ref"]

    def test_worker_error_is_structured_event(self):
        skeletons = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            src = _prefetch(pkg, _SlowSource(fetch_delay=0.0, fail_at=3), tel)
            with pytest.raises(RuntimeError, match="disk on fire"):
                list(src.stream([np.array([i]) for i in range(6)]))
            assert tel.registry.get("prefetch_worker_errors_total").value == 1
            (ev,) = tel.tracer.events("prefetch_worker_error")
            assert ev["source"] == "_SlowSource" and "disk on fire" in ev["error"]
            skeletons[pkg] = tel.tracer.skeleton("prefetch_worker_error")
        assert skeletons["port"] == skeletons["ref"]

    def test_join_timeout_is_structured_event(self):
        skeletons = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            src = _prefetch(pkg, _SlowSource(fetch_delay=0.5, windows=4), tel, join_timeout=0.0)
            it = src.stream([np.array([i]) for i in range(4)])
            next(it)  # the worker is now inside the next slow fetch
            it.close()  # join(0.0) cannot outwait a 0.5 s fetch
            assert tel.registry.get("prefetch_join_timeouts_total").value == 1
            (ev,) = tel.tracer.events("prefetch_join_timeout")
            assert ev["source"] == "_SlowSource" and ev["timeout_s"] == 0.0
            skeletons[pkg] = tel.tracer.skeleton("prefetch_join_timeout")
        assert skeletons["port"] == skeletons["ref"]
        time.sleep(0.6)  # let both abandoned workers finish their fetch


# ------------------------------------------------------------ checkpoint


def _manager(pkg, path, tel=None):
    cls = CheckpointManager if pkg == "port" else JManager
    return cls(path, telemetry=tel)


def _ckpt_state(pkg):
    state = {"a": np.arange(10, dtype=np.int64), "b": np.ones(3, np.float32)}
    if pkg == "port":
        state = {k: torch.from_numpy(v) for k, v in state.items()}
    return state


class TestCheckpointTelemetry:
    def test_save_metrics_and_event(self, tmp_path):
        out = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            mgr = _manager(pkg, tmp_path / pkg, tel)
            mgr.save(_ckpt_state(pkg), step=4)
            reg = tel.registry
            assert reg.get("checkpoint_saves_total").value == 1
            assert reg.get("checkpoint_save_bytes_total").value == 10 * 8 + 3 * 4
            assert reg.get("checkpoint_save_seconds").count == 1
            (ev,) = tel.tracer.events("checkpoint_save")
            assert ev["step"] == 4 and ev["bytes"] == 92 and ev["save_s"] > 0.0
            assert mgr.save_failures == 0
            out[pkg] = tel.tracer.skeleton()
        assert out["port"] == out["ref"]

    def test_save_failure_counted_and_reraised(self, tmp_path):
        out = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            mgr = _manager(pkg, tmp_path / pkg, tel)
            # a file squatting on the staging dir's name makes the save's
            # own mkdir fail: the failure path, deterministically
            (tmp_path / pkg / f"step_9.tmp.{os.getpid()}").write_text("squatter")
            with pytest.raises(OSError):
                mgr.save(_ckpt_state(pkg), step=9)
            assert mgr.save_failures == 1
            out[pkg] = tel.registry.to_prometheus()
            assert tel.registry.get("checkpoint_save_failures_total").value == 1
            assert tel.registry.get("checkpoint_saves_total").value == 0
        assert out["port"] == out["ref"]

    def test_orphan_gc_counted(self, tmp_path):
        out = {}
        for pkg in ("port", "ref"):
            tel = _tel(pkg)
            mgr = _manager(pkg, tmp_path / pkg, tel)
            (tmp_path / pkg / "step_1.tmp.999999999").mkdir()  # a dead pid's orphan
            (tmp_path / pkg / "LATEST.tmp.999999998").write_text("step_1")
            mgr.save(_ckpt_state(pkg), step=2)  # the save's GC sweeps them
            assert mgr.gc_swept == 2
            assert tel.registry.get("checkpoint_gc_swept_total").value == 2
            (ev,) = tel.tracer.events("checkpoint_gc")
            assert ev["swept"] == 2 and not list((tmp_path / pkg).glob("*.tmp.*"))
            out[pkg] = tel.tracer.skeleton("checkpoint_gc")
        assert out["port"] == out["ref"]

    def test_counters_exist_without_telemetry(self, tmp_path):
        for pkg in ("port", "ref"):
            mgr = _manager(pkg, tmp_path / pkg)
            mgr.save(_ckpt_state(pkg), step=1)
            assert mgr.gc_swept == 0 and mgr.save_failures == 0 and mgr.telemetry is None
