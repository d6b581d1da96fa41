"""The port's kernel plans against the JAX reference's `repro.kernels.autotune`.

Twins of the CPU-runnable tests of tests/test_autotune.py, on the CPU
engine ("ref": the plain versions), with the same numpy-seeded inputs
handed to both packages:

  * every "ref" tau candidate and every ingest candidate is bitwise the
    port's baseline, and the baseline agrees with the reference's (tau
    within 2e-5, counts and rows equal); uint16 counts in range are
    exact and the overflow gate falls back exactly;
  * an unusable plan falls back to the defaults with a warning, and the
    "xla" variant is no candidate on "cuda";
  * a plan file round-trips byte-stable and reads byte-identical to the
    reference's for the same plans; a missing file is silent, a stale
    schema, a schema-1 file, corrupt JSON, another backend's file and a
    malformed entry warn and fall back;
  * "auto" runs the registered plan, `resolve_plans` tunes on a miss and
    saves, and without a plan file dispatch is the pre-plan dispatch;
  * plans through the scheduler and the server give what the default
    plans give, and what the reference gives with the same plans;
  * keys, the bytes model and the "ref" candidate list equal the
    reference's; the committed ``cuda.json`` loads byte-stable.

The card's candidates are held against the defaults in
tests/test_torch_cuda.py.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiquery as jmq
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.kernels import autotune as jat
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import multiquery as tmq
from repro_torch.kernels import autotune as at
from repro_torch.kernels import metrics as tmetrics
from repro_torch.kernels import ops
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
SRC = Path(at.__file__).resolve().parents[2]
ROOT = SRC.parent


def _case(v_z, v_x, q, seed=0, hi=50):
    """Integer-valued f32 counts + dirichlet targets (the reference's _case)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, hi, size=(v_z, v_x)).astype(np.float32)
    q_hat = np.stack([rng.dirichlet(np.ones(v_x)).astype(np.float32) for _ in range(q)])
    return counts, q_hat


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _baseline(counts, q_hat):
    """The port's per-slot unrolled tau on the plain versions."""
    return at.run_tau(_t(counts), _t(q_hat), plan=at.TauPlan(variant="unrolled"),
                      engine="ref").numpy()


@pytest.fixture()
def clean_warnings():
    """_warn_once dedupes process-wide; reset so each test sees its warning."""
    at._warned.clear()
    yield
    at._warned.clear()


@pytest.fixture()
def plans_dir(tmp_path, monkeypatch):
    """An empty plan directory for the port's registries, dropped after."""
    monkeypatch.setenv("FASTMATCH_TORCH_PLANS_DIR", str(tmp_path))
    at.reload(backend="cpu")
    yield tmp_path
    monkeypatch.delenv("FASTMATCH_TORCH_PLANS_DIR")
    monkeypatch.delenv("FASTMATCH_TORCH_AUTOTUNE", raising=False)
    at.reload(backend="cpu")


class TestRefCandidateSpace:
    """Every candidate on the CPU engine: bitwise the baseline."""

    @pytest.mark.parametrize("v_z,v_x,q", [(64, 300, 3), (128, 64, 1), (96, 128, 8)])
    @pytest.mark.parametrize("metric", list(tmetrics.METRIC_NAMES))
    def test_every_ref_candidate_bit_identical(self, v_z, v_x, q, metric):
        counts, q_hat = _case(v_z, v_x, q)
        want = _baseline(counts, q_hat) if metric == "l1" else at.run_tau(
            _t(counts), _t(q_hat), plan=at.TauPlan(variant="unrolled"), metric=metric).numpy()
        ref_want = np.asarray(jat.run_tau(
            jnp.asarray(counts), jnp.asarray(q_hat), plan=jat.TauPlan(variant="unrolled"),
            engine="ref", metric=metric))
        np.testing.assert_allclose(want, ref_want, atol=TAU_ATOL, rtol=0)
        cands = at.tau_candidates("ref", v_z, v_x, q)
        assert {c.variant for c in cands} == set(at.TAU_VARIANTS)
        assert any(c.lowprec for c in cands)
        for cand in cands:
            got = at.run_tau(_t(counts), _t(q_hat), plan=cand, engine="ref", metric=metric)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=repr(cand))

    def test_every_ingest_candidate_bit_identical(self):
        v_z, v_x, n = 64, 48, 4096
        rng = np.random.default_rng(3)
        z = rng.integers(-1, v_z, size=n).astype(np.int32)
        x = rng.integers(-1, v_x, size=n).astype(np.int32)
        base_c, base_n = at.run_ingest(_t(z), _t(x), v_z=v_z, v_x=v_x,
                                       plan=at.DEFAULT_INGEST, engine="ref")
        ref_c, ref_n = jat.run_ingest(jnp.asarray(z), jnp.asarray(x), v_z=v_z, v_x=v_x,
                                      plan=jat.DEFAULT_INGEST, engine="ref")
        np.testing.assert_array_equal(base_c.numpy(), np.asarray(ref_c))
        np.testing.assert_array_equal(base_n.numpy(), np.asarray(ref_n))
        counts = _t(rng.integers(0, 9, size=(v_z, v_x)).astype(np.float32))
        rows = counts.sum(dim=1)
        for cand in at.ingest_candidates("ref", v_z, v_x):
            c, r = at.run_ingest(_t(z), _t(x), v_z=v_z, v_x=v_x, plan=cand, engine="ref")
            np.testing.assert_array_equal(c.numpy(), base_c.numpy(), err_msg=repr(cand))
            np.testing.assert_array_equal(r.numpy(), base_n.numpy(), err_msg=repr(cand))
            # the round's form: into counts and row sums, through the op
            c2, r2 = ops.ingest_counts(counts, rows, _t(z), _t(x), v_z=v_z, v_x=v_x, plan=cand)
            assert torch.equal(c2, counts + base_c) and torch.equal(r2, rows + base_n)
            c3, r3 = ops.histogram_with_rowsums(_t(z), _t(x), v_z=v_z, v_x=v_x, plan=cand)
            assert torch.equal(c3, base_c) and torch.equal(r3, base_n)
        assert at.ingest_candidates("cuda", v_z, v_x) == at.ingest_candidates("ref", v_z, v_x)

    def test_lowprec_in_range_is_exact(self):
        counts, q_hat = _case(80, 96, 4, hi=60_000)  # near the uint16 ceiling
        got = at.run_tau(_t(counts), _t(q_hat), plan=at.TauPlan(lowprec=True))
        np.testing.assert_array_equal(got.numpy(), _baseline(counts, q_hat))
        ref_got = jat.run_tau(jnp.asarray(counts), jnp.asarray(q_hat),
                              plan=jat.TauPlan(lowprec=True), engine="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_got), atol=TAU_ATOL, rtol=0)

    def test_lowprec_overflow_gate_falls_back_exactly(self):
        counts, q_hat = _case(32, 64, 2)
        counts[3, 5] = 70_000.0  # above the uint16 range: a cast would wrap to 4464
        for variant in ("batched", "unrolled", "xla"):
            got = at.run_tau(_t(counts), _t(q_hat), plan=at.TauPlan(variant=variant,
                                                                    lowprec=True))
            np.testing.assert_array_equal(got.numpy(), _baseline(counts, q_hat))
        wrapped = counts.copy()
        wrapped[3, 5] = 70_000.0 - 65_536.0
        assert not np.array_equal(_baseline(wrapped, q_hat), _baseline(counts, q_hat))


class TestUnusablePlans:
    def test_unusable_plan_falls_back_with_warning(self, clean_warnings):
        # a forced single sweep cannot cover a lane-tiled V_X
        counts, q_hat = _case(8, 300, 2)
        bad = at.TauPlan(sweeps=1, x_tile=128)
        with pytest.warns(UserWarning, match="fall"):
            got = at.run_tau(_t(counts), _t(q_hat), plan=bad, engine="ref")
        want = at.run_tau(_t(counts), _t(q_hat), plan=at.DEFAULT_TAU, engine="ref")
        assert torch.equal(got, want)
        assert not jat._tau_usable(jat.TauPlan(sweeps=1, x_tile=128), engine="ref", v_x=300)

    @pytest.mark.parametrize("v_x", [2, 24, 1025, 8192])
    def test_xla_and_out_of_range_plans_are_no_cuda_candidates(self, v_x):
        cands = at.tau_candidates("cuda", 256, v_x, 8)
        assert all(c.variant != "xla" for c in cands)
        assert not at._tau_usable(at.TauPlan(variant="xla"), engine="cuda", v_x=v_x)
        assert at._tau_usable(at.TauPlan(variant="xla"), engine="ref", v_x=v_x)
        # unrolled keeps the Q = 1 launch's single-block bound, as the reference's
        # Pallas engine does; a forced narrow branch holds V_X <= 1024
        assert (at.TauPlan(variant="unrolled") in cands) == (v_x <= tmetrics.MAX_SINGLE_BLOCK_VX)
        assert at._tau_usable(at.TauPlan(sweeps=1), engine="cuda",
                              v_x=v_x) == (v_x <= tmetrics.NARROW_MAX_VX)
        assert at.DEFAULT_TAU in cands and at.TauPlan(sweeps=2, lowprec=True) in cands
        # kernel C picks its own grid, so the card's space varies the
        # branch and the counts' type, never the inert z_tile
        assert {(c.sweeps, c.lowprec) for c in cands if c.variant == "batched"} \
            == {(s, lp) for s in (0, 2) for lp in (False, True)}
        assert all(c.z_tile == at.DEFAULT_TAU.z_tile for c in cands)
        assert len(cands) == len(set(cands))

    def test_engine_must_match_the_device(self):
        counts, q_hat = _case(8, 16, 1)
        with pytest.raises(ValueError, match="engine"):
            at.run_tau(_t(counts), _t(q_hat), plan=at.DEFAULT_TAU, engine="cuda")

    def test_sweeps_outside_the_branches_rejected(self):
        with pytest.raises(ValueError, match="sweep"):
            tmetrics.wide_branch(2000, sweeps=1)
        assert tmetrics.wide_branch(24, sweeps=2) and not tmetrics.wide_branch(24)
        assert tmetrics.wide_branch(1025) and not tmetrics.wide_branch(1024, sweeps=1)
        assert tmetrics.wide_branch(600, x_tile=512)


class TestRegistryPersistence:
    def _populated(self, mod, backend="cpu"):
        reg = mod.PlanRegistry(backend=backend)
        reg.tau[mod.tau_key(64, 300, 4)] = mod.TauPlan(variant="xla")
        reg.tau[mod.tau_key(256, 256, 8)] = mod.TauPlan(lowprec=True)
        reg.ingest[mod.ingest_key(64, 300)] = mod.IngestPlan(fused=False)
        return reg

    def test_save_load_roundtrip_byte_stable(self, tmp_path):
        reg = self._populated(at)
        path = reg.save(tmp_path / "cpu.json")
        loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert loaded.decisions() == reg.decisions()
        assert loaded.tau_plan(64, 300, 4) == at.TauPlan(variant="xla")
        assert loaded.ingest_plan(64, 300) == at.IngestPlan(fused=False)
        bytes1 = path.read_text()
        loaded.save(tmp_path / "again.json")
        assert (tmp_path / "again.json").read_text() == bytes1
        # the same plans read alike in both packages, byte for byte
        ref_path = self._populated(jat).save(tmp_path / "ref" / "cpu.json")
        assert ref_path.read_text() == bytes1
        assert self._populated(jat).decisions() == reg.decisions()
        assert at.PlanRegistry.load(path=ref_path, backend="cpu").decisions() == reg.decisions()

    def test_missing_file_is_silent_defaults(self, tmp_path, clean_warnings):
        import warnings as w
        with w.catch_warnings():
            w.simplefilter("error")
            reg = at.PlanRegistry.load(path=tmp_path / "absent.json", backend="cpu")
        assert reg.tau_plan(64, 300, 4) == at.DEFAULT_TAU
        assert reg.ingest_plan(64, 300) == at.DEFAULT_INGEST

    def test_stale_schema_warns_and_defaults(self, tmp_path, clean_warnings):
        path = self._populated(at).save(tmp_path / "cpu.json")
        doc = json.loads(path.read_text())
        doc["schema"] = at.PLAN_SCHEMA + 1
        path.write_text(json.dumps(doc))
        with pytest.warns(UserWarning, match="schema"):
            loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert not loaded.tau and not loaded.ingest
        assert loaded.tau_plan(64, 300, 4) == at.DEFAULT_TAU

    def test_pre_metric_schema1_warns_and_defaults(self, tmp_path, clean_warnings):
        path = tmp_path / "cpu.json"
        path.write_text(json.dumps({
            "schema": 1,
            "backend": "cpu",
            "tau": {"vz=256,vx=256,q=4,dtype=float32": {"variant": "pallas"}},
            "ingest": {"vz=256,vx=256": {"fused": True}},
        }))
        with pytest.warns(UserWarning, match="schema"):
            loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert not loaded.tau and not loaded.ingest
        assert loaded.tau_plan(256, 256, 4) == at.DEFAULT_TAU
        assert loaded.ingest_plan(256, 256) == at.DEFAULT_INGEST

    def test_corrupt_json_warns_and_defaults(self, tmp_path, clean_warnings):
        path = tmp_path / "cpu.json"
        path.write_text("{not json")
        with pytest.warns(UserWarning, match="unreadable"):
            loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert loaded.tau_plan(1, 1, 1) == at.DEFAULT_TAU

    def test_backend_mismatch_warns_and_defaults(self, tmp_path, clean_warnings):
        path = self._populated(at, backend="cuda").save(tmp_path / "cuda.json")
        with pytest.warns(UserWarning, match="backend"):
            loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert not loaded.tau

    def test_malformed_entry_dropped_not_fatal(self, tmp_path, clean_warnings):
        path = self._populated(at).save(tmp_path / "cpu.json")
        doc = json.loads(path.read_text())
        doc["tau"][at.tau_key(64, 300, 4)]["variant"] = "warp-drive"
        path.write_text(json.dumps(doc))
        with pytest.warns(UserWarning, match="malformed"):
            loaded = at.PlanRegistry.load(path=path, backend="cpu")
        assert loaded.tau_plan(64, 300, 4) == at.DEFAULT_TAU
        assert loaded.tau_plan(256, 256, 8) == at.TauPlan(lowprec=True)
        assert loaded.ingest_plan(64, 300) == at.IngestPlan(fused=False)

    def test_one_registry_per_backend(self, plans_dir):
        self._populated(at, backend="cpu").save(plans_dir / "cpu.json")
        reg = at.PlanRegistry(backend="cuda")
        reg.tau[at.tau_key(64, 300, 4)] = at.TauPlan(sweeps=2)
        reg.save(plans_dir / "cuda.json")
        at.reload(backend="cpu")
        assert at.get_tau_plan(64, 300, 4, backend="cpu") == at.TauPlan(variant="xla")
        assert at.get_tau_plan(64, 300, 4, backend="cuda") == at.TauPlan(sweeps=2)
        assert at.registry("cuda").backend == "cuda" and at.registry("cpu").backend == "cpu"
        assert at.plan_path("cuda") == plans_dir / "cuda.json"


class TestDispatch:
    def test_plan_arg_coercion_rejects_junk(self):
        for junk in (42, "fastest", at.IngestPlan()):
            with pytest.raises(TypeError):
                at.coerce_tau_plan(junk, 8, 8, 1)
        for junk in (42, "fastest", at.TauPlan()):
            with pytest.raises(TypeError):
                at.coerce_ingest_plan(junk, 8, 8)
        with pytest.raises(TypeError):
            jat.coerce_tau_plan(42, 8, 8, 1)
        assert at.coerce_tau_plan(None, 8, 8, 1) == at.coerce_tau_plan("default", 8, 8, 1) \
            == at.DEFAULT_TAU
        plan = at.TauPlan(variant="unrolled")
        assert at.coerce_tau_plan(plan, 8, 8, 1) is plan

    def test_auto_dispatch_runs_the_registered_plan(self, plans_dir, monkeypatch):
        reg = at.PlanRegistry(backend="cpu")
        reg.tau[at.tau_key(48, 96, 3)] = at.TauPlan(variant="xla")
        reg.ingest[at.ingest_key(48, 96)] = at.IngestPlan(fused=False)
        reg.save(plans_dir / "cpu.json")
        at.reload(backend="cpu")
        calls = []
        xla, hist = tmetrics.distance_multi_xla, at.ref.histogram_ref
        monkeypatch.setattr(tmetrics, "distance_multi_xla",
                            lambda *a, **kw: calls.append("xla") or xla(*a, **kw))
        monkeypatch.setattr(at.ref, "histogram_ref",
                            lambda *a, **kw: calls.append("two-step") or hist(*a, **kw))
        counts, q_hat = _case(48, 96, 3)
        got = ops.l1_distance_multi(_t(counts), _t(q_hat), plan="auto")
        assert calls == ["xla"]
        np.testing.assert_array_equal(got.numpy(), _baseline(counts, q_hat))
        ops.l1_distance_multi(_t(counts), _t(q_hat), plan="default")
        counts2, q_hat2 = _case(40, 96, 3)  # an unregistered shape: the defaults
        ops.l1_distance_multi(_t(counts2), _t(q_hat2))
        assert calls == ["xla"]
        z = _t(np.arange(10, dtype=np.int32) % 48)
        ops.histogram_with_rowsums(z, z, v_z=48, v_x=96)
        assert calls == ["xla", "two-step"]
        # the lookup is kept per shape until the registry is reloaded
        assert at._auto[("tau", "cpu", 48, 96, 3, "l1")] == at.TauPlan(variant="xla")
        at.reload(backend="cpu")
        assert not at._auto

    def test_resolve_plans_tunes_on_miss_and_persists(self, plans_dir, monkeypatch):
        monkeypatch.setenv("FASTMATCH_TORCH_AUTOTUNE", "1")
        pair = at.resolve_plans(32, 32, 1, n_samples=512, device="cpu")
        path = at.plan_path("cpu")
        assert path == plans_dir / "cpu.json" and path.exists()
        doc = json.loads(path.read_text())
        assert doc["backend"] == "cpu"
        assert at.tau_key(32, 32, 1) in doc["tau"]
        assert at.ingest_key(32, 32) in doc["ingest"]
        assert pair.tau in at.tau_candidates("ref", 32, 32, 1)
        monkeypatch.delenv("FASTMATCH_TORCH_AUTOTUNE")
        again = at.reload(backend="cpu").tau_plan(32, 32, 1)
        assert again == pair.tau
        assert at.resolve_plans(32, 32, 1, device="cpu") == pair

    def test_without_plan_file_dispatch_matches_pre_plan(self, plans_dir, monkeypatch):
        calls = []
        multi = tmetrics.distance_multi_ref
        monkeypatch.setattr(tmetrics, "distance_multi_ref",
                            lambda *a, **kw: calls.append(1) or multi(*a, **kw))
        counts, q_hat = _case(64, 300, 3)
        auto = ops.l1_distance_multi(_t(counts), _t(q_hat), plan="auto")
        none = ops.l1_distance_multi(_t(counts), _t(q_hat), plan=None)
        assert calls == [1, 1] and torch.equal(auto, none)
        assert at.resolve_plans(64, 300, 3, device="cpu") == at.PlanPair()


@pytest.fixture(scope="module")
def sched_data():
    spec_s = SynthSpec(v_z=48, v_x=12, num_tuples=200_000, k=5, n_close=5,
                       close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=11)
    ds = make_dataset(spec_s)
    blocked = block_layout(ds.z, ds.x, v_z=spec_s.v_z, v_x=spec_s.v_x, block_size=256, seed=11)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec_s.v_z, spec_s.v_x
    )
    return spec_s, ds, blocked, ported


class TestSchedulerPlans:
    def test_explicit_plans_bit_equivalent_to_default(self, sched_data):
        spec_s, ds, blocked, ported = sched_data
        fields = dict(tau=dict(variant="xla", lowprec=True), ingest=dict(fused=False))
        exotic = convert.plan_pair_from_fields(fields)
        ref_exotic = jat.PlanPair(tau=jat.TauPlan(**fields["tau"]),
                                  ingest=jat.IngestPlan(**fields["ingest"]))
        assert dataclasses.asdict(exotic) == dataclasses.asdict(ref_exotic)
        assert convert.plan_pair_from_fields(dataclasses.asdict(ref_exotic)) == exotic
        results = []
        for plans in (None, exotic, at.PlanPair(tau=at.TauPlan(variant="unrolled"))):
            sched = tmq.SharedCountsScheduler(
                ported, tmq.MultiQuerySpec(v_z=48, v_x=12, max_queries=2), window=32, seed=0,
                plans=plans, device="cpu",
            )
            assert sched.plans == (plans or at.PlanPair())
            sched.admit(ds.target, k=5, eps=0.08, delta=0.05)
            sched.run_window(sched.order[:32])
            sched.pump(max_rounds=6)
            results.append((sched.state.counts.numpy(), sched.state.n.numpy(),
                            sched.state.delta_upper.numpy(), sched.state.tau.numpy(),
                            (sched.rounds, sched.blocks_read, sched.tuples_read)))
        ref = jmq.SharedCountsScheduler(
            blocked, jmq.MultiQuerySpec(v_z=48, v_x=12, max_queries=2), window=32, seed=0,
            plans=ref_exotic,
        )
        ref.admit(ds.target, k=5, eps=0.08, delta=0.05)
        ref.run_window(ref.order[:32])
        ref.pump(max_rounds=6)
        for got in results[1:]:
            for a, b in zip(got, results[0]):
                np.testing.assert_array_equal(a, b)
        got = results[1]
        np.testing.assert_array_equal(got[0], np.asarray(ref.state.counts))
        np.testing.assert_array_equal(got[1], np.asarray(ref.state.n))
        np.testing.assert_allclose(got[2], np.asarray(ref.state.delta_upper), rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(got[3], np.asarray(ref.state.tau), atol=TAU_ATOL, rtol=0)
        assert got[4] == (ref.rounds, ref.blocks_read, ref.tuples_read)

    def test_server_kernel_plans_match_reference(self, sched_data):
        _, ds, blocked, ported = sched_data
        rng = np.random.default_rng(2)
        targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.02, 0.05)]
        plans = at.PlanPair(at.TauPlan(lowprec=True), at.IngestPlan(fused=False))
        ref_plans = jat.PlanPair(jat.TauPlan(lowprec=True), jat.IngestPlan(fused=False))

        def serve(server):
            for t in targets:
                server.submit(t, k=5, eps=0.08, delta=0.05)
            return server.run_until_idle()

        port_srv = MatchServer(ported, device="cpu", max_queries=2, lookahead=64, seed=4,
                               kernel_plans=plans)
        default_srv = MatchServer(ported, device="cpu", max_queries=2, lookahead=64, seed=4)
        ref_srv = JServer(blocked, max_queries=2, lookahead=64, seed=4, kernel_plans=ref_plans)
        assert port_srv.kernel_plans == plans and default_srv.kernel_plans == at.PlanPair()
        with pytest.raises(TypeError, match="PlanPair"):
            MatchServer(ported, device="cpu", kernel_plans=object())
        with pytest.raises(ValueError, match="z_tile"):
            MatchServer(ported, device="cpu", kernel_plans=at.PlanPair(at.TauPlan(z_tile=4)))
        assert ref_srv.kernel_plans == ref_plans
        got, default, want = serve(port_srv), serve(default_srv), serve(ref_srv)
        assert sorted(got) == sorted(want) == sorted(default) == [0, 1, 2]
        for rid in want:
            for f in ("ids", "rounds", "passes", "blocks_read", "tuples_read", "exact"):
                np.testing.assert_array_equal(np.asarray(getattr(got[rid], f)),
                                              np.asarray(getattr(want[rid], f)), err_msg=f)
                np.testing.assert_array_equal(np.asarray(getattr(got[rid], f)),
                                              np.asarray(getattr(default[rid], f)), err_msg=f)
            np.testing.assert_array_equal(got[rid].state.counts.numpy(),
                                          np.asarray(want[rid].state.counts))
            assert torch.equal(got[rid].state.tau, default[rid].state.tau)


class TestReferenceSurface:
    @pytest.mark.parametrize("v_z,v_x,q", [(7548, 24, 1), (7548, 24, 8), (161, 24, 8),
                                           (191, 2, 1), (256, 8192, 3), (64, 300, 4)])
    def test_keys_bytes_and_ref_candidates_equal_reference(self, v_z, v_x, q):
        for metric in tmetrics.METRIC_NAMES:
            assert at.tau_key(v_z, v_x, q, metric=metric) == jat.tau_key(v_z, v_x, q,
                                                                         metric=metric)
        assert at.ingest_key(v_z, v_x) == jat.ingest_key(v_z, v_x)
        ref_cands = jat.tau_candidates("ref", v_z, v_x, q)
        cands = at.tau_candidates("ref", v_z, v_x, q)
        assert [dataclasses.asdict(c) for c in cands] == \
            [dataclasses.asdict(c) for c in ref_cands]
        assert [dataclasses.asdict(c) for c in at.ingest_candidates("ref", v_z, v_x)] == \
            [dataclasses.asdict(c) for c in jat.ingest_candidates("ref", v_z, v_x)]
        for plan in cands + at.tau_candidates("cuda", v_z, v_x, q):
            ref_plan = jat.TauPlan(**dataclasses.asdict(plan))
            for metric in tmetrics.METRIC_NAMES:
                assert at.tau_bytes(v_z, v_x, q, plan, metric) == \
                    jat.tau_bytes(v_z, v_x, q, ref_plan, metric)
        assert dataclasses.asdict(at.DEFAULT_TAU) == dataclasses.asdict(jat.DEFAULT_TAU)
        assert dataclasses.asdict(at.DEFAULT_INGEST) == dataclasses.asdict(jat.DEFAULT_INGEST)
        assert (at.PLAN_SCHEMA, at.TAU_VARIANTS, at.DEFAULT_MARGIN) == \
            (jat.PLAN_SCHEMA, jat.TAU_VARIANTS, jat.DEFAULT_MARGIN)

    def test_pick_keeps_the_comparator_within_the_margin(self):
        for slow, fast in ((1.05, 1.0), (1.2, 1.0), (1.0, 1.1)):
            port = {at.TauPlan(variant="unrolled"): slow, at.TauPlan(): fast}
            ref = {jat.TauPlan(variant="unrolled"): slow, jat.TauPlan(): fast}
            got = at._pick(port, at.TauPlan(variant="unrolled"), margin=at.DEFAULT_MARGIN)
            want = jat._pick(ref, jat.TauPlan(variant="unrolled"), margin=jat.DEFAULT_MARGIN)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)

    @pytest.mark.parametrize("default_s,other_s,want_default", [
        (1.05, 1.0, True), (1.2, 1.0, False), (1.0, 1.1, True)])
    def test_card_comparator_is_the_pre_plan_launch(self, default_s, other_s, want_default):
        # on the card a candidate must beat DEFAULT_TAU by the margin; the
        # plain versions keep the reference's "unrolled" comparator
        assert at._tau_comparator("cuda") == at.DEFAULT_TAU
        assert dataclasses.asdict(at._tau_comparator("ref")) == \
            dataclasses.asdict(jat.TauPlan(variant="unrolled"))
        other = at.TauPlan(sweeps=2)
        timed = {at.DEFAULT_TAU: default_s, other: other_s, at.TauPlan(variant="unrolled"): 9.0}
        got = at._pick(timed, at._tau_comparator("cuda"), margin=at.DEFAULT_MARGIN)
        assert got == (at.DEFAULT_TAU if want_default else other)

    def test_tune_on_cpu_measures_every_candidate(self):
        plan, timed = at.tune_tau(24, 8, 2, device="cpu", reps=2)
        assert set(timed) == set(at.tau_candidates("ref", 24, 8, 2))
        assert plan in timed and all(t > 0 for t in timed.values())
        iplan, itimed = at.tune_ingest(24, 8, device="cpu", reps=2)
        assert set(itimed) == {at.IngestPlan(fused=True), at.IngestPlan(fused=False)}
        assert iplan in itimed


def test_committed_cuda_plans_load_byte_stable_across_processes():
    path = ROOT / "benchmarks" / "results" / "tuned_torch" / "cuda.json"
    assert path.exists()
    reg = at.PlanRegistry.load(path=path, backend="cuda")
    assert reg.backend == "cuda" and reg.tau and reg.ingest
    assert {"card", "torch", "cuda", "date"} <= set(reg.meta)
    for key, plan in reg.tau.items():
        v_z, v_x, q = (int(kv.split("=")[1]) for kv in key.split(",")[:3])
        assert plan in at.tau_candidates("cuda", v_z, v_x, q), key
    prog = (
        "import sys\n"
        "from repro_torch.kernels import autotune\n"
        "sys.stdout.write(autotune.registry('cuda').decisions())\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("FASTMATCH_TORCH_")}
    env["PYTHONPATH"] = str(SRC)
    outs = [
        subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       check=True, env=env, timeout=120).stdout
        for _ in range(2)
    ]
    assert outs[0] == outs[1] == reg.decisions()
