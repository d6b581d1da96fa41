"""The port's warm-start persistence against the JAX reference's.

Twins of tests/test_warm_restart.py on its fixture (600K tuples,
V_Z = 64, V_X = 16), on the CPU: the scheduler's export/import hooks,
a restored server bitwise the uninterrupted one, a covered query with
no new I/O after a restart, the fallback past a save killed midway,
stale layouts, V_X and specs refused, the autosave cadences. Across
packages: a snapshot written by the reference's `MatchServer` restores
in the port's with bitwise counts, n, read mask and counters, and the
continued answers equal the reference's restored server's within the
tolerance contract (integers equal, tau within 2e-5, bounds within
rtol 1e-5); the port's snapshot restores in the reference the same way;
both refuse the same stale snapshots and find nothing in an empty
directory.

Left out, waiting for ROADMAP A9: ``test_place_cache_reshard_in_memory``
and ``TestReshardedRestore`` (restoring onto another mesh).
"""

import numpy as np
import pytest
import torch

from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import multiquery as tmq
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
K, EPS, DELTA = 5, 0.08, 0.05
KW = dict(max_queries=4, lookahead=64)


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(v_z=64, v_x=16, num_tuples=600_000, k=K, n_close=5,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=5)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=5)
    return ds, blocked, _port(blocked)


def _port(blocked):
    return convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, blocked.v_z, blocked.v_x
    )


@pytest.fixture(scope="module")
def targets(dataset):
    ds, _, _ = dataset
    rng = np.random.default_rng(9)
    return [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.03)]


def _server(pkg, data, ckpt_dir=None, **kw):
    kw = {**KW, "seed": 3, **kw}
    if pkg == "port":
        return MatchServer(data, checkpoint_dir=ckpt_dir, device="cpu", **kw)
    return JServer(data, checkpoint_dir=ckpt_dir, **kw)


def _restore(pkg, data, ckpt_dir, **kw):
    kw = {**KW, **kw}
    if pkg == "port":
        return MatchServer.restore(data, checkpoint_dir=str(ckpt_dir), device="cpu", **kw)
    return JServer.restore(data, checkpoint_dir=str(ckpt_dir), **kw)


def _data(pkg, dataset):
    return dataset[2] if pkg == "port" else dataset[1]


def _serve_and_save(pkg, data, targets, ckpt_dir, **kw):
    server = _server(pkg, data, str(ckpt_dir), **kw)
    for t in targets:
        server.submit(t, k=K, eps=EPS, delta=DELTA)
    server.run_until_idle()
    server.save_cache()
    return server


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_cache(a, b):
    """Two schedulers (either package) hold the same warm cache."""
    np.testing.assert_array_equal(_np(a.state.counts), _np(b.state.counts))
    np.testing.assert_array_equal(_np(a.state.n), _np(b.state.n))
    np.testing.assert_array_equal(a.read_mask, b.read_mask)
    np.testing.assert_array_equal(a.order, b.order)
    assert (a.rounds, a.passes, a.blocks_read, a.blocks_considered, a.tuples_read) == (
        b.rounds, b.passes, b.blocks_read, b.blocks_considered, b.tuples_read)


def _assert_same_result(got, want):
    for f in ("ids", "rounds", "passes", "blocks_read", "tuples_read", "exact", "degraded",
              "eps_effective"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_np(got.state.counts), _np(want.state.counts))
    np.testing.assert_allclose(_np(got.state.tau), _np(want.state.tau), atol=TAU_ATOL)
    np.testing.assert_allclose(got.delta_upper, want.delta_upper, rtol=1e-5, atol=1e-12)


def _answer(server, target, *, eps, delta):
    rid = server.submit(target, k=K, eps=eps, delta=delta)
    return server.run_until_idle()[rid]


def _fresh(ds):
    return perturb_distribution(ds.target, 0.05, np.random.default_rng(4))


class TestSchedulerHooks:
    def test_export_import_roundtrip(self, dataset, targets):
        _, _, ported = dataset
        spec = tmq.MultiQuerySpec(v_z=64, v_x=16, max_queries=2)
        a = tmq.SharedCountsScheduler(ported, spec, window=64, seed=1, device="cpu")
        a.admit(targets[0], k=K, eps=EPS, delta=DELTA)
        a.pump()
        b = tmq.SharedCountsScheduler(ported, spec, window=64, seed=777, device="cpu")
        b.import_cache(a.export_cache())
        _assert_same_cache(a, b)

    def test_import_with_live_queries_refused(self, dataset, targets):
        _, _, ported = dataset
        spec = tmq.MultiQuerySpec(v_z=64, v_x=16, max_queries=2)
        a = tmq.SharedCountsScheduler(ported, spec, window=64, seed=1, device="cpu")
        snap = a.export_cache()
        a.admit(targets[0], k=K, eps=EPS, delta=DELTA)
        with pytest.raises(RuntimeError, match="live queries"):
            a.import_cache(snap)

    def test_import_wrong_layout_shape_refused(self, dataset):
        _, _, ported = dataset
        spec = tmq.MultiQuerySpec(v_z=64, v_x=16, max_queries=2)
        snap = tmq.SharedCountsScheduler(ported, spec, window=64, seed=1,
                                         device="cpu").export_cache()
        other = _port(block_layout(np.zeros(1024, np.int64), np.zeros(1024, np.int64),
                                   v_z=64, v_x=16, block_size=512, seed=0))
        b = tmq.SharedCountsScheduler(other, spec, window=2, seed=1, device="cpu")
        with pytest.raises(ValueError, match="read_mask"):
            b.import_cache(snap)


class TestGoldenEquivalence:
    def test_restored_server_bit_identical(self, dataset, targets, tmp_path):
        ds, _, ported = dataset
        a = _serve_and_save("port", ported, targets, tmp_path)
        b = _restore("port", ported, tmp_path, seed=999)
        _assert_same_cache(a.scheduler, b.scheduler)
        fresh = _fresh(ds)
        ra, rb = (_answer(s, fresh, eps=0.04, delta=0.01) for s in (a, b))
        np.testing.assert_array_equal(ra.ids, rb.ids)
        assert torch.equal(ra.state.tau, rb.state.tau)
        assert torch.equal(a.scheduler.state.counts, b.scheduler.state.counts)
        assert (ra.exact, ra.tuples_read, ra.rounds, ra.delta_upper) == (
            rb.exact, rb.tuples_read, rb.rounds, rb.delta_upper)

    @pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
    def test_snapshot_restores_across_packages(self, dataset, targets, tmp_path, writer, reader):
        """Written by one package, restored by the other: the same warm
        cache bitwise, and a demanding fresh query continues as it does
        on the writer's package restored from the same files."""
        ds = dataset[0]
        _serve_and_save(writer, _data(writer, dataset), targets, tmp_path)
        got = _restore(reader, _data(reader, dataset), tmp_path, seed=999)
        want = _restore(writer, _data(writer, dataset), tmp_path, seed=999)
        _assert_same_cache(got.scheduler, want.scheduler)
        fresh = _fresh(ds)
        rg, rw = (_answer(s, fresh, eps=0.04, delta=0.01) for s in (got, want))
        port, ref = (rg, rw) if reader == "port" else (rw, rg)
        _assert_same_result(port, ref)
        _assert_same_cache(got.scheduler, want.scheduler)

    def test_snapshot_files_are_the_reference_s(self, dataset, targets, tmp_path):
        """The port's snapshot: the reference's leaf names and dtypes, and
        the reference's config hash."""
        import json

        _serve_and_save("port", dataset[2], targets, tmp_path / "port")
        _serve_and_save("ref", dataset[1], targets, tmp_path / "ref")
        metas = []
        for side in ("port", "ref"):
            step = max((tmp_path / side).glob("step_*"), key=lambda p: int(p.name[5:]))
            metas.append(json.loads((step / "META.json").read_text()))
        (mp, mr) = metas
        assert mp["leaves"] == mr["leaves"] and mp["config_hash"] == mr["config_hash"]
        assert mp["step"] == mr["step"]
        assert [leaf["name"] for leaf in mp["leaves"]] == [
            ".counts", ".n", ".read_mask", ".blocks_read", ".blocks_considered",
            ".tuples_read", ".rounds", ".passes", ".start"]

    def test_warm_restart_answers_covered_query_with_zero_io(self, dataset, targets, tmp_path):
        ds, blocked, ported = dataset
        _serve_and_save("ref", blocked, targets, tmp_path)
        b = _restore("port", ported, tmp_path)
        before = b.metrics["total_tuples_read"]
        target = perturb_distribution(ds.target, 0.02, np.random.default_rng(11))
        res = _answer(b, target, eps=EPS, delta=DELTA)
        assert res.tuples_read == 0 and b.metrics["total_tuples_read"] == before


class TestCrashAtomicityAndStaleness:
    def test_kill_mid_save_falls_back_to_newest_complete_step(self, dataset, targets, tmp_path):
        _, _, ported = dataset
        a = _serve_and_save("port", ported, targets, tmp_path)
        orphan = tmp_path / "step_9999.tmp.4190001"
        orphan.mkdir()
        (orphan / "arr_0.npy").write_bytes(b"half-written junk")
        (tmp_path / "LATEST").write_text("")
        b = _restore("port", ported, tmp_path)
        assert torch.equal(a.scheduler.state.counts, b.scheduler.state.counts)
        b.save_cache()
        assert not orphan.exists()
        assert (tmp_path / "LATEST").read_text().startswith("step_")

    @pytest.mark.parametrize("writer", ["ref", "port"])
    @pytest.mark.parametrize("reader", ["ref", "port"])
    @pytest.mark.parametrize("stale", ["layout", "v_x", "spec"])
    def test_stale_snapshot_rejected(self, dataset, targets, tmp_path, writer, reader, stale):
        ds, blocked, _ = dataset
        _serve_and_save(writer, _data(writer, dataset), targets, tmp_path)
        kw = {}
        if stale == "layout":
            other = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=6)
        elif stale == "v_x":
            other = block_layout(ds.z, np.minimum(ds.x, 7), v_z=64, v_x=8, block_size=512,
                                 seed=5)
        else:
            other, kw = blocked, dict(max_queries=8)
        data = _port(other) if reader == "port" else other
        with pytest.raises(ValueError, match="config hash"):
            _restore(reader, data, tmp_path, **kw)

    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_missing_checkpoint_raises(self, dataset, tmp_path, pkg):
        with pytest.raises(FileNotFoundError):
            _restore(pkg, _data(pkg, dataset), tmp_path / "empty")


class TestAutosave:
    def test_retirement_cadence(self, dataset, targets, tmp_path):
        _, _, ported = dataset
        server = _server("port", ported, str(tmp_path), autosave_every=1)
        for t in targets:
            server.submit(t, k=K, eps=EPS, delta=DELTA)
        server.run_until_idle()
        assert server._manager.latest_step() is not None
        b = _restore("port", ported, tmp_path)
        assert torch.equal(server.scheduler.state.counts, b.scheduler.state.counts)

    def test_round_cadence_same_steps_as_reference(self, dataset, targets, tmp_path):
        steps = []
        for pkg in ("port", "ref"):
            server = _server(pkg, _data(pkg, dataset), str(tmp_path / pkg), autosave_every=0,
                             autosave_rounds=1, checkpoint_keep_last=100)
            server.submit(targets[0], k=K, eps=EPS, delta=DELTA)
            server.run_until_idle()
            steps.append(server._manager.all_steps())
        assert steps[0] == steps[1] and steps[0]

    def test_save_without_new_rounds_bumps_step(self, dataset, targets, tmp_path):
        _, _, ported = dataset
        _serve_and_save("port", ported, targets, tmp_path)
        b = _restore("port", ported, tmp_path)
        before = b._manager.latest_step()
        b.save_cache()
        assert b._manager.latest_step() == before + 1

    def test_no_checkpoint_dir_save_refused(self, dataset):
        server = _server("port", dataset[2], None)
        with pytest.raises(RuntimeError, match="checkpoint_dir"):
            server.save_cache()
        with pytest.raises(RuntimeError, match="checkpoint_dir"):
            server.restore_cache()

    def test_counter_past_int32_refused(self, dataset, tmp_path):
        """The reference's files hold int32 counters; a larger one is
        refused rather than wrapped."""
        server = _server("port", dataset[2], str(tmp_path))
        sched = server.scheduler
        sched.cursor = sched.cursor._replace(tuples_read=torch.tensor(2**31, dtype=torch.int64))
        with pytest.raises(ValueError, match="int32"):
            server.save_cache()
