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

Elastic restarts run in gloo ranks (`distributed.run_ranks`) on the
reference's `TestReshardedRestore` fixture (400K tuples): a snapshot of
one device restores onto a 4-rank mesh whose counts are sliced over the
model axis and, re-saved from there, onto 2 ranks; a 4-worker pump's
restores into a 2-worker pump and a single-device server; a snapshot
written by the reference's 8-way pump (8 forced host devices, in a
subprocess) restores into the port's 2-worker pump. Counts, n, read mask
and counters are bitwise in every case, and `distributed.place_cache`
slices a snapshot in memory the way the restore does.
"""

import os
import subprocess
import sys


import numpy as np
import pytest
import torch

from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import distributed
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


# ---------------------------------------------------------------------------
# elastic restarts across mesh shapes (gloo ranks)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_KW = dict(max_queries=4, lookahead=64)

_REFERENCE_PUMP = r"""
import sys, numpy as np, jax
from jax.sharding import Mesh
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer

spec = SynthSpec(v_z=64, v_x=16, num_tuples=400_000, k=5, n_close=5,
                 close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=5)
ds = make_dataset(spec)
blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=5)
rng = np.random.default_rng(9)
mesh8 = Mesh(np.array(jax.devices()).reshape(8, 1), ("data", "model"))
a = MatchServer(blocked, seed=3, checkpoint_dir=sys.argv[1], mesh=mesh8, pump=True,
                max_queries=4, lookahead=64)
for d in (0.0, 0.01, 0.03):
    a.submit(perturb_distribution(ds.target, d, rng) if d else ds.target,
             k=5, eps=0.08, delta=0.05)
a.run_until_idle()
a.save_cache()
sc = a.scheduler
np.savez(sys.argv[2], counts=np.asarray(sc.state.counts), n=np.asarray(sc.state.n),
         mask=sc.read_mask, ctr=np.asarray([sc.rounds, sc.passes, sc.blocks_read,
                                            sc.blocks_considered, sc.tuples_read]))
"""


def _mesh_data():
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec as TSpec
    from repro_torch.data.synth import make_dataset as tmake

    spec = TSpec(v_z=64, v_x=16, num_tuples=400_000, k=5, n_close=5,
                 close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=5)
    ds = tmake(spec)
    return ds, block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=5)


def _cache_of(sched) -> dict:
    counts, n = sched._full_counts()
    return dict(counts=counts.numpy(), n=n.numpy(), mask=np.array(sched.read_mask),
                ctr=np.asarray([sched.rounds, sched.passes, sched.blocks_read,
                                sched.blocks_considered, sched.tuples_read]))


def _result_of(res) -> dict:
    return dict(ids=np.asarray(res.ids), tau=res.state.tau.numpy(), tuples=res.tuples_read,
                exact=res.exact)


def _hard(ds):
    return perturb_distribution(ds.target, 0.05, np.random.default_rng(11))


def _covered(ds):
    return perturb_distribution(ds.target, 0.02, np.random.default_rng(4))


def _ranks_four(rank, world, dirs):
    """4 ranks: the 1-device snapshot restored onto a (1, 4) mesh and
    re-saved; a (4, 1) pump serving and saving."""
    ds, blocked = _mesh_data()
    out = {}
    mesh = distributed.init_mesh((1, 4), device_type="cpu")
    b = MatchServer.restore(blocked, checkpoint_dir=dirs["one"], mesh=mesh, **MESH_KW)
    out["b_cache"] = _cache_of(b.scheduler)
    out["b_local_rows"] = b.scheduler.state.counts.shape[0]
    b.save_cache()  # the same cache, gathered, to a 4-rank step
    out["b_hard"] = _result_of(_answer(b, _hard(ds), eps=0.04, delta=0.01))
    pump_mesh = distributed.init_mesh((4, 1), device_type="cpu")
    a = MatchServer(blocked, seed=3, checkpoint_dir=dirs["pump"], mesh=pump_mesh, pump=True,
                    **MESH_KW)
    rng = np.random.default_rng(9)
    for d in (0.0, 0.01, 0.03):
        a.submit(perturb_distribution(ds.target, d, rng) if d else ds.target,
                 k=K, eps=EPS, delta=DELTA)
    a.run_until_idle()
    a.save_cache()
    out["pump_cache"] = _cache_of(a.scheduler)
    out["pump_covered"] = _result_of(_answer(a, _covered(ds), eps=EPS, delta=DELTA))
    out["pump_hard"] = _result_of(_answer(a, _hard(ds), eps=0.04, delta=0.01))
    return out if rank == 0 else None


def _ranks_two(rank, world, dirs):
    """2 ranks: the 4-rank step onto a (1, 2) mesh; the 4-worker pump's
    step into a 2-worker pump and a plain server; the reference's 8-way
    pump step into a 2-worker pump; `place_cache` in memory."""
    ds, blocked = _mesh_data()
    out = {}
    mesh = distributed.init_mesh((1, 2), device_type="cpu")
    c = MatchServer.restore(blocked, checkpoint_dir=dirs["one"], mesh=mesh, **MESH_KW)
    out["c_cache"] = _cache_of(c.scheduler)
    out["c_hard"] = _result_of(_answer(c, _hard(ds), eps=0.04, delta=0.01))
    pump_mesh = distributed.init_mesh((2, 1), device_type="cpu")
    for tag, d in (("pump", dirs["pump"]), ("ref", dirs["ref"])):
        b = MatchServer.restore(blocked, checkpoint_dir=d, mesh=pump_mesh, pump=True, **MESH_KW)
        out[f"{tag}2_cache"] = _cache_of(b.scheduler)
        if tag == "pump":
            plain = MatchServer.restore(blocked, checkpoint_dir=d, device="cpu", **MESH_KW)
            out["plain_cache"] = _cache_of(plain.scheduler)
            for name, srv in (("pump2", b), ("plain", plain)):
                out[f"{name}_covered"] = _result_of(_answer(srv, _covered(ds), eps=EPS,
                                                            delta=DELTA))
                out[f"{name}_hard"] = _result_of(_answer(srv, _hard(ds), eps=0.04, delta=0.01))
    sched = tmq.SharedCountsScheduler(blocked, tmq.MultiQuerySpec(v_z=64, v_x=16, max_queries=2),
                                      window=64, seed=1, device="cpu")
    sched.admit(ds.target, k=K, eps=EPS, delta=DELTA)
    sched.pump()
    snap = sched.export_cache()
    placed = distributed.place_cache(snap, mesh)
    rows = slice(32 * rank, 32 * (rank + 1))
    out["placed"] = dict(
        counts=torch.equal(placed.counts, snap.counts[rows]),
        n=torch.equal(placed.n, snap.n[rows]),
        mask=torch.equal(placed.read_mask, snap.read_mask),
        counters=all(torch.equal(getattr(placed, f), getattr(snap, f))
                     for f in tmq.CacheSnapshot._fields[3:]),
    )
    return out if rank == 0 else [out["placed"]]


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    """(the single-device server's cache and answer, 4-rank records,
    2-rank records, the reference pump's cache)."""
    root = tmp_path_factory.mktemp("reshard")
    dirs = {k: str(root / k) for k in ("one", "pump", "ref")}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_npz = str(root / "ref.npz")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_PUMP, dirs["ref"], ref_npz],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ds, blocked = _mesh_data()
        a = MatchServer(blocked, seed=3, checkpoint_dir=dirs["one"], device="cpu", **MESH_KW)
        a.submit(ds.target, k=5, eps=0.08, delta=0.05)
        a.run_until_idle()
        a.save_cache()
        one = dict(cache=_cache_of(a.scheduler),
                   hard=_result_of(_answer(a, _hard(ds), eps=0.04, delta=0.01)))
        four = distributed.run_ranks(_ranks_four, 4, dirs, timeout=300)[0]
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        two = distributed.run_ranks(_ranks_two, 2, dirs, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    return one, four, two, dict(np.load(ref_npz))


def _assert_cache(got: dict, want: dict):
    for key in ("counts", "n", "mask", "ctr"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.slow
class TestReshardedRestore:
    def test_reshard_1_to_4_to_2(self, resharded):
        """A 1-device snapshot restores onto 4 ranks (counts sliced over the
        model axis), is re-saved from there and restores onto 2; a fresh
        query then follows one trajectory on all three."""
        one, four, two, _ = resharded
        assert four["b_local_rows"] == 16
        _assert_cache(four["b_cache"], one["cache"])
        _assert_cache(two[0]["c_cache"], one["cache"])
        for got in (four["b_hard"], two[0]["c_hard"]):
            np.testing.assert_array_equal(got["ids"], one["hard"]["ids"])
            np.testing.assert_array_equal(got["tau"], one["hard"]["tau"])
            assert got["tuples"] == one["hard"]["tuples"]

    def test_pump_reshard_4_to_2_workers(self, resharded):
        """A 4-worker pump's snapshot restores into a 2-worker pump and a
        single-device server bitwise; a covered query answers with no
        I/O, bitwise, on every width; a demanding one agrees as a set."""
        _, four, two, _ = resharded
        rec = two[0]
        _assert_cache(rec["pump2_cache"], four["pump_cache"])
        _assert_cache(rec["plain_cache"], four["pump_cache"])
        for name in ("pump2", "plain"):
            got, want = rec[f"{name}_covered"], four["pump_covered"]
            np.testing.assert_array_equal(got["ids"], want["ids"])
            np.testing.assert_array_equal(got["tau"], want["tau"])
            assert got["tuples"] == want["tuples"] == 0
            hard = rec[f"{name}_hard"]
            assert sorted(hard["ids"].tolist()) == sorted(four["pump_hard"]["ids"].tolist())
            assert hard["exact"] == four["pump_hard"]["exact"]

    def test_reference_pump_snapshot_restores_in_port_pump(self, resharded):
        """The reference's 8-way pump's snapshot, restored by the port's
        2-worker pump: counts, n, read mask and counters bitwise."""
        _, _, two, want = resharded
        _assert_cache(two[0]["ref2_cache"], want)


@pytest.mark.slow
def test_place_cache_reshard_in_memory(resharded):
    """`place_cache` keeps each rank's model rows of the counts and n and
    the whole read mask and counters, on the mesh's device."""
    _, _, two, _ = resharded
    for placed in (two[0]["placed"], two[1][0]):
        assert all(placed.values()), placed
