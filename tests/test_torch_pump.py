"""The port's data-parallel pump against the port's single-stream
scheduler, on the CPU.

Every case runs in gloo ranks (`distributed.run_ranks`, one process a
rank) at the reference's test shapes (64 x 16, 300K tuples, blocks of
512, windows of 32; `tests/test_pump.py`), and each rank drives the
port's `SharedCountsScheduler` beside its `DistributedPump`:

  * lockstep: the same 12 shuffled global windows through both, with a
    mid-stream admission and retirements, at (data, model) in {(1, 1),
    (2, 1), (4, 1), (2, 2)} and on a (pod, data, model) = (2, 2, 1) mesh
    whose workers span pod x data: counts, n, tau, delta_upper, read mask,
    counters and live slots bitwise every round (the plain plans score
    each row on its own, so a shard's tau is the full matrix's);
  * the `pump()` loop and `MatchServer(mesh=, pump=True)` resolve the
    same queries to the same sets, with fewer rounds; ``prefetch=True``
    changes no bit; `MatchServer(mesh=)` (counts sliced over the model
    axis, one stream) is bitwise the single-device server;
  * exact completion lands on the true counts; snapshots move between
    the pump and the scheduler; each ``round_batch`` event carries every
    worker's gather seconds;
  * the construction guards of `tests/test_pump.py:300`.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import distributed
from repro_torch.core import multiquery as mq

K, EPS, DELTA = 5, 0.08, 0.02


def _scenario():
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec, make_dataset, perturb_distribution

    ds = make_dataset(SynthSpec(v_z=64, v_x=16, num_tuples=300_000, k=5, n_close=5, seed=3))
    blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=3)
    spec = mq.MultiQuerySpec(v_z=64, v_x=16, max_queries=4)
    rng = np.random.default_rng(9)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.03, 0.05)]
    return blocked, spec, targets


def _same_state(ref, pmp) -> dict:
    counts, n = pmp._full_counts()
    return dict(
        counts=torch.equal(counts, ref.state.counts),
        n=torch.equal(n, ref.state.n),
        tau=torch.equal(pmp.state.tau, ref.state.tau),
        du=torch.equal(pmp.state.delta_upper, ref.state.delta_upper),
        mask=bool(np.array_equal(ref.read_mask, pmp.read_mask)),
        counters=(ref.blocks_read, ref.blocks_considered, ref.tuples_read, ref.rounds)
        == (pmp.blocks_read, pmp.blocks_considered, pmp.tuples_read, pmp.rounds),
        live=sorted(ref.tickets) == sorted(pmp.tickets),
    )


def _lockstep(blocked, spec, targets, mesh, prefetch=False, data_axes=("data",)) -> dict:
    from repro_torch.core.pump import DistributedPump

    ref = mq.SharedCountsScheduler(blocked, spec, window=32, seed=0, start_block=7, device="cpu")
    pmp = DistributedPump(blocked, spec, mesh=mesh, window=32, seed=0, start_block=7,
                          prefetch=prefetch, data_axes=data_axes)
    for t in targets[:3]:
        ref.admit(t, k=K, eps=EPS, delta=DELTA)
        pmp.admit(t, k=K, eps=EPS, delta=DELTA)
    # shuffled windows, so every round straddles the workers' ranges
    order = np.random.default_rng(1).permutation(blocked.num_blocks)
    checks = []
    for r in range(12):
        if r == 3:  # mid-stream admission into the free slot
            ref.admit(targets[3], k=3, eps=0.1, delta=DELTA)
            pmp.admit(targets[3], k=3, eps=0.1, delta=DELTA)
        win = order[r * 32 : (r + 1) * 32]
        ref.run_window(win)
        pmp.run_window(win)
        ref._poll_terminated()  # mid-stream retirement
        pmp._poll_terminated()
        checks.append(_same_state(ref, pmp))
    flat = {k: all(c[k] for c in checks) for k in checks[0]}
    flat["retired"] = len(ref.outcomes)
    flat["ids"] = set(ref.outcomes) == set(pmp.outcomes) and all(
        np.array_equal(ref.outcomes[q].ids, pmp.outcomes[q].ids) for q in ref.outcomes)
    return flat


def _serve(blocked, targets, **kw):
    from repro_torch.serve import MatchServer

    srv = MatchServer(blocked, max_queries=4, lookahead=64, seed=11, **kw)
    rids = [srv.submit(t, k=5, eps=0.08, delta=0.05) for t in targets]
    res = srv.run_until_idle()
    return srv, [res[r] for r in rids]


def _ranks(rank, world, shape, extra):
    """One gloo rank; rank 0 returns the checks."""
    from repro_torch.core.pump import DistributedPump
    from repro_torch.obs import Telemetry

    blocked, spec, targets = _scenario()
    if len(shape) == 3:  # the reference's ("pod", "data", "model") mesh
        mesh = distributed.init_mesh(shape, ("pod", "data", "model"), device_type="cpu")
        out = {"lockstep": _lockstep(blocked, spec, targets, mesh, data_axes=("pod", "data"))}
        return out if rank == 0 else None
    mesh = distributed.init_mesh(shape, device_type="cpu")
    out = {"lockstep": _lockstep(blocked, spec, targets, mesh)}
    if "prefetch" in extra:
        out["prefetch"] = _lockstep(blocked, spec, targets, mesh, prefetch=True)
    if "loop" in extra:
        # the whole pump() loop of a one-worker mesh is the scheduler's
        ref = mq.SharedCountsScheduler(blocked, spec, window=16, seed=0, start_block=5,
                                       device="cpu")
        pmp = DistributedPump(blocked, spec, mesh=mesh, window=16, seed=0, start_block=5)
        for s in (ref, pmp):
            s.admit(targets[0], k=3, eps=0.08, delta=0.05)
            s.pump(max_passes=2)
        out["loop"] = dict(_same_state(ref, pmp), outcomes=set(ref.outcomes) == set(pmp.outcomes)
                           and all(np.array_equal(ref.outcomes[q].ids, pmp.outcomes[q].ids)
                                   for q in ref.outcomes))
    if "server" in extra:
        plain, want = _serve(blocked, targets, device="cpu")
        srv, got = _serve(blocked, targets, mesh=mesh, pump=True)
        pre, got_pre = _serve(blocked, targets, mesh=mesh, pump=True, prefetch=True)
        sliced, got_sliced = _serve(blocked, targets, mesh=mesh)
        counts, _ = srv.scheduler._full_counts()
        counts_pre, _ = pre.scheduler._full_counts()
        out["server"] = dict(
            ids=all(sorted(g.ids.tolist()) == sorted(w.ids.tolist()) and g.exact == w.exact
                    for g, w in zip(got, want)),
            prefetch=all(np.array_equal(a.ids, b.ids) for a, b in zip(got_pre, got))
            and torch.equal(counts, counts_pre),
            fewer_rounds=srv.scheduler.rounds < plain.scheduler.rounds,
            sliced=all(np.array_equal(a.ids, b.ids) and torch.equal(a.state.tau, b.state.tau)
                       and torch.equal(a.state.counts, b.state.counts)
                       and a.tuples_read == b.tuples_read for a, b in zip(got_sliced, want)),
            plans=srv.kernel_plans == sliced.kernel_plans,
        )
    if "exact" in extra:
        ref = mq.SharedCountsScheduler(blocked, spec, window=32, seed=0, start_block=3,
                                       device="cpu")
        pmp = DistributedPump(blocked, spec, mesh=mesh, window=32, seed=0, start_block=3)
        for s in (ref, pmp):
            s.admit(targets[0], k=3, eps=0.02, delta=1e-9)
        order = np.random.default_rng(2).permutation(blocked.num_blocks)
        for r in range(4):
            win = order[r * 32 : (r + 1) * 32]
            ref.run_window(win)
            pmp.run_window(win)
        ref.complete_remaining()
        pmp.complete_remaining()
        same = _same_state(ref, pmp)
        # the completion's rounds are each worker's windows, not the
        # single stream's: every other counter is equal
        same["counters"] = (ref.blocks_read, ref.blocks_considered, ref.tuples_read) == (
            pmp.blocks_read, pmp.blocks_considered, pmp.tuples_read)
        out["exact"] = dict(same, all_read=bool(pmp.read_mask.all()))
    if "cache" in extra:
        pmp = DistributedPump(blocked, spec, mesh=mesh, window=16, seed=0, start_block=5)
        pmp.admit(targets[0], k=3, eps=0.08, delta=0.05)
        pmp.pump(max_passes=1)
        snap = pmp.export_cache()
        plain = mq.SharedCountsScheduler(blocked, spec, window=16, seed=9, device="cpu")
        plain.import_cache(snap)
        back = DistributedPump(blocked, spec, mesh=mesh, window=16, seed=7)
        back.import_cache(plain.export_cache())
        counts, n = back._full_counts()
        out["cache"] = dict(
            shape=tuple(snap.read_mask.shape) == (blocked.num_blocks,),
            plain=torch.equal(plain.state.counts, snap.counts)
            and bool(np.array_equal(plain.read_mask, pmp.read_mask)),
            back=torch.equal(counts, snap.counts) and torch.equal(n, snap.n)
            and bool(np.array_equal(back.read_mask, pmp.read_mask))
            and (back.rounds, back.tuples_read, back.blocks_read)
            == (pmp.rounds, pmp.tuples_read, pmp.blocks_read),
        )
    if "telemetry" in extra:
        tel = Telemetry(device="cpu")
        pmp = DistributedPump(blocked, spec, mesh=mesh, window=32, seed=0, start_block=7,
                              telemetry=tel)
        pmp.admit(targets[0], k=K, eps=EPS, delta=DELTA)
        pmp.pump(max_passes=1)
        events = tel.tracer.events("round_batch")
        out["telemetry"] = dict(
            events=len(events) > 0,
            workers=all(len(e["worker_gather_s"]) == pmp.num_workers for e in events),
            gathered=sum(sum(e["worker_gather_s"]) for e in events) > 0.0,
            assemble=all(e["assemble_s"] >= 0.0 for e in events),
        )
    if "guards" in extra:
        from repro_torch.io import InMemorySource
        from repro_torch.serve import MatchServer

        out["guards"] = {}

        def refused(name, exc, fn, match):
            try:
                fn()
            except exc as e:
                out["guards"][name] = match in str(e)
            else:
                out["guards"][name] = False

        refused("source", TypeError,
                lambda: DistributedPump(InMemorySource(blocked, device="cpu"), spec, mesh=mesh),
                "BlockedDataset")
        refused("axis", ValueError,
                lambda: DistributedPump(blocked, spec, mesh=mesh, data_axes=("pod",)), "no axis")
        refused("no_blocks", ValueError,
                lambda: DistributedPump(_tiny(blocked, 1), spec, mesh=mesh), "no blocks")
        odd = mq.MultiQuerySpec(v_z=63, v_x=16, max_queries=4)
        refused("v_z", ValueError,
                lambda: distributed.make_pump_round(mesh, odd, blocks_per_worker=8), "divide")
        refused("pump_needs_mesh", ValueError, lambda: MatchServer(blocked, pump=True), "mesh")
        refused("data_axes_need_pump", ValueError,
                lambda: MatchServer(blocked, mesh=mesh, data_axes=("model",)), "pump")
    return out if rank == 0 else None


def _tiny(blocked, num_blocks):
    from repro_torch.data.layout import BlockedDataset

    return BlockedDataset(blocked.z_blocks[:num_blocks], blocked.x_blocks[:num_blocks],
                          blocked.bitmap[:num_blocks], blocked.v_z, blocked.v_x)


_EXTRA = {
    (1, 1): ("loop",),
    (2, 1): ("prefetch", "exact"),
    (4, 1): ("server", "telemetry"),
    (2, 2): ("exact", "cache", "guards"),
    (2, 2, 1): (),  # pod x data workers: one fiber group over two axes
}


@pytest.fixture(scope="module")
def runs():
    return {shape: distributed.run_ranks(_ranks, int(np.prod(shape)), shape, extra,
                                         device_type="cpu", timeout=300)[0]
            for shape, extra in _EXTRA.items()}


@pytest.mark.slow
@pytest.mark.parametrize("shape", list(_EXTRA), ids=lambda s: "x".join(map(str, s)))
def test_lockstep_bitwise_scheduler(runs, shape):
    res = runs[shape]["lockstep"]
    assert res.pop("retired") > 0, res  # the drive retires queries
    assert all(res.values()), res


@pytest.mark.slow
def test_prefetch_changes_no_bit(runs):
    res = runs[(2, 1)]["prefetch"]
    res.pop("retired")
    assert all(res.values()), res


@pytest.mark.slow
def test_one_worker_pump_loop_is_the_scheduler(runs):
    res = runs[(1, 1)]["loop"]
    assert all(res.values()), res


@pytest.mark.slow
def test_pump_server_answers(runs):
    """4 workers: the single-stream answers in fewer rounds; prefetch
    changes no bit; the sliced-counts server is bitwise the plain one."""
    res = runs[(4, 1)]["server"]
    assert all(res.values()), res


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_exact_completion_lockstep(runs, shape):
    res = runs[shape]["exact"]
    assert all(res.values()), res


@pytest.mark.slow
def test_cache_roundtrip_interchangeable(runs):
    res = runs[(2, 2)]["cache"]
    assert all(res.values()), res


@pytest.mark.slow
def test_round_batch_carries_every_worker(runs):
    res = runs[(4, 1)]["telemetry"]
    assert all(res.values()), res


@pytest.mark.slow
@pytest.mark.parametrize(
    "guard", ["source", "axis", "no_blocks", "v_z", "pump_needs_mesh", "data_axes_need_pump"])
def test_construction_guards(runs, guard):
    assert runs[(2, 2)]["guards"][guard], runs[(2, 2)]["guards"]
