"""The port's FastMatch engine end to end against the JAX reference.

Both packages run `run_engine` on the fixture of tests/test_histsim.py
(V_Z=80, V_X=16, 3M tuples, k=8, eps=0.08, delta=0.05), the port on the
CPU through its plain kernel versions. Returned ids, the read counters,
rounds, passes and ``exact`` must be equal, and so must the counts; tau
agrees to 2e-5. A state carry-over test starts both packages' fused
round from the same mid-run state and compares every leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import histsim as jhistsim
from repro.core import multiquery as jmq
from repro.core.engine import EngineConfig, run_engine
from repro.core.histsim import HistSimParams
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import histsim as thistsim
from repro_torch.core import multiquery as tmq
from repro_torch.io import InMemorySource

PARAMS = dict(k=8, eps=0.08, delta=0.05)
TAU_ATOL = 2e-5
RESULT_FIELDS = (
    "ids", "blocks_read", "blocks_considered", "tuples_read", "rounds", "passes", "exact",
)


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(
        v_z=80, v_x=16, num_tuples=3_000_000, k=8, n_close=8,
        close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=7,
    )
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=7)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return spec, ds, blocked, ported


def _run_both(dataset, **cfg):
    spec, ds, blocked, ported = dataset
    want = run_engine(
        blocked, ds.target, HistSimParams(v_z=spec.v_z, v_x=spec.v_x, **PARAMS),
        EngineConfig(**cfg),
    )
    got = tengine.run_engine(
        ported, ds.target, thistsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, **PARAMS),
        tengine.EngineConfig(**cfg), device="cpu",
    )
    return got, want


def _assert_same_result(got, want):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f
        )
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_array_equal(got.state.n.numpy(), np.asarray(want.state.n))
    np.testing.assert_allclose(got.state.tau.numpy(), np.asarray(want.state.tau), atol=TAU_ATOL)
    np.testing.assert_allclose(got.delta_upper, want.delta_upper, rtol=1e-5, atol=1e-12)


ENGINE_CASES = [
    dict(variant="fastmatch", seed=0),
    dict(variant="fastmatch", seed=3),
    dict(variant="fastmatch", seed=6),
    dict(variant="fastmatch", seed=1, poll_every=4, lookahead=64),
    dict(variant="scan", seed=4, start_block=0),
    dict(variant="scanmatch", seed=4, start_block=0),
    dict(variant="slowmatch", seed=4, start_block=0),
    dict(variant="syncmatch", seed=5, max_rounds=40),
    dict(variant="fastmatch", seed=0, max_rounds=1, lookahead=16),
]


class TestEngineAgainstReference:
    @pytest.mark.parametrize(
        "cfg", ENGINE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items())
    )
    def test_same_answer(self, dataset, cfg):
        got, want = _run_both(dataset, **cfg)
        _assert_same_result(got, want)

    def test_fastmatch_is_sublinear(self, dataset):
        _, _, blocked, _ = dataset
        got, _ = _run_both(dataset, variant="fastmatch", seed=3)
        assert not got.exact
        assert got.blocks_read < 0.5 * blocked.num_blocks

    def test_scan_reads_everything(self, dataset):
        _, ds, blocked, ported = dataset
        res = tengine.run_engine(
            ported, ds.target, thistsim.HistSimParams(v_z=80, v_x=16, **PARAMS),
            tengine.EngineConfig(variant="scan"), device="cpu",
        )
        assert res.exact and res.blocks_read == blocked.num_blocks
        assert sorted(res.ids.tolist()) == sorted(ds.true_top_k.tolist())
        np.testing.assert_allclose(res.state.tau.numpy(), ds.true_dists, atol=TAU_ATOL)

    def test_host_resident_source_same_answer(self, dataset):
        _, ds, _, ported = dataset
        params = thistsim.HistSimParams(v_z=80, v_x=16, **PARAMS)
        cfg = tengine.EngineConfig(variant="fastmatch", seed=3, lookahead=128)
        a = tengine.run_engine(InMemorySource(ported, device="cpu"), ds.target, params, cfg)
        b = tengine.run_engine(
            InMemorySource(ported, device_resident=False, device="cpu"), ds.target, params, cfg
        )
        _assert_same_result(a, b)

    def test_prefetch_not_ported(self, dataset):
        """Ported since: prefetch=True gives the reference's answer with
        prefetch, and the port's without it."""
        _, ds, blocked, ported = dataset
        params = thistsim.HistSimParams(v_z=80, v_x=16, **PARAMS)
        got = tengine.run_engine(ported, ds.target, params,
                                 tengine.EngineConfig(prefetch=True), device="cpu")
        _assert_same_result(got, tengine.run_engine(ported, ds.target, params,
                                                    tengine.EngineConfig(), device="cpu"))
        want = run_engine(blocked, ds.target, HistSimParams(v_z=80, v_x=16, **PARAMS),
                          EngineConfig(prefetch=True))
        _assert_same_result(got, want)
        assert (got.degraded, got.eps_effective) == (want.degraded, want.eps_effective)


@pytest.mark.parametrize("v_x", [1440, 4100])
def test_fastmatch_at_wide_vx(v_x):
    """FastMatch at a V_X past the port's narrow branch (1024), where tau
    takes kernel C's wide branch on the card; 4100 is past the
    reference's single-sweep 4096 too, so its two-sweep layout runs. The
    port runs on the CPU through the plain version."""
    spec = SynthSpec(v_z=31, v_x=v_x, num_tuples=300_000, k=5, n_close=5, close_distance=0.05,
                     far_distance=0.45, zipf_a=0.3, seed=v_x)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=31, v_x=v_x, block_size=256, seed=v_x)
    ported = convert.dataset_from_numpy(blocked.z_blocks, blocked.x_blocks, blocked.bitmap,
                                        31, v_x)
    kw = dict(v_z=31, v_x=v_x, k=5, eps=0.5, delta=0.05)
    cfg = dict(variant="fastmatch", seed=1, lookahead=64)
    want = run_engine(blocked, ds.target, HistSimParams(**kw), EngineConfig(**cfg))
    got = tengine.run_engine(ported, ds.target, thistsim.HistSimParams(**kw),
                             tengine.EngineConfig(**cfg), device="cpu")
    _assert_same_result(got, want)


@pytest.mark.parametrize("criterion", ["histsim", "slowmatch"])
def test_histsim_round_matches_reference(dataset, criterion):
    """The single-query HistSim state: init, one ingest, one stats step."""
    spec, ds, blocked, _ = dataset
    jp = jhistsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, criterion=criterion, **PARAMS)
    tp = thistsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, criterion=criterion, **PARAMS)
    z, x = blocked.z_blocks[:40].reshape(-1), blocked.x_blocks[:40].reshape(-1)
    want = jhistsim.init_state(jp, jnp.asarray(ds.target))
    got = thistsim.init_state(tp, ds.target, device="cpu")
    for name in thistsim.HistSimState._fields:
        _assert_leaf(name, getattr(got, name), np.asarray(getattr(want, name)))
    want = jhistsim.stats_step(
        jhistsim.ingest(want, jnp.asarray(z), jnp.asarray(x), params=jp), params=jp
    )
    got = thistsim.stats_step(
        thistsim.ingest(got, torch.from_numpy(z), torch.from_numpy(x), params=tp), params=tp
    )
    for name in thistsim.HistSimState._fields:
        _assert_leaf(name, getattr(got, name), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(
        thistsim.top_k_ids(got, 8).numpy(), np.asarray(jhistsim.top_k_ids(want, 8))
    )


@pytest.mark.parametrize("metric", ["chi2", "hellinger"])
def test_scheduler_metric_matches_reference(dataset, metric):
    """The spec's metric threads through tau (kernel C's metric switch)
    and the native failure bounds, as in the reference's scheduler."""
    spec, ds, blocked, ported = dataset
    shape = dict(v_z=spec.v_z, v_x=spec.v_x, max_queries=1, k_cap=8, metric=metric)
    ref = jmq.SharedCountsScheduler(blocked, jmq.MultiQuerySpec(**shape), window=256, seed=2)
    port = tmq.SharedCountsScheduler(
        ported, tmq.MultiQuerySpec(**shape), window=256, seed=2, device="cpu"
    )
    for sched in (ref, port):
        sched.admit(ds.target, **PARAMS)
        sched.pump()
    want, got = ref.outcomes[0], port.outcomes[0]
    for f in ("ids", "rounds", "passes", "blocks_read", "tuples_read", "exact", "terminated"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f
        )
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_allclose(got.state.tau.numpy(), np.asarray(want.state.tau), atol=TAU_ATOL)
    assert port.host_syncs == ref.host_syncs


def _leaves(named_tuple) -> dict:
    return {k: np.asarray(v) for k, v in jax.device_get(named_tuple)._asdict().items()}


def _assert_leaf(name, got: torch.Tensor, want: np.ndarray):
    g = got.cpu().numpy()
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.shape == want.shape, name
    if want.dtype == np.float32:
        if name in ("counts", "n"):
            np.testing.assert_array_equal(g, want, err_msg=name)
        else:
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=TAU_ATOL, err_msg=name)
    else:
        np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=name)


class TestStateCarryOver:
    def test_fused_round_from_converted_state(self, dataset):
        """Run the reference scheduler for 5 windows, carry its state and
        cursor across, and run one more fused round in both packages."""
        spec, ds, blocked, ported = dataset
        jspec = jmq.MultiQuerySpec(v_z=spec.v_z, v_x=spec.v_x, max_queries=2, k_cap=8)
        sched = jmq.SharedCountsScheduler(
            blocked, jspec, policy="anyactive", window=64, seed=0, start_block=0
        )
        sched.admit(ds.target, **PARAMS)
        windows = [sched.order[i * 64 : (i + 1) * 64] for i in range(6)]
        for win in windows[:5]:
            sched.run_window(win)
        assert sched.blocks_read > 0

        state = convert.multi_state_from_numpy(_leaves(sched.state), device="cpu")
        cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
        wd_ref = sched.source.fetch(windows[5], pad_to=64)
        ref_state, ref_cursor = jmq.fused_round(
            sched.state, sched.cursor, wd_ref, spec=jspec, policy="anyactive", plans=sched.plans
        )
        tspec = tmq.MultiQuerySpec(v_z=spec.v_z, v_x=spec.v_x, max_queries=2, k_cap=8)
        wd = InMemorySource(ported, device="cpu").fetch(windows[5], pad_to=64)
        for name in ("z", "x", "bitmap", "valid"):
            want = np.asarray(getattr(wd_ref, name))
            # the port's window may carry the whole bitmap table: compare its rows
            got = (wd.bitmap_rows() if name == "bitmap" else getattr(wd, name)).numpy()
            np.testing.assert_array_equal(got.view(want.dtype), want, err_msg=name)
        new_state, new_cursor = tmq.fused_round(state, cursor, wd, spec=tspec, policy="anyactive")

        ref_leaves = _leaves(ref_state)
        for name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(new_state, name), ref_leaves[name])
        ref_cur = _leaves(ref_cursor)
        for name in tmq.SampleCursor._fields:
            _assert_leaf(name, getattr(new_cursor, name), ref_cur[name])
        assert int(new_cursor.blocks_read) > sched.blocks_read  # the round read something

    def test_round_that_reads_nothing_keeps_state(self, dataset):
        """round_idx advances only on rounds that read (the reference's
        lax.cond), here by selecting the old state on the device."""
        spec, ds, _, ported = dataset
        tspec = tmq.MultiQuerySpec(v_z=spec.v_z, v_x=spec.v_x, max_queries=1, k_cap=8)
        sched = tmq.SharedCountsScheduler(
            ported, tspec, window=32, start_block=0, device="cpu"
        )
        sched.admit(ds.target, **PARAMS)
        win = sched.order[:32]
        sched.run_window(win)
        before = sched.state
        sched.run_window(win)  # every block already read: nothing marked
        assert int(sched.state.round_idx) == int(before.round_idx)
        assert torch.equal(sched.state.counts, before.counts)
        assert sched.rounds == 2 and sched.blocks_read == 32

    def test_rejects_closeness_state(self):
        """Closeness slots are carried now; a query type neither package
        knows is still refused."""
        spec = jmq.MultiQuerySpec(v_z=40, v_x=4, max_queries=2)
        leaves = _leaves(jmq.init_multi_state(spec))
        leaves["qtype"] = np.array([0, 2], np.int32)
        with pytest.raises(ValueError, match="qtype"):
            convert.multi_state_from_numpy(leaves, device="cpu")
        leaves["qtype"] = np.array([0, 1], np.int32)
        state = convert.multi_state_from_numpy(leaves, device="cpu")
        assert state.qtype.dtype == torch.int64 and state.qtype.tolist() == [0, 1]
        assert state.active_words.dtype == torch.int32 and state.k.dtype == torch.int64
        ref_words = jnp.full((2,), 0xFFFFFFFF, jnp.uint32)
        leaves["union_words"] = np.asarray(ref_words)
        state = convert.multi_state_from_numpy(leaves, device="cpu")
        assert state.union_words.tolist() == [-1, -1]
