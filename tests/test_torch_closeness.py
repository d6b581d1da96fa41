"""The port's closeness rule, pruning, mixed-slot statistics and warm
cache against the JAX reference.

`assign_closeness` and `prune_far` are held against the reference per
slot on seeded tau and n (three metrics, both bound modes, tau exactly
at the threshold eps + gap/2, rows with n = 0, per-slot eps and gap):
labels, active and pruned masks bitwise, bounds and deviations within
rtol 1e-5. ``log_delta_i = V_X log 2 - b^2 n / 2`` is a difference of
two terms of size ~V_X log 2, so a one-ulp difference in the metric's
budget b (XLA's and PyTorch's sqrt differ by one ulp on some inputs)
leaves it ~1e-5 apart near zero: it is held within rtol 1e-5 of those
terms, and the failure bounds built from it within the same relative
error. `apply_stats`, `stats_step` and `fused_round` start from a
reference state with top-k, closeness and empty slots (carried over by
`convert`), with pruning on and off, and every leaf is compared.
The warm cache round-trips through `export_cache`/`import_cache`, and
`cache_config_hash` equals the reference's for the same data and spec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deviations as jdev
from repro.core import multiquery as jmq
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro_torch import convert
from repro_torch.core import deviations as tdev
from repro_torch.core import multiquery as tmq
from repro_torch.io import InMemorySource

RTOL = 1e-5
TAU_ATOL = 2e-5
METRICS = ["l1", "chi2", "hellinger"]
CLOSE_FIELDS = ("in_top_k", "split", "eps_i", "log_delta_i", "delta_upper", "active")


def _np(t):
    return t.detach().cpu().numpy()


def _log_delta_atol(v_x: int) -> float:
    """rtol 1e-5 of the terms of log delta = V_X log 2 - b^2 n / 2."""
    return RTOL * v_x * np.log(2.0)


def _assert_close_state(got, want, msg, v_x=16):
    for f in CLOSE_FIELDS:
        g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{f} {msg}")
        else:
            atol = _log_delta_atol(v_x) if f in ("log_delta_i", "delta_upper") else 1e-7
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=f"{f} {msg}")


def _slot_inputs(seed=0, v_z=64):
    """(Q=3, V_Z) tau with entries exactly at each slot's threshold, n
    with zero rows, per-slot eps, gap, delta."""
    rng = np.random.default_rng(seed)
    eps = np.array([0.05, 0.1, 0.2], np.float32)
    gap = np.array([0.1, 0.2, 0.05], np.float32)
    delta = np.array([0.01, 0.05, 0.1], np.float32)
    tau = rng.uniform(0.0, 0.8, size=(3, v_z)).astype(np.float32)
    threshold = eps + np.float32(0.5) * gap  # the f32 threshold both packages form
    tau[:, :4] = threshold[:, None]
    tau[:, 4] = eps  # on the close radius
    tau[:, 5] = eps + gap  # on the far radius
    n = rng.integers(0, 50_000, size=v_z).astype(np.float32)
    n[[0, 7, 13]] = 0.0
    return tau, n, eps, gap, delta


class TestAssignCloseness:
    @pytest.mark.parametrize("metric", METRICS)
    @pytest.mark.parametrize("bounds_mode", ["native", "conservative"])
    def test_slots_match_reference(self, metric, bounds_mode):
        tau, n, eps, gap, delta = _slot_inputs()
        got = tdev.assign_closeness(
            torch.from_numpy(tau), torch.from_numpy(n), eps=torch.from_numpy(eps),
            gap=torch.from_numpy(gap), delta=torch.from_numpy(delta), v_x=16,
            metric=metric, bounds_mode=bounds_mode,
        )
        assert _np(got.in_top_k)[:, :4].all()  # exactly at the threshold: close
        for q in range(3):
            want = jdev.assign_closeness(
                jnp.asarray(tau[q]), jnp.asarray(n), eps=jnp.float32(eps[q]),
                gap=jnp.float32(gap[q]), delta=jnp.float32(delta[q]), v_x=16,
                metric=metric, bounds_mode=bounds_mode,
            )
            _assert_close_state(tdev.DeviationState(*(leaf[q] for leaf in got)), want, f"slot {q}")

    def test_single_slot_and_scalars(self):
        tau, n, eps, gap, delta = _slot_inputs(1)
        got = tdev.assign_closeness(
            torch.from_numpy(tau[1]), torch.from_numpy(n), eps=float(eps[1]), gap=float(gap[1]),
            delta=float(delta[1]), v_x=16,
        )
        want = jdev.assign_closeness(
            jnp.asarray(tau[1]), jnp.asarray(n), eps=eps[1], gap=gap[1], delta=delta[1], v_x=16
        )
        assert got.in_top_k.shape == (64,) and got.delta_upper.dim() == 0
        _assert_close_state(got, want, "single")

    # the port of tests/test_metrics.py::TestBounds' closeness cases
    def test_labels_and_termination(self):
        tau = torch.tensor([0.02, 0.10, 0.19, 0.60])
        st = tdev.assign_closeness(tau, torch.full((4,), 1e5), eps=0.1, gap=0.1, delta=0.05, v_x=24)
        np.testing.assert_array_equal(_np(st.in_top_k), [True, True, False, False])
        np.testing.assert_allclose(_np(st.eps_i), [0.18, 0.10, 0.09, 0.50], rtol=1e-5)
        assert float(st.delta_upper) < 0.05
        assert not bool(st.active.any())

    def test_early_reject(self):
        tau = torch.tensor([0.21, 0.90])  # borderline, far
        for n in (2e3, 1e4, 1e5):
            st = tdev.assign_closeness(
                tau, torch.full((2,), n), eps=0.1, gap=0.2, delta=0.01, v_x=24
            )
            a = _np(st.active)
            if a[1]:
                assert a[0]  # far never outlasts borderline
        st = tdev.assign_closeness(tau, torch.full((2,), 2e3), eps=0.1, gap=0.2, delta=0.01, v_x=24)
        assert bool(st.active[0]) and not bool(st.active[1])

    @pytest.mark.parametrize("metric", ["chi2", "hellinger"])
    def test_other_metrics(self, metric):
        st = tdev.assign_closeness(
            torch.tensor([0.05, 0.5]), torch.full((2,), 1e6), eps=0.2, gap=0.2, delta=0.05,
            v_x=24, metric=metric,
        )
        np.testing.assert_array_equal(_np(st.in_top_k), [True, False])


class TestPruneFar:
    @pytest.mark.parametrize("metric", METRICS)
    def test_slots_match_reference(self, metric):
        tau, n, eps, gap, delta = _slot_inputs(2)
        n = n * 20.0  # enough samples that some candidates clear the edge
        far_edge = eps + gap
        got = _np(tdev.prune_far(
            torch.from_numpy(tau), torch.from_numpy(n), far_edge=torch.from_numpy(far_edge),
            delta=torch.from_numpy(delta), v_x=16, metric=metric,
        ))
        assert got.any() and not got.all()
        for q in range(3):
            want = jdev.prune_far(
                jnp.asarray(tau[q]), jnp.asarray(n), far_edge=jnp.float32(far_edge[q]),
                delta=jnp.float32(delta[q]), v_x=16, metric=metric,
            )
            np.testing.assert_array_equal(got[q], np.asarray(want), err_msg=f"slot {q}")
        assert not got[:, [0, 7, 13]].any()  # no sample, no certificate


# ---------------------------------------------------------------------------
# mixed-slot statistics from a carried-over reference state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(
        v_z=48, v_x=16, num_tuples=200_000, k=5, n_close=6,
        close_distance=0.03, far_distance=0.4, zipf_a=1.0, seed=3,
    )
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=48, v_x=16, block_size=512, seed=3)
    ported = convert.dataset_from_numpy(blocked.z_blocks, blocked.x_blocks, blocked.bitmap, 48, 16)
    rng = np.random.default_rng(4)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.05, 0.1)]
    return ds, blocked, ported, targets


def _leaves(named_tuple) -> dict:
    return {k: np.array(v) for k, v in jax.device_get(named_tuple)._asdict().items()}


def _assert_leaf(name, got: torch.Tensor, want: np.ndarray):
    g = _np(got)
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.shape == want.shape, name
    if want.dtype == np.float32:
        if name in ("counts", "n"):
            np.testing.assert_array_equal(g, want, err_msg=name)
        else:
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=TAU_ATOL, err_msg=name)
    else:
        np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=name)


def _mixed_reference(dataset, prune, metric="chi2", windows=16):
    """A reference scheduler with a top-k, a closeness and an empty slot
    after a few windows (chi2 prunes at these radii)."""
    _, blocked, _, targets = dataset
    spec = jmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=3, k_cap=8, metric=metric, prune=prune)
    sched = jmq.SharedCountsScheduler(blocked, spec, window=8, seed=0, start_block=0)
    sched.admit(targets[0], k=5, eps=0.15, delta=0.05)
    sched.admit(targets[1], k=1, eps=0.1, delta=0.05, qtype="closeness", gap=0.25)
    for i in range(windows):
        sched.run_window(sched.order[i * 8 : (i + 1) * 8])
    return sched, spec


def _port_spec(spec):
    return tmq.MultiQuerySpec(
        v_z=spec.v_z, v_x=spec.v_x, max_queries=spec.max_queries, k_cap=spec.k_cap,
        metric=spec.metric, prune=spec.prune,
    )


class TestMixedSlotStats:
    @pytest.mark.parametrize("prune", [False, True])
    def test_apply_stats_leaf_by_leaf(self, dataset, prune):
        sched, spec = _mixed_reference(dataset, prune)
        leaves = _leaves(sched.state)
        assert leaves["qtype"].tolist() == [0, 1, 0] and not leaves["occupied"][2]
        if prune:  # both slot types have pruned candidates by now
            assert leaves["pruned"][:2].any(axis=1).all()
        state = convert.multi_state_from_numpy(leaves, device="cpu")
        tspec = _port_spec(spec)
        tau, n = sched.state.tau * 1.01, sched.state.n + 3.0  # fresh stats inputs
        want = _leaves(jmq.apply_stats(sched.state, tau, n, spec=spec))
        got = tmq.apply_stats(
            state, torch.from_numpy(np.array(tau)), torch.from_numpy(np.array(n)), spec=tspec
        )
        for name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(got, name), want[name])
        # the whole stats step: kernel C's plain version, then the same tail
        want = _leaves(jmq.stats_step(sched.state, spec=spec))
        got = tmq.stats_step(state, spec=tspec)
        for name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(got, name), want[name])

    def test_closeness_off_is_exact_without_closeness_slots(self, dataset):
        """With no closeness slot, skipping the closeness rule changes no
        value (the scheduler's host flag)."""
        _, blocked, _, targets = dataset
        spec = jmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=3, k_cap=8, metric="chi2", prune=True)
        sched = jmq.SharedCountsScheduler(blocked, spec, window=8, seed=0, start_block=0)
        sched.admit(targets[0], k=5, eps=0.15, delta=0.05)
        sched.admit(targets[2], k=3, eps=0.2, delta=0.05)
        sched.run_window(sched.order[:8])
        state = convert.multi_state_from_numpy(_leaves(sched.state), device="cpu")
        tspec = _port_spec(spec)
        a = tmq.stats_step(state, spec=tspec, closeness=True)
        b = tmq.stats_step(state, spec=tspec, closeness=False)
        for name in tmq.MultiQueryState._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name

    @pytest.mark.parametrize("prune", [False, True])
    def test_fused_round_from_converted_state(self, dataset, prune):
        """A reference state with closeness slots and pruned candidates is
        carried across, and one more fused round agrees leaf by leaf."""
        _, _, ported, _ = dataset
        sched, spec = _mixed_reference(dataset, prune)
        state = convert.multi_state_from_numpy(_leaves(sched.state), device="cpu")
        cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
        win = sched.order[128:136]
        ref_state, ref_cursor = jmq.fused_round(
            sched.state, sched.cursor, sched.source.fetch(win, pad_to=8), spec=spec,
            policy="anyactive", plans=sched.plans,
        )
        wd = InMemorySource(ported, device="cpu").fetch(win, pad_to=8)
        new_state, new_cursor = tmq.fused_round(
            state, cursor, wd, spec=_port_spec(spec), policy="anyactive"
        )
        assert int(new_cursor.blocks_read) > sched.blocks_read
        ref_leaves = _leaves(ref_state)
        for name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(new_state, name), ref_leaves[name])
        ref_cur = _leaves(ref_cursor)
        for name in tmq.SampleCursor._fields:
            _assert_leaf(name, getattr(new_cursor, name), ref_cur[name])

    def test_admit_and_clear_slot(self, dataset):
        """admit_slot/clear_slot set and reset gap, qtype and pruned as
        the reference does."""
        spec = jmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=2)
        tspec = tmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=2)
        q_hat = np.full(16, 1 / 16, np.float32)
        want = jmq.admit_slot(
            jmq.init_multi_state(spec), jnp.int32(1), jnp.asarray(q_hat), jnp.int32(1),
            jnp.float32(0.1), jnp.float32(0.05), spec=spec, qtype=jmq.QTYPE_CLOSENESS,
            gap=jnp.float32(0.2),
        )
        got = tmq.admit_slot(
            tmq.init_multi_state(tspec, device="cpu"), 1, torch.from_numpy(q_hat), 1, 0.1, 0.05,
            qtype=tmq.QTYPE_CLOSENESS, gap=0.2,
        )
        for stage in ("admit", "clear"):
            leaves = _leaves(want)
            for name in tmq.MultiQueryState._fields:
                _assert_leaf(f"{stage} {name}", getattr(got, name), leaves[name])
            want = jmq.clear_slot(want, jnp.int32(1), spec=spec)
            got = tmq.clear_slot(got, 1)


# ---------------------------------------------------------------------------
# convert, the warm cache, the stop policy and the anytime answer
# ---------------------------------------------------------------------------


class TestWarmCache:
    def test_hash_equals_reference(self, dataset):
        _, blocked, ported, _ = dataset
        for kw in (dict(max_queries=2), dict(max_queries=8, k_cap=5, criterion="slowmatch")):
            want = jmq.cache_config_hash(blocked, jmq.MultiQuerySpec(v_z=48, v_x=16, **kw))
            tspec = tmq.MultiQuerySpec(v_z=48, v_x=16, **kw)
            assert tmq.cache_config_hash(ported, tspec) == want
            src = InMemorySource(ported, device="cpu")
            assert tmq.cache_config_hash(src, tspec) == want
        other = tmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=3)
        assert tmq.cache_config_hash(ported, other) != want

    def test_round_trip_gives_the_next_answer(self, dataset):
        """export -> import into a fresh scheduler: the next query reads
        and answers exactly as on the uninterrupted scheduler."""
        _, _, ported, targets = dataset
        spec = tmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=2)
        first = tmq.SharedCountsScheduler(ported, spec, window=8, seed=1, device="cpu")
        first.admit(targets[0], k=5, eps=0.1, delta=0.05)
        first.pump()
        snap = first.export_cache()
        warm = tmq.SharedCountsScheduler(ported, spec, window=8, seed=9, device="cpu")
        warm.import_cache(snap)
        assert (warm.rounds, warm.passes, warm.tuples_read) == (
            first.rounds, first.passes, first.tuples_read
        )
        np.testing.assert_array_equal(warm.order, first.order)
        for sched in (first, warm):
            sched.admit(targets[2], k=3, eps=0.12, delta=0.05)
            sched.pump()
        a, b = first.outcomes[1], warm.outcomes[0]
        np.testing.assert_array_equal(a.ids, b.ids)
        for f in ("rounds", "passes", "blocks_read", "tuples_read", "exact", "terminated"):
            assert getattr(a, f) == getattr(b, f), f
        assert torch.equal(first.state.counts, warm.state.counts)
        assert torch.equal(first.cursor.read_mask, warm.cursor.read_mask)

    def test_import_refused_under_live_queries_or_wrong_shape(self, dataset):
        _, _, ported, targets = dataset
        spec = tmq.MultiQuerySpec(v_z=48, v_x=16, max_queries=2)
        sched = tmq.SharedCountsScheduler(ported, spec, window=8, device="cpu")
        snap = sched.export_cache()
        sched.admit(targets[0], k=5, eps=0.1, delta=0.05)
        with pytest.raises(RuntimeError, match="no live queries"):
            sched.import_cache(snap)
        fresh = tmq.SharedCountsScheduler(ported, spec, window=8, device="cpu")
        with pytest.raises(ValueError, match="read_mask"):
            fresh.import_cache(snap._replace(read_mask=snap.read_mask[:-1]))
        with pytest.raises(ValueError, match="counts shape"):
            fresh.import_cache(snap._replace(counts=snap.counts[:, :-1]))


def test_convert_carries_closeness_state_and_rejects_unknown_qtype():
    spec = jmq.MultiQuerySpec(v_z=40, v_x=4, max_queries=3)
    leaves = _leaves(jmq.init_multi_state(spec))
    leaves["qtype"] = np.array([0, 1, 0], np.int32)
    leaves["gap"] = np.array([0.0, 0.25, 0.0], np.float32)
    leaves["pruned"][1, [3, 9]] = True
    state = convert.multi_state_from_numpy(leaves, device="cpu")
    assert state.qtype.dtype == torch.int64 and state.qtype.tolist() == [0, 1, 0]
    assert _np(state.pruned).nonzero()[1].tolist() == [3, 9]
    assert state.gap.tolist() == pytest.approx([0.0, 0.25, 0.0])
    leaves["qtype"] = np.array([0, 2, 0], np.int32)
    with pytest.raises(ValueError, match="qtype"):
        convert.multi_state_from_numpy(leaves, device="cpu")


class TestStopPolicy:
    def test_needs_at_least_one_criterion(self):
        with pytest.raises(ValueError):
            tmq.StopPolicy()

    @pytest.mark.parametrize("kw", [dict(wall_ms=-1), dict(confidence=1.5), dict(tuples=-1)])
    def test_rejects_bad_ranges(self, kw):
        with pytest.raises(ValueError):
            tmq.StopPolicy(**kw)

    @pytest.mark.parametrize(
        "gauges", [(1.0, 0.9, 200), (1.0, 0.1, 200), (1.0, 0.1, 50), (1e-6, 0.1, 50)]
    )
    def test_fired_matches_reference(self, gauges):
        wall_s, confidence, tuples = gauges
        kw = dict(wall_ms=1.0, confidence=0.5, tuples=100)
        got = tmq.StopPolicy(**kw).fired(wall_s=wall_s, confidence=confidence, tuples=tuples)
        want = jmq.StopPolicy(**kw).fired(wall_s=wall_s, confidence=confidence, tuples=tuples)
        assert got == want

    def test_spec_default_stop_takes_no_part_in_equality(self):
        a = tmq.MultiQuerySpec(v_z=8, v_x=4, default_stop=tmq.StopPolicy(tuples=5))
        assert a == tmq.MultiQuerySpec(v_z=8, v_x=4)
        with pytest.raises(TypeError, match="default_stop"):
            tmq.MultiQuerySpec(v_z=8, v_x=4, default_stop=5)


class TestAnytimeAnswerShape:
    def _answer(self, mod):
        return mod.AnytimeAnswer(
            qid=0, qtype="topk", status="live", ids=np.zeros(0, np.int64),
            tau=np.zeros(0, np.float32), margin=np.zeros(0, np.float32),
            split=0.0, n_min=0.0, tau_min=0.0, eps_n=1.0, delta_upper=1.0,
            confidence=0.0, round=0, tuples=0, tuples_live=0, eps=0.1,
            delta=0.05, metric="l1",
        )

    def test_default_flags_and_curve_point(self):
        from repro.obs import CURVE_COLUMNS
        from repro_torch import obs

        ans = self._answer(tmq)
        assert not ans.exact and not ans.stopped and ans.result is None
        assert obs.CURVE_COLUMNS == CURVE_COLUMNS
        assert tuple(ans.curve_point()) == tuple(obs.CURVE_COLUMNS)
        assert ans.curve_point() == self._answer(jmq).curve_point()

    @pytest.mark.parametrize("metric", METRICS)
    def test_host_eps_mirrors_reference(self, metric):
        for n, delta_i in ((1.0, 1e-3), (5e3, 1e-4), (2e6, 0.5)):
            assert tmq._metric_eps_np(n, delta_i, 16, metric) == jmq._metric_eps_np(
                n, delta_i, 16, metric
            )
