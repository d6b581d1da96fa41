"""Host-stepped rounds and the deviation contract, port against reference.

Part one holds `histsim.run_round`, `histsim.should_terminate` and
`multiquery.run_round` against the reference's, round by round, in the
host-stepped loop of tests/test_device_loop.py (windows of block ids
chosen with numpy, marked by AnyActive on the host, their tuples fed to
``run_round``): counts, ``n`` and ``round_idx`` equal, ``should_terminate``
equal, tau within 2e-5 and the bounds within ``rtol=1e-5`` after every
round.

Part two is the contract between tau's 2e-5 bar and the bounds'. Fed the
same (tau, n), the two packages' deviation functions agree bit for bit.
End to end, a one-ulp difference in tau is multiplied by n inside the
Theorem-1 exponent, so ``delta_upper`` may move past ``rtol=1e-5`` when n
is large; the end-to-end twin on such an input bounds ``log(delta_upper)``
by the derivative of Theorem 1 instead (see its docstring).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deviations as jdev
from repro.core import histsim as jhistsim
from repro.core import multiquery as jmq
from repro.core.policies import mark_window as jmark_window
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import deviations as tdev
from repro_torch.core import histsim as thistsim
from repro_torch.core import multiquery as tmq
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
BOUND_RTOL = 1e-5


@pytest.fixture(scope="module")
def rounds_data():
    spec = SynthSpec(
        v_z=48, v_x=16, num_tuples=400_000, k=5, n_close=5,
        close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=13,
    )
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=256, seed=13)
    rng = np.random.default_rng(21)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.02, 0.05)]
    # host-stepped windows: a numpy-seeded visit order cut into windows of 24 blocks
    order = np.random.default_rng(5).permutation(blocked.num_blocks)
    windows = [order[i:i + 24] for i in range(0, 24 * 8, 24)]
    return spec, blocked, targets, windows


def _window_ids(blocked, win, marks):
    z = np.where(marks[:, None], blocked.z_blocks[win], -1).reshape(-1).astype(np.int32)
    x = np.where(marks[:, None], blocked.x_blocks[win], -1).reshape(-1).astype(np.int32)
    return z, x


def _close(name, got: torch.Tensor, want, *, exact=False):
    g, w = got.numpy(), np.asarray(want)
    if w.dtype == np.uint32:
        g = g.view(np.uint32)
    if exact or w.dtype != np.float32:
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    elif name == "tau":
        np.testing.assert_allclose(g, w, atol=TAU_ATOL, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=BOUND_RTOL, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("criterion", ["histsim", "slowmatch"])
def test_histsim_run_round_and_should_terminate(rounds_data, criterion):
    spec, blocked, targets, windows = rounds_data
    kw = dict(v_z=spec.v_z, v_x=spec.v_x, k=5, eps=0.1, delta=0.05, criterion=criterion)
    jp, tp = jhistsim.HistSimParams(**kw), thistsim.HistSimParams(**kw)
    want = jhistsim.init_state(jp, jnp.asarray(targets[0]))
    got = thistsim.init_state(tp, targets[0], device="cpu")
    assert thistsim.should_terminate(got, tp) == jhistsim.should_terminate(want, jp)
    bitmap = jnp.asarray(blocked.bitmap)
    for r, win in enumerate(windows):
        marks = np.asarray(jmark_window(bitmap[jnp.asarray(win)], want.active_words,
                                        policy="anyactive"))
        z, x = _window_ids(blocked, win, marks)
        want = jhistsim.run_round(want, jnp.asarray(z), jnp.asarray(x), params=jp)
        got = thistsim.run_round(got, torch.from_numpy(z), torch.from_numpy(x), params=tp)
        for name in thistsim.HistSimState._fields:
            _close(f"{name} round {r}", getattr(got, name), getattr(want, name),
                   exact=name in ("counts", "n"))
        assert thistsim.should_terminate(got, tp) == jhistsim.should_terminate(want, jp), r
    assert int(got.round_idx) == len(windows)


def test_histsim_run_round_is_ingest_then_stats(rounds_data):
    spec, blocked, targets, windows = rounds_data
    tp = thistsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=5)
    state = thistsim.init_state(tp, targets[1], device="cpu")
    z = torch.from_numpy(blocked.z_blocks[windows[0]].reshape(-1).astype(np.int32))
    x = torch.from_numpy(blocked.x_blocks[windows[0]].reshape(-1).astype(np.int32))
    a = thistsim.run_round(state, z, x, params=tp)
    b = thistsim.stats_step(thistsim.ingest(state, z, x, params=tp), params=tp)
    for name in thistsim.HistSimState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_should_terminate_is_the_strict_test():
    tp = thistsim.HistSimParams(v_z=4, v_x=2, k=1, delta=0.25)
    state = thistsim.init_state(tp, np.ones(2), device="cpu")
    for upper, want in ((0.25, False), (0.2499, True), (4.0, False)):
        s = state._replace(delta_upper=torch.tensor(upper, dtype=torch.float32))
        assert thistsim.should_terminate(s, tp) is want


def test_run_round_is_exported():
    assert "run_round" in tmq.__all__ and "run_round" in thistsim.__all__
    assert "run_round" in jmq.__all__ and "run_round" in jhistsim.__all__


@pytest.mark.parametrize("metric", ["l1", "hellinger"])
def test_multiquery_run_round_matches_reference(rounds_data, metric):
    """Two top-k slots and a closeness slot admitted after round 2, run
    round by round through `multiquery.run_round` in both packages."""
    spec, blocked, targets, windows = rounds_data
    shape = dict(v_z=spec.v_z, v_x=spec.v_x, max_queries=3, k_cap=5, metric=metric)
    jspec, tspec = jmq.MultiQuerySpec(**shape), tmq.MultiQuerySpec(**shape)
    want = jmq.init_multi_state(jspec)
    got = tmq.init_multi_state(tspec, device="cpu")
    slots = [(0, targets[0], 5, 0.1, 0.05, 0, 0.0), (1, targets[1], 3, 0.12, 0.05, 0, 0.0)]
    late = (2, targets[2], 1, 0.1, 0.05, tmq.QTYPE_CLOSENESS, 0.1)

    def admit(slot, target, k, eps, delta, qtype, gap):
        nonlocal want, got
        q = (target / target.sum()).astype(np.float32)
        want = jmq.admit_slot(
            want, jnp.asarray(slot, jnp.int32), jnp.asarray(q), jnp.asarray(k, jnp.int32),
            jnp.asarray(eps, jnp.float32), jnp.asarray(delta, jnp.float32), spec=jspec,
            qtype=jnp.asarray(qtype, jnp.int32), gap=jnp.asarray(gap, jnp.float32))
        got = tmq.admit_slot(got, slot, torch.from_numpy(q), k, eps, delta, qtype=qtype, gap=gap)
        want = jmq.stats_step(want, spec=jspec)
        got = tmq.stats_step(got, spec=tspec)

    for s in slots:
        admit(*s)
    bitmap = jnp.asarray(blocked.bitmap)
    for r, win in enumerate(windows):
        if r == 2:
            admit(*late)
        marks = np.asarray(jmark_window(bitmap[jnp.asarray(win)], want.union_words,
                                        policy="anyactive"))
        z, x = _window_ids(blocked, win, marks)
        want = jmq.run_round(want, jnp.asarray(z), jnp.asarray(x), spec=jspec)
        got = tmq.run_round(got, torch.from_numpy(z), torch.from_numpy(x), spec=tspec)
        for name in tmq.MultiQueryState._fields:
            _close(f"{name} round {r}", getattr(got, name), getattr(want, name),
                   exact=name in ("counts", "n"))
        for slot in range(3):
            stop_want = bool(want.delta_upper[slot] < want.delta[slot])
            assert bool(got.delta_upper[slot] < got.delta[slot]) == stop_want, (r, slot)


def test_multiquery_run_round_threads_plans(rounds_data):
    """``plans`` reaches ingest and the tau step: a pinned two-step ingest
    and forced wide branch give the default plans' state on the CPU."""
    from repro_torch.kernels import autotune

    spec, blocked, targets, windows = rounds_data
    tspec = tmq.MultiQuerySpec(v_z=spec.v_z, v_x=spec.v_x, max_queries=1, k_cap=5)
    state = tmq.admit_slot(tmq.init_multi_state(tspec, device="cpu"), 0,
                           torch.from_numpy((targets[0] / targets[0].sum()).astype(np.float32)),
                           5, 0.1, 0.05)
    z = torch.from_numpy(blocked.z_blocks[windows[1]].reshape(-1).astype(np.int32))
    x = torch.from_numpy(blocked.x_blocks[windows[1]].reshape(-1).astype(np.int32))
    plans = autotune.PlanPair(autotune.TauPlan(sweeps=2), autotune.IngestPlan(fused=False))
    a = tmq.run_round(state, z, x, spec=tspec, plans=plans)
    b = tmq.run_round(state, z, x, spec=tspec)
    for name in tmq.MultiQueryState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# tau's bar against the bounds' bar: a mix where n is large
# ---------------------------------------------------------------------------

# The first five requests of the serving mix; the sixth is submitted after
# two steps: (k, eps, delta)
MIX_REQUESTS = ((5, 0.1, 0.05), (3, 0.15, 0.05), (5, 0.2, 0.1), (2, 0.1, 0.05), (4, 0.15, 0.1))
MIX_LATE = (1, 0.2, 0.1)
MIX_SERVER = dict(max_queries=3, metric="l1", bounds_mode="conservative", poll_every=3,
                 lookahead=8, seed=23, criterion="slowmatch", policy="scan")


@pytest.fixture(scope="module")
def mix_run():
    """The six-request `MatchServer` mix at seed 23 in both packages."""
    spec = SynthSpec(v_z=45, v_x=7, num_tuples=300_000, k=5, n_close=5, seed=23, zipf_a=1.1)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=45, v_x=7, block_size=200, seed=23)
    ported = convert.dataset_from_numpy(blocked.z_blocks, blocked.x_blocks, blocked.bitmap, 45, 7)
    rng = np.random.default_rng(23)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng)
                             for d in np.linspace(0.05, 0.4, 5)]

    def serve(server):
        for t, (k, eps, delta) in zip(targets, MIX_REQUESTS):
            server.submit(t, k=k, eps=eps, delta=delta)
        server.step()
        server.step()
        k, eps, delta = MIX_LATE
        server.submit(targets[5], k=k, eps=eps, delta=delta)
        return server.run_until_idle()

    want = serve(JServer(blocked, **MIX_SERVER))
    got = serve(MatchServer(ported, device="cpu", **MIX_SERVER))
    return got, want


def _requests():
    return [(rid, *kw) for rid, kw in enumerate(MIX_REQUESTS + (MIX_LATE,))]


@pytest.mark.parametrize("rid,k,eps,delta", _requests())
def test_deviations_bitwise_on_reference_tau_and_n(mix_run, rid, k, eps, delta):
    """Fed the reference's final (tau, n) of each request, the port's
    deviation functions return the reference's eps_i, log_delta_i,
    delta_upper and split bit for bit: the dynamic (serving) form under
    the mix's settings and the static top-k path's two criteria."""
    _, want = mix_run
    tau, n = np.array(want[rid].state.tau), np.array(want[rid].state.n)
    v_x = 7
    dyn = dict(v_x=v_x, criterion="slowmatch", k_cap=None, metric="l1",
               bounds_mode="conservative")
    j = jdev.assign_deviations_dynamic(
        jnp.asarray(tau), jnp.asarray(n), k=jnp.asarray(k, jnp.int32),
        eps=jnp.asarray(eps, jnp.float32), delta=jnp.asarray(delta, jnp.float32), **dyn)
    t = tdev.assign_deviations_dynamic(
        torch.from_numpy(tau), torch.from_numpy(n), k=k, eps=eps, delta=delta, **dyn)
    pairs = [(t, j)]
    for tfn, jfn in ((tdev.assign_deviations, jdev.assign_deviations),
                     (tdev.slowmatch_deviations, jdev.slowmatch_deviations)):
        static = dict(k=k, eps=eps, delta=delta, v_x=v_x)
        pairs.append((tfn(torch.from_numpy(tau), torch.from_numpy(n), **static),
                      jfn(jnp.asarray(tau), jnp.asarray(n), **static)))
    for got, ref in pairs:
        for name in ("eps_i", "log_delta_i", "delta_upper", "split"):
            g = getattr(got, name).numpy()
            w = np.asarray(getattr(ref, name))
            np.testing.assert_array_equal(g.view(np.uint32), w.astype(np.float32).view(np.uint32),
                                          err_msg=name)


def test_end_to_end_bounds_within_theorem1_derivative(mix_run):
    """Ids, rounds, blocks, tuples, ``exact`` and counts equal; tau within
    2e-5; ``log(delta_upper)`` within a bound derived from Theorem 1.

    Derivation. Under the conservative l1 bounds, log delta_i =
    min(0, V_X log 2 - eps_i^2 n_i / 2), so d log delta_i / d eps_i =
    -eps_i n_i (src/repro_torch/core/bounds.py, `theorem1_log_delta`);
    the clamp at 0 only shrinks a change. eps_i is |tau_i - s| shifted by
    eps / 2 and clamped to [0, eps] (`assign_deviations_dynamic`), with
    the split s the mean of two order statistics of tau; each of these
    steps is 1-Lipschitz, so with D = max_i |Δtau_i| between the two
    packages, |Δeps_i| <= |Δtau_i| + |Δs| <= 2 D. Taking the change of
    eps_i^2 n_i / 2 exactly, |Δ log delta_i| <= n_i (eps_i + D_e) D_e with
    D_e = 2 D. delta_upper is V_Z max_i delta_i under slowmatch (or the
    sum of the delta_i under histsim); both log V_Z + max_i log delta_i
    and log sum exp are 1-Lipschitz in the max norm, so

        |Δ log delta_upper| <= max_i n_i (eps_i + 2 D) 2 D + 1e-6,

    the 1e-6 covering float32 rounding of log delta_i (~|log delta_i| *
    2^-24) and of the final exp and log. D is measured in this test.
    """
    got, want = mix_run
    assert sorted(got) == sorted(want) == list(range(6))
    for rid in want:
        g, w = got[rid], want[rid]
        for f in ("ids", "rounds", "passes", "blocks_read", "blocks_considered", "tuples_read",
                  "exact", "stopped", "stop_reason", "qtype"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                          err_msg=f"{f} rid {rid}")
        np.testing.assert_array_equal(g.state.counts.numpy(), np.asarray(w.state.counts))
        np.testing.assert_array_equal(g.state.n.numpy(), np.asarray(w.state.n))
        w_tau = np.asarray(w.state.tau, np.float64)
        d = float(np.abs(g.state.tau.numpy().astype(np.float64) - w_tau).max())
        assert d <= TAU_ATOL, (rid, d)
        n = np.asarray(w.state.n, np.float64)
        eps_i = np.asarray(w.state.eps_i, np.float64)
        bound = float(np.max(n * (eps_i + 2 * d) * 2 * d)) + 1e-6
        gap = abs(np.log(float(g.delta_upper)) - np.log(float(w.delta_upper)))
        assert gap <= bound, (rid, gap, bound)
