"""The port's statistics layer against the JAX reference.

Bitmap packing (bit 31 included), the chunked bitmap build and block
layout (bitwise), the Theorem-1 bound family (rtol 1e-5, float32 in
the same op order), and the deviation assignment on random and exactly
tied tau, including the port of
tests/test_stats_batched.py::TestTopKSelectionRegression: selection
breaks ties toward the lower index, as ``lax.top_k`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbitmap
from repro.core import bounds as jbounds
from repro.core import deviations as jdev
from repro.data import layout as jlayout
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import bounds as tbounds
from repro_torch.core import deviations as tdev
from repro_torch.data import layout as tlayout

RTOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


class TestBitmap:
    @pytest.mark.parametrize("v_z", [1, 31, 32, 33, 80, 7548])
    def test_pack_matches_reference(self, v_z):
        rng = np.random.default_rng(v_z)
        active = rng.random(v_z) < 0.5
        got = _np(tbitmap.pack_active_mask(torch.from_numpy(active)))
        assert got.dtype == np.int32 and got.shape == (tbitmap.words_for(v_z),)
        want = np.asarray(jbitmap.pack_active_mask(jnp.asarray(active)))
        np.testing.assert_array_equal(got.view(np.uint32), want)
        back = _np(tbitmap.unpack_mask(torch.from_numpy(got), v_z))
        np.testing.assert_array_equal(back, active)

    def test_bit_31(self):
        active = np.zeros(64, bool)
        active[31] = active[63] = True
        words = _np(tbitmap.pack_active_mask(torch.from_numpy(active)))
        np.testing.assert_array_equal(words, [np.int32(-(2**31))] * 2)
        np.testing.assert_array_equal(words.view(np.uint32), [1 << 31] * 2)
        back = _np(tbitmap.unpack_mask(torch.from_numpy(words), 64))
        np.testing.assert_array_equal(back, active)

    def test_pack_batched_rows(self):
        rng = np.random.default_rng(4)
        active = rng.random((3, 70)) < 0.5
        got = _np(tbitmap.pack_active_mask(torch.from_numpy(active)))
        for q in range(3):
            want = np.asarray(jbitmap.pack_active_mask(jnp.asarray(active[q])))
            np.testing.assert_array_equal(got[q].view(np.uint32), want)

    @pytest.mark.parametrize("v_z", [33, 161, 7548])
    def test_build_chunked_equals_unchunked_and_reference(self, v_z):
        rng = np.random.default_rng(v_z)
        z = rng.integers(-1, v_z + 3, size=(300, 64)).astype(np.int32)
        want = jbitmap.build_block_bitmap(z, v_z)
        whole = tbitmap.build_block_bitmap(z, v_z, chunk_blocks=10**6)
        assert whole.dtype == np.uint32
        np.testing.assert_array_equal(whole, want)
        for chunk in (1, 7, 128):
            np.testing.assert_array_equal(
                tbitmap.build_block_bitmap(z, v_z, chunk_blocks=chunk), whole
            )

    def test_block_layout_bitwise(self):
        rng = np.random.default_rng(9)
        z = rng.integers(0, 200, size=50_001).astype(np.int32)
        x = rng.integers(0, 7, size=50_001).astype(np.int32)
        want = jlayout.block_layout(z, x, v_z=200, v_x=7, block_size=256, seed=3)
        got = tlayout.block_layout(z, x, v_z=200, v_x=7, block_size=256, seed=3)
        for name in ("z_blocks", "x_blocks", "bitmap"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.num_tuples == want.num_tuples
        for shard in range(3):
            np.testing.assert_array_equal(
                got.shard(3, shard).bitmap, want.shard(3, shard).bitmap
            )


class TestBounds:
    @pytest.fixture
    def inputs(self):
        rng = np.random.default_rng(0)
        n = rng.integers(0, 10**6, size=200).astype(np.float32)
        eps = rng.uniform(0.0, 0.5, size=200).astype(np.float32)
        tau = rng.uniform(0.0, 2.0, size=200).astype(np.float32)
        return n, eps, tau

    def _close(self, got, want):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=1e-7)

    @pytest.mark.parametrize("v_x", [2, 24, 161])
    def test_theorem1(self, inputs, v_x):
        n, eps, _ = inputs
        tn, te = torch.from_numpy(n), torch.from_numpy(eps)
        self._close(tbounds.theorem1_epsilon(tn, 0.01, v_x), jbounds.theorem1_epsilon(n, 0.01, v_x))
        self._close(
            tbounds.theorem1_log_delta(te, tn, v_x), jbounds.theorem1_log_delta(eps, n, v_x)
        )
        self._close(tbounds.theorem1_delta(te, tn, v_x), jbounds.theorem1_delta(eps, n, v_x))
        self._close(tbounds.waggoner_epsilon(tn, 0.05, v_x), jbounds.waggoner_epsilon(n, 0.05, v_x))
        self._close(
            tbounds.slowmatch_epsilon(tn, 0.01, 80, v_x),
            jbounds.slowmatch_epsilon(n, 0.01, 80, v_x),
        )
        want = jbounds.theorem1_samples(0.06, 0.01, v_x)
        assert tbounds.theorem1_samples(0.06, 0.01, v_x) == want

    @pytest.mark.parametrize("metric", ["l1", "chi2", "hellinger"])
    def test_metric_family(self, inputs, metric):
        n, eps, tau = inputs
        tn, te, tt = (torch.from_numpy(a) for a in (n, eps, tau))
        self._close(
            tbounds.metric_log_delta(te, tn, 24, metric=metric),
            jbounds.metric_log_delta(jnp.asarray(eps), n, 24, metric=metric),
        )
        self._close(
            tbounds.metric_epsilon(tn, 0.01, 24, metric=metric),
            jbounds.metric_epsilon(n, 0.01, 24, metric=metric),
        )
        self._close(
            tbounds.metric_native_log_delta(te, tn, 24, tau=tt, metric=metric),
            jbounds.metric_native_log_delta(
                jnp.asarray(eps), n, 24, tau=jnp.asarray(tau), metric=metric
            ),
        )
        self._close(
            tbounds.metric_native_epsilon(tn, 0.01, 24, tau=tt, metric=metric),
            jbounds.metric_native_epsilon(n, 0.01, 24, tau=tau, metric=metric),
        )
        self._close(
            torch.as_tensor(tbounds.metric_native_l1_budget(te, tt, metric=metric)),
            jbounds.metric_native_l1_budget(jnp.asarray(eps), jnp.asarray(tau), metric=metric),
        )

    def test_bounded_metrics_match_registry(self):
        assert tbounds.BOUNDED_METRICS == jbounds.BOUNDED_METRICS


def _tau_cases():
    rng = np.random.default_rng(3)
    return {
        "random": rng.uniform(0.0, 1.0, size=80).astype(np.float32),
        "ties_straddle_k": np.repeat([0.1, 0.1, 0.3, 0.3, 0.3, 0.7], 4).astype(np.float32),
        "all_zero": np.zeros(17, np.float32),
        "all_tied": np.repeat(np.float32(0.42), 9),
        "interleaved": np.asarray([0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1], np.float32),
    }


TAU_CASES = _tau_cases()
DEV_FIELDS = ("in_top_k", "split", "eps_i", "log_delta_i", "delta_upper", "active")


def _assert_dev_equal(got, want, msg):
    for f in DEV_FIELDS:
        g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{f} {msg}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7, err_msg=f"{f} {msg}")


class TestDeviations:
    @pytest.mark.parametrize("case", sorted(TAU_CASES))
    @pytest.mark.parametrize("criterion", ["histsim", "slowmatch"])
    def test_dynamic_matches_reference(self, case, criterion):
        tau = TAU_CASES[case]
        v_z = tau.size
        n = np.random.default_rng(v_z).integers(1, 10**5, size=v_z).astype(np.float32)
        for k in sorted({1, 2, v_z // 2, v_z - 1}):
            for k_cap in (None, k, min(k + 3, v_z)):
                want = jdev.assign_deviations_dynamic(
                    jnp.asarray(tau), jnp.asarray(n), k=jnp.int32(k), eps=jnp.float32(0.06),
                    delta=jnp.float32(0.01), v_x=24, criterion=criterion, k_cap=k_cap,
                )
                got = tdev.assign_deviations_dynamic(
                    torch.from_numpy(tau), torch.from_numpy(n), k=k, eps=0.06, delta=0.01,
                    v_x=24, criterion=criterion, k_cap=k_cap,
                )
                _assert_dev_equal(got, want, f"k={k} k_cap={k_cap}")

    @pytest.mark.parametrize("metric", ["l1", "chi2", "hellinger"])
    @pytest.mark.parametrize("bounds_mode", ["native", "conservative"])
    def test_batched_slots_match_reference_per_slot(self, metric, bounds_mode):
        """The slot axis written out == the reference's per-slot call."""
        rng = np.random.default_rng(1)
        v_z = 60
        tau = rng.uniform(0.0, 1.0, size=(3, v_z)).astype(np.float32)
        tau[1, :10] = 0.25  # a tie block
        n = rng.integers(0, 10**5, size=v_z).astype(np.float32)
        k, eps, delta = np.array([1, 5, 12]), np.array([0.05, 0.1, 0.2], np.float32), np.array(
            [0.01, 0.05, 0.1], np.float32
        )
        got = tdev.assign_deviations_dynamic(
            torch.from_numpy(tau), torch.from_numpy(n), k=torch.from_numpy(k),
            eps=torch.from_numpy(eps), delta=torch.from_numpy(delta), v_x=16, k_cap=12,
            metric=metric, bounds_mode=bounds_mode,
        )
        for q in range(3):
            want = jdev.assign_deviations_dynamic(
                jnp.asarray(tau[q]), jnp.asarray(n), k=jnp.int32(k[q]), eps=jnp.float32(eps[q]),
                delta=jnp.float32(delta[q]), v_x=16, k_cap=12, metric=metric,
                bounds_mode=bounds_mode,
            )
            slot = tdev.DeviationState(*(leaf[q] for leaf in got))
            _assert_dev_equal(slot, want, f"slot {q}")

    def test_slowmatch_entry_point(self):
        tau = TAU_CASES["random"]
        n = np.full(tau.size, 3e4, np.float32)
        kw = dict(k=5, eps=0.08, delta=0.05, v_x=16)
        got = tdev.slowmatch_deviations(torch.from_numpy(tau), torch.from_numpy(n), **kw)
        want = jdev.slowmatch_deviations(jnp.asarray(tau), jnp.asarray(n), **kw)
        _assert_dev_equal(got, want, "slowmatch")

    @pytest.mark.parametrize("case", sorted(TAU_CASES))
    def test_split_point_and_mask(self, case):
        tau = TAU_CASES[case]
        for k in (1, 3, tau.size - 1, tau.size):
            got = _np(tdev.split_point(torch.from_numpy(tau), k))
            want = np.asarray(jdev.split_point(jnp.asarray(tau), k))
            np.testing.assert_allclose(got, want, rtol=RTOL)
            np.testing.assert_array_equal(
                _np(tdev.top_k_mask(torch.from_numpy(tau), k)),
                np.asarray(jdev.top_k_mask(jnp.asarray(tau), k)),
            )


def _argsort_assignment(tau, n, *, k, eps, delta, v_x):
    """Full stable argsort + rank scatter, the tie-behaviour oracle of
    tests/test_stats_batched.py written in PyTorch."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    v_z = tau.shape[0]
    order = torch.argsort(tau, stable=True)
    ranks = torch.zeros(v_z, dtype=torch.int64).index_put_((order,), torch.arange(v_z))
    in_m = ranks < k
    sorted_tau = tau[order]
    kth = sorted_tau[min(max(k - 1, 0), v_z - 1)]
    k1th = sorted_tau[min(max(k, 0), v_z - 1)]
    s = torch.max(tau) if k >= v_z else 0.5 * (kth + k1th)
    eps_in = torch.minimum(torch.tensor(eps), s + 0.5 * eps - tau)
    eps_out = tau - torch.clamp_min(s - 0.5 * eps, 0.0)
    eps_i = torch.clamp_min(torch.where(in_m, eps_in, eps_out), 0.0)
    log_delta_i = tbounds.theorem1_log_delta(eps_i, torch.as_tensor(n, dtype=torch.float32), v_x)
    delta_upper = torch.sum(torch.exp(log_delta_i))
    active = log_delta_i > torch.log(torch.tensor(delta, dtype=torch.float32) / float(v_z))
    return in_m, s, eps_i, delta_upper, active


class TestTopKSelectionRegression:
    def test_identical_on_ties(self):
        """Heavy ties across the k boundary give the by-index M, split
        point, eps_i, delta_upper and active set of a full stable argsort,
        for every k_cap including None."""
        rng = np.random.default_rng(3)
        eps, delta, v_x = 0.06, 0.01, 24
        for name in ("ties_straddle_k", "all_zero", "all_tied", "interleaved"):
            tau = TAU_CASES[name]
            n = rng.integers(1, 10**5, size=len(tau)).astype(np.float32)
            for k in (1, 2, len(tau) // 2, len(tau) - 1):
                want = _argsort_assignment(tau, n, k=k, eps=eps, delta=delta, v_x=v_x)
                for k_cap in (None, k, k + 3, len(tau)):
                    d = tdev.assign_deviations_dynamic(
                        torch.from_numpy(tau), torch.from_numpy(n), k=k, eps=eps,
                        delta=delta, v_x=v_x, k_cap=k_cap,
                    )
                    got = (d.in_top_k, d.split, d.eps_i, d.delta_upper, d.active)
                    names = ("in_top_k", "split", "eps_i", "delta_upper", "active")
                    for g, w, field in zip(got, want, names):
                        np.testing.assert_array_equal(
                            _np(g), _np(w), err_msg=f"{field} k={k} k_cap={k_cap} {name}"
                        )

    def test_static_entry_point_matches_dynamic(self):
        tau = torch.from_numpy(np.repeat([0.05, 0.2, 0.2, 0.6], 3).astype(np.float32))
        n = torch.full((12,), 4e4)
        a = tdev.assign_deviations(tau, n, k=4, eps=0.06, delta=0.01, v_x=24)
        b = tdev.assign_deviations_dynamic(tau, n, k=4, eps=0.06, delta=0.01, v_x=24, k_cap=None)
        for f in a._fields:
            np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)), err_msg=f)

    def test_top_k_mask_ties_by_index(self):
        tau = torch.tensor([0.5, 0.2, 0.2, 0.2, 0.9])
        np.testing.assert_array_equal(
            _np(tdev.top_k_mask(tau, 2)), [False, True, True, False, False]
        )
