"""The port's Appendix-A extensions and activation monitor against the
JAX reference.

The numpy helpers (measure-biased sampling, density maps, predicate
estimates, `pick_k_in_range`) must give bitwise the reference's arrays.
`assign_deviations_two_eps` fed the same (tau, n) must agree bit for
bit in every field but delta_upper: that is the f32 sum of the same
(bitwise equal) delta_i, and XLA's CPU reduction adds them in another
order than `torch.sum`, so it is held to the error bound of two f32 sums
of V_Z nonnegative terms, each term's exp within an ulp: 2 V_Z 2^-23
sum_i delta_i, plus V_Z subnormal steps. The monitor's bin ids must equal the reference's
(XLA's saturating cast) for finite values, the range's edges, +-inf,
+-1e30 and NaN; its histograms bitwise, distances equal, the sampling
bound within rtol 1e-5 and the drift decisions equal on inputs whose
distance is away from the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extensions as jext
from repro.train import monitor as jmon
from repro_torch.core import deviations as tdev
from repro_torch.core import extensions as text
from repro_torch.train import ActivationMonitor
from repro_torch.train import monitor as tmon


@pytest.mark.parametrize("seed", range(3))
def test_measure_biased_sample_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 20_000
    z = rng.integers(0, 20, n).astype(np.int32)
    x = rng.integers(0, 8, n).astype(np.int32)
    y = rng.exponential(scale=2.0, size=n)
    want = jext.measure_biased_sample(z, x, y, target_size=40_000, seed=seed)
    got = text.measure_biased_sample(z, x, y, target_size=40_000, seed=seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("y", [np.asarray([1.0, -1, 1, 1]), np.zeros(4)], ids=("neg", "zero"))
def test_measure_biased_sample_rejects(y):
    z = np.zeros(4, np.int32)
    for fn in (jext.measure_biased_sample, text.measure_biased_sample):
        with pytest.raises(ValueError):
            fn(z, z, y, target_size=10)


def _density_inputs(seed):
    rng = np.random.default_rng(seed)
    nb, bs = 40, 300
    blocks = {
        "country": rng.integers(0, 10, (nb, bs)).astype(np.int32),
        "religion": rng.integers(-1, 4, (nb, bs)).astype(np.int32),  # -1: padding
    }
    blocks["country"][0] = 3  # 300 of one value: the uint8 count saturates at 255
    return blocks, {"country": 10, "religion": 4}, bs


def _predicates(mod):
    P = mod.PredicateNode
    return [
        P.leaf("country", 3),
        P.and_(P.leaf("country", 3), P.leaf("religion", 1)),
        P.or_(P.leaf("country", 0), P.leaf("country", 1)),
        P.or_(P.and_(P.leaf("country", 7), P.leaf("religion", 2)), P.leaf("religion", 0)),
    ]


@pytest.mark.parametrize("seed", range(2))
def test_density_map_and_estimates_bitwise(seed):
    blocks, card, bs = _density_inputs(seed)
    want = jext.DensityMap.build(blocks, card)
    got = text.DensityMap.build(blocks, card)
    assert sorted(want.counts) == sorted(got.counts)
    for attr in want.counts:
        assert want.counts[attr].dtype == got.counts[attr].dtype
        np.testing.assert_array_equal(got.counts[attr], want.counts[attr])
    for pw, pg in zip(_predicates(jext), _predicates(text)):
        a = jext.estimate_block_counts(want, pw, bs)
        b = text.estimate_block_counts(got, pg, bs)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_predicate_evaluate_matches():
    values = [{"a": 1, "b": 2}, {"a": 5, "b": 0}, {"a": 1, "b": 0}, {"a": 0, "b": 2}]
    for mod in (jext, text):
        P = mod.PredicateNode
        pred = P.or_(P.and_(P.leaf("a", 1), P.leaf("b", 2)), P.leaf("a", 5))
        assert [pred.evaluate(v) for v in values] == [True, True, False, False]


TWO_EPS = [(0.08, 0.08), (0.2, 0.05), (0.05, 0.2), (0.12, 0.12), (0.3, 0.01)]


@pytest.mark.parametrize("eps_sep,eps_rec", TWO_EPS)
@pytest.mark.parametrize("seed", range(4))
def test_two_eps_bitwise(seed, eps_sep, eps_rec):
    rng = np.random.default_rng(seed)
    v_z = 24 + 8 * seed
    tau = (rng.random(v_z) * 0.6).astype(np.float32)
    n = rng.integers(100, 10**6, v_z).astype(np.float32)
    k = 3 + seed
    kw = dict(k=k, eps_sep=eps_sep, eps_rec=eps_rec, delta=0.01, v_x=16)
    want = jext.assign_deviations_two_eps(jnp.asarray(tau), jnp.asarray(n), **kw)
    got = text.assign_deviations_two_eps(torch.from_numpy(tau), torch.from_numpy(n), **kw)
    for f in ("tau", "in_top_k", "split", "eps_i", "log_delta_i", "delta_upper", "active"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        if f != "delta_upper":
            np.testing.assert_array_equal(b, a, err_msg=f)
    terms = np.exp(np.asarray(want.log_delta_i)).astype(np.float64)
    bound = 2 * v_z * 2.0**-23 * terms.sum() + v_z * 2.0**-149
    assert abs(float(got.delta_upper) - float(want.delta_upper)) <= bound


@pytest.mark.parametrize("seed", range(3))
def test_two_eps_equal_eps_is_base(seed):
    """With eps_sep == eps_rec the port's two-eps assignment is its own
    `assign_deviations`."""
    rng = np.random.default_rng(seed)
    tau = torch.from_numpy((rng.random(24) * 0.6).astype(np.float32))
    n = torch.from_numpy(rng.integers(100, 10**6, 24).astype(np.float32))
    a = tdev.assign_deviations(tau, n, k=5, eps=0.08, delta=0.01, v_x=16)
    b = text.assign_deviations_two_eps(tau, n, k=5, eps_sep=0.08, eps_rec=0.08,
                                       delta=0.01, v_x=16)
    torch.testing.assert_close(b.eps_i, a.eps_i, atol=1e-6, rtol=0)
    assert float(b.delta_upper) == pytest.approx(float(a.delta_upper), rel=1e-5)
    assert torch.equal(b.in_top_k, a.in_top_k)


K_RANGE = [
    ([0.01, 0.02, 0.03, 0.30, 0.31, 0.32, 0.9], 2, 5),
    ([0.1, 0.2, 0.3, 0.4], 2, 3),
    ([0.1, 0.2, 0.3, 0.4], 0, 9),
    ([0.5, 0.1, 0.4, 0.2, 0.3, 0.35], 1, 4),
]


@pytest.mark.parametrize("tau,lo,hi", K_RANGE)
def test_pick_k_in_range_matches(tau, lo, hi):
    tau = np.asarray(tau, np.float32)
    want = jext.pick_k_in_range(jnp.asarray(tau), lo, hi)
    assert text.pick_k_in_range(tau, lo, hi) == want
    assert text.pick_k_in_range(torch.from_numpy(tau), lo, hi) == want


def test_pick_k_in_range_rejects_empty():
    with pytest.raises(ValueError, match="empty k range"):
        jext.pick_k_in_range(jnp.asarray([0.1, 0.2]), 3, 5)
    with pytest.raises(ValueError, match="empty k range"):
        text.pick_k_in_range(torch.tensor([0.1, 0.2]), 3, 5)


# ---------------------------------------------------------------------------
# the activation monitor
# ---------------------------------------------------------------------------

EDGE_VALUES = np.asarray(
    [np.nan, np.inf, -np.inf, 1e30, -1e30, 3e38, -3e38, -8.0, 8.0, 7.9999995, -7.9999995,
     -8.0000005, 8.0000005, 0.0, -0.0, 0.25, -0.25, 1e-40, 0.125, 7.75, -7.75],
    np.float32,
)


@pytest.mark.parametrize("bins", [64, 32, 7])
def test_bin_ids_match_xla(bins):
    rng = np.random.default_rng(bins)
    x = np.concatenate([EDGE_VALUES, (rng.standard_normal(4096) * 4).astype(np.float32)])
    want = np.asarray(jmon._bin_ids(jnp.asarray(x), -8.0, 8.0, bins))
    got = tmon._bin_ids(torch.from_numpy(x), -8.0, 8.0, bins).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == bins - 1 and got[2] == 0 and got[3] == bins - 1


def test_bin_ids_take_bf16():
    x = np.asarray([-9.0, -1.5, 0.0, 2.25, 100.0], np.float32)
    want = np.asarray(jmon._bin_ids(jnp.asarray(x, jnp.bfloat16), -8.0, 8.0, 64))
    got = tmon._bin_ids(torch.from_numpy(x).to(torch.bfloat16), -8.0, 8.0, 64).numpy()
    np.testing.assert_array_equal(got, want)


def _tensors(seed, names, scales):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal((16, 257)) * s).astype(np.float32)
            for name, s in zip(names, scales)}


def _monitors(**kw):
    return jmon.ActivationMonitor(**kw), ActivationMonitor(**kw)


MONITOR_CASES = [
    dict(names=["h0", "h1"], bins=32, drift_eps=0.2),
    dict(names=["k0", "v0", "k1"], bins=64),
    dict(names=["a"], bins=16, lo=-4.0, hi=4.0, drift_eps=0.1),
]


@pytest.mark.parametrize("kw", MONITOR_CASES, ids=("two", "three", "narrow"))
def test_monitor_matches_reference(kw):
    names = kw["names"]
    base = _tensors(0, names, [1.0 + i for i in range(len(names))])
    # the first tensor blown up (scale 4, shift 3): far past the threshold;
    # the others drawn again: far below it
    later = _tensors(1, names, [1.0 + i for i in range(len(names))])
    later[names[0]] = later[names[0]] * 4 + 3
    jm, tm = _monitors(**kw)
    jm.capture_reference({n: jnp.asarray(a) for n, a in base.items()})
    tm.capture_reference({n: torch.from_numpy(a) for n, a in base.items()})
    assert tm.reference.dtype == jm.reference.dtype
    np.testing.assert_array_equal(tm.reference, jm.reference)
    hj = jm._histogram({n: jnp.asarray(a) for n, a in later.items()})
    ht = tm._histogram({n: torch.from_numpy(a) for n, a in later.items()})
    assert ht.dtype == hj.dtype
    np.testing.assert_array_equal(ht, hj)
    want = jm.check({n: jnp.asarray(a) for n, a in later.items()})
    got = tm.check({n: torch.from_numpy(a) for n, a in later.items()})
    assert list(got) == list(want) == names
    for name in names:
        g, w = got[name], want[name]
        assert g["distance"] == w["distance"]
        assert g["sampling_bound"] == pytest.approx(w["sampling_bound"], rel=1e-5)
        assert g["drifted"] == w["drifted"]
        assert abs(w["distance"] - w["sampling_bound"] - kw.get("drift_eps", 0.15)) > 0.02
    assert got[names[0]]["drifted"]
    assert not any(got[n]["drifted"] for n in names[1:])


def test_monitor_bins_blown_up_values_like_reference():
    """NaN and infinities land where XLA puts them: NaN and -inf in bin 0,
    +inf and huge values in the top bin."""
    x = np.zeros(1000, np.float32)
    x[:100], x[100:150], x[150:200], x[200:260] = np.nan, np.inf, -np.inf, 1e30
    jm, tm = _monitors(names=["h"], bins=8)
    hj = jm._histogram({"h": jnp.asarray(x)})
    ht = tm._histogram({"h": torch.from_numpy(x)})
    np.testing.assert_array_equal(ht, hj)
    assert ht[0, 0] == 150 and ht[0, 7] == 110


def test_monitor_requires_reference():
    with pytest.raises(RuntimeError, match="capture_reference"):
        ActivationMonitor(names=["h"]).check({"h": torch.zeros(4)})
