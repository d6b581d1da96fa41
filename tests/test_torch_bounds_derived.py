"""Closeness queries end to end: ``delta_upper`` held to a bound derived
from Theorem 1, as tests/test_torch_rounds.py holds top-k.

Two inputs where the serving twins' ``rtol=1e-5`` on ``delta_upper``
does not follow from tau's bar: one closeness query over
``SynthSpec(v_z=19, v_x=27, num_tuples=212168, k=5, n_close=5,
zipf_a=0.64, seed=2)`` in blocks of 256, ``MatchServer(max_queries=1,
lookahead=256, seed=2)``, ``submit_closeness(target, eps, gap=0.16,
delta=0.05)``: metric l1 at eps 0.06 (tau 2 ulps apart, ``delta_upper``
1.53e-5 relative apart) and chi2 at eps 0.15 (1.15e-5). Each metric runs
under both bound modes, and hellinger at eps 0.06 with them.

Derivation. For candidate i with n_i samples the closeness rule
(`assign_closeness`) uses the margin m_i = max(tau_i - eps, eps + gap -
tau_i, 0) and

    log delta_i = min(0, V_X log 2 - B(m_i, tau_i)^2 n_i / 2),

B the metric's l1 budget (`bounds.metric_l1_budget` in conservative
mode, `bounds.metric_native_l1_budget` in native mode). The margin is
1-Lipschitz in tau (a max of 1-Lipschitz maps, no order statistic as in
top-k's split), so with D = max_i |Δtau_i| between the two packages
(measured here), |Δm_i| <= D and the change of B is at most L_i D, L_i
the Lipschitz constant of tau -> B(m(tau), tau) on [tau_i - D,
tau_i + D]:

* l1: B = m, L = 1 (D in place of top-k's 2D).
* chi2, conservative: B = m/3, L = 1/3.
* hellinger, conservative: B = m^2/4, L = (m_i + D)/2.
* chi2, native: B = max(m/3, f), f(t, m) = (sqrt(t + m) - sqrt(t))^2.
  With a = sqrt(t + m), b = sqrt(t): df/dm = (a - b)/a in [0, 1] and
  df/dt = -(a - b)^2/(a b), so |df/dtau| <= (1 - b/a) + (a - b)^2/(a b).
  Both terms grow with m and shrink with t, so their largest value on
  the interval is at t = tau_i - D, m = m_i + D (the test asserts
  tau_i > D, where this holds). A max of budgets is Lipschitz with the
  larger constant: L = max(1/3, that).
* hellinger, native: B = max(m^2/4, (sqrt(1 + 2m) - 1)^2, 2 f): L =
  max((m + D)/2, 2 (1 - 1/sqrt(1 + 2(m + D))), 2 x the chi2 f term).

Then |Δ(B^2 n_i / 2)| <= n_i (B_i + L_i D) L_i D =: c_i, and the clamp
at 0 only shrinks a change. delta_upper = sum_i delta_i, so with the
reference's weights w_i = delta_i / delta_upper,

    |Δ log delta_upper| <= log sum_i w_i exp(c_i + r_i) + 2 V_Z 2^-24,

(the log of a sum shifted by at most c_i in each term), where r_i covers
float32 rounding in each package: B, three products and a difference,
each within an ulp of the largest term, r_i = 2 x 4 x 2^-24 x max(V_X log
2, B_i^2 n_i / 2); the last term covers the sum of V_Z exponentials.
"""

import numpy as np
import pytest

from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
ULP = 2.0 ** -24
SPEC = dict(v_z=19, v_x=27, num_tuples=212168, k=5, n_close=5, zipf_a=0.64, seed=2)
GAP, DELTA = 0.16, 0.05
EPS = {"l1": 0.06, "chi2": 0.15, "hellinger": 0.06}


@pytest.fixture(scope="module")
def data():
    spec = SynthSpec(**SPEC)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=256, seed=2)
    ported = convert.dataset_from_numpy(blocked.z_blocks, blocked.x_blocks, blocked.bitmap,
                                        spec.v_z, spec.v_x)
    return ds, blocked, ported


def _budget(metric, mode, tau, m):
    if metric == "l1":
        return m
    tri = (np.sqrt(tau + m) - np.sqrt(tau)) ** 2
    if metric == "chi2":
        return m / 3 if mode == "conservative" else np.maximum(m / 3, tri)
    floor = m * m / 4
    if mode == "conservative":
        return floor
    return np.maximum(np.maximum(floor, (np.sqrt(1 + 2 * m) - 1) ** 2), 2 * tri)


def _lipschitz(metric, mode, tau, m, d):
    """L_i of the docstring on [tau_i - D, tau_i + D]."""
    if metric == "l1":
        return np.ones_like(tau)
    t, mh = tau - d, m + d
    a, b = np.sqrt(t + mh), np.sqrt(t)
    tri = (1 - b / a) + (a - b) ** 2 / (a * b)
    if metric == "chi2":
        return np.full_like(tau, 1 / 3) if mode == "conservative" else np.maximum(1 / 3, tri)
    if mode == "conservative":
        return mh / 2
    return np.maximum(np.maximum(mh / 2, 2 * (1 - 1 / np.sqrt(1 + 2 * mh))), 2 * tri)


@pytest.mark.parametrize("mode", ["native", "conservative"])
@pytest.mark.parametrize("metric", sorted(EPS))
def test_closeness_delta_upper_within_derived_bound(data, metric, mode):
    ds, blocked, ported = data
    kw = dict(max_queries=1, lookahead=256, seed=2, metric=metric, bounds_mode=mode)
    runs = []
    for server in (JServer(blocked, **kw), MatchServer(ported, device="cpu", **kw)):
        server.submit_closeness(ds.target, eps=EPS[metric], gap=GAP, delta=DELTA)
        runs.append(server.run_until_idle())
    (want,), (got,) = runs[0].values(), runs[1].values()
    for f in ("ids", "rounds", "passes", "blocks_read", "blocks_considered", "tuples_read",
              "exact", "stopped", "stop_reason", "qtype"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_array_equal(got.state.n.numpy(), np.asarray(want.state.n))
    tau = np.asarray(want.state.tau, np.float64)
    d = float(np.abs(got.state.tau.numpy().astype(np.float64) - tau).max())
    assert d <= TAU_ATOL
    assert (tau > d).all()  # the native budgets' constants need t > 0 on the interval
    n = np.asarray(want.state.n, np.float64)
    m = np.asarray(want.state.eps_i, np.float64)  # the closeness margin
    big = _budget(metric, mode, tau, m)
    lip = _lipschitz(metric, mode, tau, m, d)
    c = n * (big + lip * d) * lip * d
    v_x = SPEC["v_x"]
    r = 2 * 4 * ULP * np.maximum(v_x * np.log(2.0), big * big * n / 2)
    log_delta = np.asarray(want.state.log_delta_i, np.float64)
    w = np.exp(log_delta - log_delta.max())
    w /= w.sum()
    bound = float(np.log(np.sum(w * np.exp(c + r)))) + 2 * SPEC["v_z"] * ULP
    gap = abs(np.log(float(got.delta_upper)) - np.log(float(want.delta_upper)))
    assert gap <= bound, (gap, bound, d)
