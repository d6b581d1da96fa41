"""The port's CUDA kernels and engine on the card.

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (counts, rows and marks equal; tau within 2e-5), kernel C's
uint16 form against its f32 form bit for bit (the overflow gate too),
every kernel plan the tuner tries against the default plan, and the
engine on the card against the engine on the CPU. These tests need a GPU and
skip elsewhere; they import no JAX, so they run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine, histsim
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset
from repro_torch.kernels import anyactive, autotune, histogram, metrics, ops, ref
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run only on a GPU")
    return torch.device("cuda")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def test_histogram(cuda):
    rng = np.random.default_rng(0)
    z = rng.integers(-2, 7550, size=262_144).astype(np.int32)
    x = rng.integers(-2, 26, size=262_144).astype(np.int32)
    zc, xc = _t(z, cuda), _t(x, cuda)
    before = ops.KERNELS["histogram"].launches
    c, r = histogram.histogram_with_rowsums(zc, xc, v_z=7548, v_x=24)
    wc, wr = ref.histogram_with_rowsums_ref(zc, xc, v_z=7548, v_x=24)
    assert torch.equal(c, wc) and torch.equal(r, wr)
    assert torch.equal(histogram.histogram(zc, xc, v_z=7548, v_x=24), wc)
    assert ops.KERNELS["histogram"].launches == before + 2


def _window_ids(rng, kind, n, v_z=7548, v_x=24):
    """Ids as the main path sends them ("zipf": zipf 0.3 z, ~10 % of the
    512-tuple blocks -1), uniform, or with ids out of range."""
    if kind == "zipf":
        freq = np.arange(1, v_z + 1, dtype=np.float64) ** -0.3
        z = rng.choice(v_z, size=n, p=freq / freq.sum()).astype(np.int32)
        x = rng.integers(0, v_x, size=n).astype(np.int32)
        off = np.repeat(rng.random(-(-n // 512)) < 0.1, 512)[:n]
        z[off], x[off] = -1, -1
        return z, x
    lo, hi = (0, 0) if kind == "uniform" else (-2, 2)
    return (rng.integers(lo, v_z + hi, size=n).astype(np.int32),
            rng.integers(lo, v_x + hi, size=n).astype(np.int32))


@pytest.mark.parametrize(
    "kind,n", [("zipf", 262_144), ("uniform", 262_144), ("out-of-range", 262_144),
               ("zipf", 0), ("zipf", 2_097_152), ("out-of-range", 1_001)]
)
def test_ingest_counts(cuda, kind, n):
    """The fused ingest against its plain version, twice back to back; the
    inputs stay as they were and the scratch is all zero after each call."""
    rng = np.random.default_rng(n + len(kind))
    v_z, v_x = 7548, 24
    counts = _t(rng.integers(0, 500, size=(v_z, v_x)).astype(np.float32), cuda)
    rows = counts.sum(dim=1)
    before = ops.KERNELS["histogram"].launches
    for _ in range(2):
        z, x = (_t(a, cuda) for a in _window_ids(rng, kind, n))
        kept = (counts.clone(), rows.clone(), z.clone(), x.clone())
        got = histogram.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x)
        want = histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip((counts, rows, z, x), kept))
        assert not bool(histogram.delta_scratch(v_z, v_x, cuda).any())
        counts, rows = got
    assert ops.KERNELS["histogram"].launches == before + 2


def _pinned_form(form, z, x, counts, rows, v_z, v_x):
    """Kernel B's C entry with its form pinned: the fused ingest's outputs
    (counts and rows given) or the fresh histogram's, with row sums."""
    dev = x.device
    out = torch.empty((v_z, v_x), dtype=torch.float32, device=dev)
    n_out = torch.empty((v_z,), dtype=torch.float32, device=dev)
    histogram.KERNEL.launch(
        None if z is None else z.data_ptr(), x.data_ptr(),
        None if counts is None else counts.data_ptr(), None if rows is None else rows.data_ptr(),
        out.data_ptr(), n_out.data_ptr(), histogram.delta_scratch(v_z, v_x, dev).data_ptr(),
        x.numel(), v_z, v_x, histogram.FORMS[form])
    return out, n_out


def _scratch_clear(v_z, v_x, device):
    """The scratch all zero."""
    return not bool(histogram.delta_scratch(v_z, v_x, device).any())


def _form_ids(rng, kind, n, v_z, v_x):
    """(z, x) for the form tests: "skewed" crowds N(0, 1) values into the
    central bins (the monitor's activations; z uniform), "uniform", or
    "out-of-range" (ids from -2 to the bound + 2)."""
    if kind == "skewed":
        x = np.clip(np.floor((rng.standard_normal(n) + 8.0) / 16.0 * v_x), 0, v_x - 1)
        return rng.integers(0, v_z, size=n).astype(np.int32), x.astype(np.int32)
    lo, hi = (0, 0) if kind == "uniform" else (-2, 2)
    return (rng.integers(lo, v_z + hi, size=n).astype(np.int32),
            rng.integers(lo, v_x + hi, size=n).astype(np.int32))


FORM_SHAPES = [(1, 64, 587_776), (1, 14, 91), (64, 128, 524_288), (7548, 24, 262_144)]


@pytest.mark.parametrize("kind", ["skewed", "uniform", "out-of-range", "empty", "unaligned"])
@pytest.mark.parametrize("v_z,v_x,n", FORM_SHAPES)
def test_kernel_b_forms_bitwise(cuda, v_z, v_x, n, kind):
    """Each form kernel B can take at the callers' shapes (the global form
    always, the private one up to PRIVATE_MAX_BINS), pinned at the C
    entry, bitwise the plain ingest and histogram; the wrapper's call in
    the rule's form the same; inputs unchanged, the scratch zero after
    every call. "unaligned" is a view one element off its 16-byte
    alignment, n - 1 long (no multiple of 4)."""
    rng = np.random.default_rng(v_z * v_x + n + len(kind))
    z, x = (_t(a, cuda) for a in _form_ids(rng, "skewed" if kind == "unaligned" else
                                           ("uniform" if kind == "empty" else kind),
                                           0 if kind == "empty" else n, v_z, v_x))
    if kind == "unaligned":
        z, x = z[1:], x[1:]
    counts = _t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32), cuda)
    rows = counts.sum(dim=1)
    kept = [a.clone() for a in (counts, rows, z, x)]
    want = histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x)
    fresh = ref.histogram_with_rowsums_ref(z, x, v_z=v_z, v_x=v_x)
    forms = ["global"] + (["private"] if histogram.form_for(v_z, v_x) == "private" else [])
    for form in forms:
        got = _pinned_form(form, z, x, counts, rows, v_z, v_x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), form
        assert _scratch_clear(v_z, v_x, cuda), form
        got = _pinned_form(form, z, x, None, None, v_z, v_x)
        assert torch.equal(got[0], fresh[0]) and torch.equal(got[1], fresh[1]), form
        assert _scratch_clear(v_z, v_x, cuda), form
    got = histogram.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(histogram.histogram(z, x, v_z=v_z, v_x=v_x), fresh[0])
    assert all(torch.equal(a, b) for a, b in zip((counts, rows, z, x), kept))
    assert _scratch_clear(v_z, v_x, cuda)


@pytest.mark.parametrize("v_z,v_x,form", [(1, 64, "private"), (1, 14, "private"),
                                          (64, 128, "private"), (7548, 24, "global"),
                                          (1, histogram.PRIVATE_MAX_BINS, "private"),
                                          (1, histogram.PRIVATE_MAX_BINS + 1, "global")])
def test_kernel_b_form_launches(cuda, v_z, v_x, form):
    """Each shape launches the form `form_for` names, counted once under
    FORM_LAUNCHES and once under KERNELS["histogram"]; both sides of the
    threshold are bitwise the plain version."""
    rng = np.random.default_rng(v_x)
    z, x = (_t(a, cuda) for a in _form_ids(rng, "out-of-range", 100_003, v_z, v_x))
    assert histogram.form_for(v_z, v_x) == form
    before, launches = dict(histogram.FORM_LAUNCHES), ops.KERNELS["histogram"].launches
    c, r = histogram.histogram_with_rowsums(z, x, v_z=v_z, v_x=v_x)
    wc, wr = ref.histogram_with_rowsums_ref(z, x, v_z=v_z, v_x=v_x)
    assert torch.equal(c, wc) and torch.equal(r, wr)
    assert histogram.FORM_LAUNCHES == {**before, form: before[form] + 1}
    assert ops.KERNELS["histogram"].launches == launches + 1
    assert _scratch_clear(v_z, v_x, cuda)


@pytest.mark.parametrize("v_x,n", [(64, 587_776), (64, 4_097), (14, 91), (14, 0),
                                   (histogram.PRIVATE_MAX_BINS + 1, 50_001)])
def test_kernel_b_z_less(cuda, v_x, n):
    """`histogram(None, x, v_z=1)` reads the x ids alone: bitwise the call
    with zeros for z and the plain version, in both forms pinned too; z
    None with V_Z > 1 raises."""
    rng = np.random.default_rng(n)
    _, x = (_t(a, cuda) for a in _form_ids(rng, "out-of-range", n, 1, v_x))
    zeros = torch.zeros_like(x)
    want = ref.histogram_ref(zeros, x, v_z=1, v_x=v_x)
    assert torch.equal(ops.histogram(None, x, v_z=1, v_x=v_x), want)
    assert torch.equal(histogram.histogram(zeros, x, v_z=1, v_x=v_x), want)
    forms = ["global"] + (["private"] if histogram.form_for(1, v_x) == "private" else [])
    for form in forms:
        c, r = _pinned_form(form, None, x, None, None, 1, v_x)
        assert torch.equal(c, want) and float(r[0]) == float(want.sum()), form
        assert _scratch_clear(1, v_x, cuda)
    with pytest.raises(ValueError, match="v_z == 1"):
        histogram.histogram(None, x, v_z=2, v_x=v_x)
    with pytest.raises(TypeError, match="only histogram"):
        histogram.histogram_with_rowsums(None, x, v_z=1, v_x=v_x)


@pytest.mark.parametrize("v_z,v_x,n", FORM_SHAPES)
def test_kernel_b_forms_back_to_back(cuda, v_z, v_x, n):
    """Each form, pinned, launched 200 times back to back behind a sleep
    kernel (as the timed loops of chip_smoke.py run it), each launch into
    its own outputs: every output bitwise the plain ingest, the scratch
    zero at the end."""
    rng = np.random.default_rng(n)
    z, x = (_t(a, cuda) for a in _form_ids(rng, "out-of-range", n, v_z, v_x))
    counts = _t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32), cuda)
    rows = counts.sum(dim=1)
    want = histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x)
    forms = ["global"] + (["private"] if histogram.form_for(v_z, v_x) == "private" else [])
    for form in forms:
        torch.cuda._sleep(1_000_000)
        outs = [_pinned_form(form, z, x, counts, rows, v_z, v_x) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(torch.equal(c, want[0]) and torch.equal(r, want[1]) for c, r in outs), form
        assert _scratch_clear(v_z, v_x, cuda), form


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("v_z", [1, 5, 7548])
@pytest.mark.parametrize("v_x", [1, 7, 24, 1024])
def test_distance_narrow(cuda, metric, q, v_z, v_x):
    """The row-tile branch of kernel C (V_X <= 1024) against plain."""
    rng = np.random.default_rng(q * v_z + v_x)
    counts = rng.integers(0, 40, size=(v_z, v_x)).astype(np.float32)
    counts[rng.random(v_z) < 0.2] = 0.0
    q_hat = np.stack([rng.dirichlet(np.ones(v_x)) for _ in range(q)]).astype(np.float32)
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    got = metrics.distance_multi(c, t, metric=metric)
    torch.testing.assert_close(got, metrics.distance_multi_ref(c, t, metric=metric),
                               atol=TAU_ATOL, rtol=0)


@pytest.mark.parametrize(
    "v_x,sweeps,lowprec,branch",
    [(1024, 0, False, "distance_tile_kernel"),
     (1025, 0, False, "distance_wide_cluster_kernel"),
     (24, 2, False, "distance_wide_cluster_kernel"), (1024, 1, False, "distance_tile_kernel"),
     (24, 0, True, "distance_tile_u16"), (24, 2, True, "distance_wide_cluster_u16"),
     (1025, 0, True, "distance_wide_cluster_u16")],
)
def test_distance_branch(cuda, v_x, sweeps, lowprec, branch):
    """V_X = 1024 is the widest row-tile launch; 1025, or sweeps = 2 at
    any V_X, takes the cluster-tiled wide branch; the uint16 form of each
    branch is a kernel of its own, counted apart."""
    from torch.profiler import ProfilerActivity, profile

    c = torch.ones((64, v_x), device=cuda)
    t = torch.full((1, v_x), 1.0 / v_x, device=cuda)
    gate = (c, torch.ones((), dtype=torch.bool, device=cuda)) if lowprec else None
    cc = c.to(torch.uint16) if lowprec else c

    def call():
        return metrics.distance_multi(cc, t, sweeps=sweeps, gate=gate)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "distance_" in e.name]
    assert names and all(branch in name for name in names), names
    (name, count), = autotune.tau_launches(
        autotune.TauPlan(sweeps=sweeps, lowprec=lowprec), v_x, 1).items()
    before = ops.KERNELS[name].launches
    call()
    assert ops.KERNELS[name].launches == before + count


# the wide branch's grid: V_X past the narrow branch's 1024, the
# two-sweep fallback's width (300,000: no cluster of 8 holds one row's
# slice beside the targets' at any Q here), and short rows under a
# forced sweeps = 2
WIDE_VX = (1, 2, 24, 1025, 1440, 4097, 8192, 65536, 300_000)
WIDE_VZ = (1, 3, 131, 161, 256)
WIDE_Q = (1, 3, 8, 9, 16)


def _card_case(cuda, v_z, v_x, q, seed):
    """Integer counts below 40 with ~20 % empty rows (row 0 always) and q
    Dirichlet(1) targets, made on the card from ``seed``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    counts = torch.randint(0, 40, (v_z, v_x), generator=gen, device=cuda).float()
    counts[torch.rand(v_z, generator=gen, device=cuda) < 0.2] = 0.0
    counts[0] = 0.0
    e = -torch.log(torch.rand((q, v_x), generator=gen, device=cuda).clamp_min(1e-12))
    return counts, (e / e.sum(dim=1, keepdim=True)).contiguous()


@pytest.mark.parametrize("v_z", WIDE_VZ)
@pytest.mark.parametrize("v_x", WIDE_VX)
def test_distance_wide(cuda, v_z, v_x):
    """Kernel C's wide branch against its plain version within 2e-5 at
    every Q and metric; its uint16 form bitwise the f32 form, in range
    and with the gate tripped (one entry of 70,000); two launches give
    the same bits."""
    counts, q_all = _card_case(cuda, v_z, v_x, max(WIDE_Q), v_z * 7 + v_x)
    over = counts.clone()
    over[-1, v_x // 2] = 70_000.0
    gates = ((counts, torch.amax(counts) <= 65535.0), (over, torch.amax(over) <= 65535.0))
    assert bool(gates[0][1]) and not bool(gates[1][1])
    for q in WIDE_Q:
        t = q_all[:q].contiguous()
        for metric in metrics.METRIC_NAMES:
            for c, fits in gates:
                got = metrics.distance_multi(c, t, metric=metric, sweeps=2)
                again = metrics.distance_multi(c, t, metric=metric, sweeps=2)
                got16 = metrics.distance_multi(c.to(torch.uint16), t, metric=metric, sweeps=2,
                                               gate=(c, fits))
                want = metrics.distance_multi_ref(c, t, metric=metric)
                msg = f"Q={q} {metric} fits={bool(fits)}"
                assert torch.equal(got, again), msg
                assert torch.equal(got16, got), msg
                torch.testing.assert_close(got, want, atol=TAU_ATOL, rtol=0, msg=msg)


@pytest.mark.parametrize("v_z,v_x", [(3, 1025), (161, 1440), (131, 4097), (5, 300_000)])
@pytest.mark.parametrize("q", [1, 9])
def test_distance_wide_unaligned_view(cuda, v_z, v_x, q):
    """Counts whose first element is not 16-byte aligned (a contiguous
    view one element into its storage, in f32 and in uint16): every row
    slice starts off a 16-byte boundary, and the kernel still agrees."""
    counts, t = _card_case(cuda, v_z, v_x, q, v_x + q)
    flat = torch.zeros(v_z * v_x + 1, device=cuda)
    flat[1:] = counts.reshape(-1)
    view = flat[1:].view(v_z, v_x)
    flat16 = flat.to(torch.uint16)
    view16 = flat16[1:].view(v_z, v_x)
    assert view.data_ptr() % 16 and view16.data_ptr() % 16
    fits = torch.ones((), dtype=torch.bool, device=cuda)
    for metric in metrics.METRIC_NAMES:
        want = metrics.distance_multi(counts, t, metric=metric, sweeps=2)
        got = metrics.distance_multi(view, t, metric=metric, sweeps=2)
        got16 = metrics.distance_multi(view16, t, metric=metric, sweeps=2, gate=(view, fits))
        assert torch.equal(got, want) and torch.equal(got16, want), metric


def _u16_case(rng, v_z, v_x, q, hi=40):
    counts = rng.integers(0, hi, size=(v_z, v_x)).astype(np.float32)
    counts[rng.random(v_z) < 0.2] = 0.0
    q_hat = np.stack([rng.dirichlet(np.ones(v_x)) for _ in range(q)]).astype(np.float32)
    return counts, q_hat


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("v_x", [2, 24, 1000, 8192])
@pytest.mark.parametrize("sweeps", [0, 2])
def test_distance_u16_equals_f32(cuda, metric, q, v_x, sweeps):
    """Kernel C's uint16 form against its f32 form at the same launch
    choices, bit for bit (each element is upcast on load); both branches
    (sweeps = 0 takes the narrow one up to V_X = 1024), counts up to the
    uint16 ceiling, and a gate computed on the card."""
    rng = np.random.default_rng(q * v_x + sweeps)
    v_z = 256 if v_x == 8192 else 7548
    counts, q_hat = _u16_case(rng, v_z, v_x, q, hi=65_536 if v_x == 24 else 40)
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    fits = torch.amax(c) <= 65535.0
    want = metrics.distance_multi(c, t, metric=metric, sweeps=sweeps)
    got = metrics.distance_multi(c.to(torch.uint16), t, metric=metric, sweeps=sweeps,
                                 gate=(c, fits))
    assert torch.equal(got, want), float((got - want).abs().max())
    torch.testing.assert_close(got, metrics.distance_multi_ref(c.to(torch.uint16), t,
                                                               metric=metric),
                               atol=TAU_ATOL, rtol=0)


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize("v_z,v_x,sweeps", [(7548, 24, 0), (7548, 24, 2), (256, 8192, 0)])
def test_distance_u16_gate_overflow(cuda, metric, v_z, v_x, sweeps):
    """One entry of 70,000 trips the gate: the uint16 form reads the f32
    counts (the cast wrapped that entry) and equals the f32 form bit for
    bit, through the kernel and through a lowprec plan."""
    rng = np.random.default_rng(v_x + sweeps)
    counts, q_hat = _u16_case(rng, v_z, v_x, 8)
    counts[3, 5] = 70_000.0
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    fits = torch.amax(c) <= 65535.0
    want = metrics.distance_multi(c, t, metric=metric, sweeps=sweeps)
    got = metrics.distance_multi(c.to(torch.uint16), t, metric=metric, sweeps=sweeps,
                                 gate=(c, fits))
    assert not bool(fits) and torch.equal(got, want)
    plan = autotune.TauPlan(sweeps=sweeps, lowprec=True)
    assert torch.equal(ops.distance_multi(c, t, metric=metric, plan=plan), want)
    c[3, 5] = 65_535.0  # in range again: the uint16 counts are read
    want = metrics.distance_multi(c, t, metric=metric, sweeps=sweeps)
    assert torch.equal(ops.distance_multi(c, t, metric=metric, plan=plan), want)


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize("v_z,v_x,q", [(7548, 24, 1), (7548, 24, 8), (161, 24, 8), (191, 2, 1),
                                       (256, 8192, 3)])
def test_every_cuda_tau_candidate(cuda, metric, v_z, v_x, q):
    """Every plan the tuner tries on the card against `DEFAULT_TAU`:
    within the reference's 3e-6 for its branch candidates, the same
    top-k ids, and bit for bit where only the counts' type or the
    unrolling differ; each makes the launches
    `autotune.tau_launches` says."""
    rng = np.random.default_rng(v_z + q)
    counts, q_hat = _u16_case(rng, v_z, v_x, q, hi=50)
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    want = ops.distance_multi(c, t, metric=metric, plan="default")
    wide_default = metrics.wide_branch(v_x)
    k = min(10, v_z)
    top = torch.argsort(want, dim=1, stable=True)[:, :k].sort(dim=1).values
    for plan in autotune.tau_candidates("cuda", v_z, v_x, q):
        before = {name: kern.launches for name, kern in ops.KERNELS.items()}
        got = ops.distance_multi(c, t, metric=metric, plan=plan)
        launched = {name: kern.launches - before[name] for name, kern in ops.KERNELS.items()}
        assert launched == {name: autotune.tau_launches(plan, v_x, q).get(name, 0)
                            for name in ops.KERNELS}, plan
        if metrics.wide_branch(v_x, sweeps=plan.sweeps) == wide_default:
            assert torch.equal(got, want), plan
        torch.testing.assert_close(got, want, atol=3e-6, rtol=0, msg=repr(plan))
        got_top = torch.argsort(got, dim=1, stable=True)[:, :k].sort(dim=1).values
        assert torch.equal(got_top, top), plan


@pytest.mark.parametrize("v_z,v_x", [(7548, 24), (161, 24), (191, 2)])
def test_both_ingest_plans_bitwise_equal(cuda, v_z, v_x):
    """The fused ingest (one kernel-B launch) and the two-step form
    (kernel B's histogram, a row reduction and the adds) give the same
    counts and row sums, bit for bit."""
    rng = np.random.default_rng(v_z)
    z = _t(rng.integers(-1, v_z + 1, size=262_144).astype(np.int32), cuda)
    x = _t(rng.integers(-1, v_x + 1, size=262_144).astype(np.int32), cuda)
    counts = _t(rng.integers(0, 500, size=(v_z, v_x)).astype(np.float32), cuda)
    rows = counts.sum(dim=1)
    outs = []
    for plan in autotune.ingest_candidates("cuda", v_z, v_x):
        before = ops.KERNELS["histogram"].launches
        outs.append(ops.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x, plan=plan))
        assert ops.KERNELS["histogram"].launches == before + 1
    (c0, n0), (c1, n1) = outs
    assert torch.equal(c0, c1) and torch.equal(n0, n1)
    want = histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x)
    assert torch.equal(c0, want[0]) and torch.equal(n0, want[1])


def test_tuner_on_card(cuda, tmp_path, monkeypatch):
    """tune_tau / tune_ingest measure every candidate on the card, and
    resolve_plans tunes a missing key and saves it as backend "cuda".
    A winner other than `DEFAULT_TAU` beat it by the margin."""
    plan, timed = autotune.tune_tau(161, 24, 8, device="cuda", reps=3)
    assert set(timed) == set(autotune.tau_candidates("cuda", 161, 24, 8)) and plan in timed
    default = timed[autotune.DEFAULT_TAU]
    assert plan == autotune.DEFAULT_TAU or default > timed[plan] * (1 + autotune.DEFAULT_MARGIN)
    monkeypatch.setenv("FASTMATCH_TORCH_PLANS_DIR", str(tmp_path))
    monkeypatch.setenv("FASTMATCH_TORCH_AUTOTUNE", "1")
    autotune.reload(backend="cuda")
    try:
        pair = autotune.resolve_plans(64, 16, 2, device="cuda")
        reg = autotune.PlanRegistry.load(path=tmp_path / "cuda.json", backend="cuda")
        assert reg.tau_plan(64, 16, 2) == pair.tau and reg.ingest_plan(64, 16) == pair.ingest
    finally:
        monkeypatch.delenv("FASTMATCH_TORCH_PLANS_DIR")
        monkeypatch.delenv("FASTMATCH_TORCH_AUTOTUNE")
        autotune.reload(backend="cuda")


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize(
    "q,v_z,v_x", [(1, 7548, 24), (8, 7548, 24), (3, 256, 8192), (2, 100, 1025), (1, 5, 1)]
)
def test_distance_multi(cuda, metric, q, v_z, v_x):
    rng = np.random.default_rng(q + v_x)
    counts = rng.integers(0, 40, size=(v_z, v_x)).astype(np.float32)
    counts[rng.random(v_z) < 0.2] = 0.0
    q_hat = np.stack([rng.dirichlet(np.ones(v_x)) for _ in range(q)]).astype(np.float32)
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    got = metrics.distance_multi(c, t, metric=metric)
    want = metrics.distance_multi_ref(c, t, metric=metric)
    torch.testing.assert_close(got, want, atol=TAU_ATOL, rtol=0)


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
@pytest.mark.parametrize("q", [8, 16])
def test_distance_multi_at_max_queries(cuda, metric, q):
    """Kernel C as the serving path launches it: Q = max_queries targets
    at the TAXI shape, through the op the scheduler calls."""
    rng = np.random.default_rng(q)
    counts = rng.integers(0, 400, size=(7548, 24)).astype(np.float32)
    counts[rng.random(7548) < 0.1] = 0.0
    q_hat = np.stack([rng.dirichlet(np.ones(24)) for _ in range(q)]).astype(np.float32)
    c, t = _t(counts, cuda), _t(q_hat, cuda)
    # the plan registered for this shape, if any, picks the launches
    plan = autotune.coerce_tau_plan("auto", 7548, 24, q, metric, "cuda")
    before = {name: kern.launches for name, kern in ops.KERNELS.items()}
    got = ops.distance_multi(c, t, metric=metric)
    launched = {name: kern.launches - before[name] for name, kern in ops.KERNELS.items()}
    assert launched == {name: autotune.tau_launches(plan, 24, q).get(name, 0)
                        for name in ops.KERNELS}
    assert got.shape == (q, 7548)
    torch.testing.assert_close(got, metrics.distance_multi_ref(c, t, metric=metric),
                               atol=TAU_ATOL, rtol=0)


def test_anyactive_bit_31(cuda):
    rng = np.random.default_rng(3)
    bm = rng.integers(0, 2**32, size=(512, 236), dtype=np.uint32)
    mask = rng.integers(0, 2**32, size=(236,), dtype=np.uint32)
    bm[rng.random(512) < 0.5] &= ~mask
    bm[7] = 0
    bm[7, 5] = 1 << 31
    mask[5] |= np.uint32(1 << 31)
    b, m = _t(bm.view(np.int32), cuda), _t(mask.view(np.int32), cuda)
    got = anyactive.anyactive(b, m)
    assert torch.equal(got, ref.anyactive_ref(b, m))
    assert bool(got[7])


def _marking_inputs(cuda, rows, words, seed):
    """A bitmap table larger than the 50 MB L2, a window of ``rows`` ids
    into it (~10 % padding, id 0), a read mask (~25 % read) and an active
    mask; window row 0 holds only the bit-31 candidate of the last word."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    num_blocks = max((64 << 20) // (4 * words), 2 * rows)
    table = torch.randint(-2**31, 2**31, (num_blocks, words), generator=gen,
                          dtype=torch.int32, device=cuda)
    mask = torch.randint(-2**31, 2**31, (words,), generator=gen, dtype=torch.int32, device=cuda)
    miss = torch.rand(num_blocks, generator=gen, device=cuda) < 0.5
    table[miss] &= ~mask
    ids = torch.randperm(num_blocks, generator=gen, device=cuda)[:rows]
    valid = torch.rand(rows, generator=gen, device=cuda) >= 0.1
    ids[~valid] = 0
    read_mask = torch.rand(num_blocks, generator=gen, device=cuda) < 0.25
    valid[0] = True
    read_mask[ids[0]] = False
    table[ids[0]] = 0
    table[ids[0], words - 1] = -2**31
    mask[words - 1] |= -2**31
    return ids, valid, read_mask, table, mask


@pytest.mark.parametrize("rows", [1, 512, 4096])
@pytest.mark.parametrize("words", [1, 3, 236, 237])
def test_mark_blocks(cuda, words, rows):
    """The fused marking against its plain version: rows read in place
    from the table and from a gathered window, and the scan form, twice
    back to back; the inputs are unchanged after every call."""
    ids, valid, read_mask, table, mask = _marking_inputs(cuda, rows, words, words * 10 + rows)
    window = table[ids]
    kept = [a.clone() for a in (ids, valid, read_mask, table, mask, window)]
    before = ops.KERNELS["anyactive"].launches
    for _ in range(2):
        want = ref.mark_blocks_ref(ids, valid, read_mask, table, mask, by_id=True)
        got = anyactive.mark_blocks(ids, valid, read_mask, table, mask, by_id=True)
        assert torch.equal(got, want) and bool(got[0])
        got = anyactive.mark_blocks(ids, valid, read_mask, window, mask)
        assert torch.equal(got, want)
        got = anyactive.mark_blocks(ids, valid, read_mask)
        assert torch.equal(got, ref.mark_blocks_ref(ids, valid, read_mask))
        assert all(torch.equal(a, b) for a, b in
                   zip((ids, valid, read_mask, table, mask, window), kept))
    assert ops.KERNELS["anyactive"].launches == before + 6
    if rows > 1:
        assert bool(want.any()) and not bool(want.all())


def test_mark_blocks_unaligned_rows(cuda):
    """W % 4 == 0 but rows that start off a 16-byte boundary take the
    word-by-word path."""
    ids, valid, read_mask, table, mask = _marking_inputs(cuda, 512, 236, 99)
    flat = torch.empty(512 * 236 + 1, dtype=torch.int32, device=cuda)
    window = flat[1:].view(512, 236)
    window.copy_(table[ids])
    assert window.data_ptr() % 16 != 0
    want = ref.mark_blocks_ref(ids, valid, read_mask, table, mask, by_id=True)
    assert torch.equal(anyactive.mark_blocks(ids, valid, read_mask, window, mask), want)


def test_engine_on_card_equals_cpu(cuda):
    spec = SynthSpec(v_z=80, v_x=16, num_tuples=600_000, k=8, n_close=8,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=7)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=80, v_x=16, block_size=512, seed=7)
    params = histsim.HistSimParams(v_z=80, v_x=16, k=8, eps=0.08, delta=0.05)
    cfg = engine.EngineConfig(variant="fastmatch", seed=3, lookahead=64)
    a = engine.run_engine(blocked, ds.target, params, cfg, device="cuda")
    b = engine.run_engine(blocked, ds.target, params, cfg, device="cpu")
    np.testing.assert_array_equal(a.ids, b.ids)
    for f in ("blocks_read", "tuples_read", "rounds", "passes", "exact"):
        assert getattr(a, f) == getattr(b, f), f
    assert torch.equal(a.state.counts.cpu(), b.state.counts)
    torch.testing.assert_close(a.state.tau.cpu(), b.state.tau, atol=TAU_ATOL, rtol=0)


@pytest.mark.parametrize("metric", list(metrics.METRIC_NAMES))
def test_server_on_card_equals_cpu(cuda, metric):
    """Mixed top-k and closeness serving with late admission and a stop
    policy: the same ids, counters and stop fields on the card and on
    the CPU."""
    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.data.synth import perturb_distribution

    spec = SynthSpec(v_z=48, v_x=16, num_tuples=300_000, k=5, n_close=6,
                     close_distance=0.03, far_distance=0.4, zipf_a=1.0, seed=3)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=48, v_x=16, block_size=512, seed=3)
    rng = np.random.default_rng(5)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.05, 0.1)]
    eps_c, gap = {"l1": (0.1, 0.25), "chi2": (0.02, 0.08), "hellinger": (0.01, 0.04)}[metric]
    runs = []
    for device in ("cuda", "cpu"):
        before = {name: kern.launches for name, kern in ops.KERNELS.items()}
        srv = MatchServer(blocked, device=device, max_queries=3, lookahead=16, seed=3,
                          metric=metric, prune=metric == "chi2")
        srv.submit(targets[0], k=5, eps=0.3, delta=0.05)
        srv.submit(targets[1], k=3, eps=0.3, delta=0.05, stop=StopPolicy(tuples=20_000))
        srv.submit_closeness(targets[2], eps=eps_c, gap=gap, delta=0.05)
        while not srv.results:
            srv.step()
        srv.submit_closeness(targets[0], eps=eps_c, gap=gap, delta=0.05)  # admitted late
        results = srv.run_until_idle()
        launched = {name: kern.launches - before[name] for name, kern in ops.KERNELS.items()}
        runs.append((results, srv.scheduler, launched))
    (card, card_sched, launched), (cpu, cpu_sched, cpu_launched) = runs
    assert sorted(card) == sorted(cpu) == [0, 1, 2, 3]
    for rid in cpu:
        a, b = card[rid], cpu[rid]
        np.testing.assert_array_equal(a.ids, b.ids)
        for f in ("rounds", "passes", "blocks_read", "tuples_read", "exact", "stopped",
                  "stop_reason", "qtype"):
            assert getattr(a, f) == getattr(b, f), (rid, f)
        torch.testing.assert_close(a.state.tau.cpu(), b.state.tau, atol=TAU_ATOL, rtol=0)
    assert torch.equal(card_sched.state.counts.cpu(), cpu_sched.state.counts)
    assert launched["anyactive"] == launched["histogram"] == card_sched.rounds
    assert launched["distance_multi"] > card_sched.rounds
    assert all(v == 0 for v in cpu_launched.values())


# ---------------------------------------------------------------------------
# the I/O, fault and recovery layer on the card
# ---------------------------------------------------------------------------


def _fault_fixture(seed=3):
    spec = SynthSpec(v_z=48, v_x=16, num_tuples=300_000, k=5, n_close=6,
                     close_distance=0.03, far_distance=0.4, zipf_a=1.0, seed=seed)
    ds = make_dataset(spec)
    return ds, block_layout(ds.z, ds.x, v_z=48, v_x=16, block_size=512, seed=seed)


def test_corrupted_by_id_window_caught(cuda):
    """A resident window carries the whole table: "auto" checks its
    structure on the card without reading it back, "content" reads its
    rows through the ids, and a fault copy of it is caught."""
    from repro_torch.io import FaultPlan, FaultySource, InMemorySource, ResilientSource
    from repro_torch.io.faults import CorruptWindowError, WindowQuarantined, validate_window

    _, blocked = _fault_fixture()
    src = InMemorySource(blocked, device=cuda)
    kw = dict(num_blocks=src.num_blocks, block_size=src.block_size, v_z=src.v_z, v_x=src.v_x)
    wd = src.fetch(np.arange(8), pad_to=16)
    assert wd.bitmap_by_id and wd.z.is_cuda and wd.bitmap.shape[0] == src.num_blocks
    for level in ("structural", "auto", "content"):
        validate_window(wd, **kw, pad_to=16, level=level)
    z = wd.z.clone()
    z[0, 0] = src.v_z + 7
    validate_window(wd._replace(z=z), **kw, level="auto")  # a device window: structure only
    with pytest.raises(CorruptWindowError, match="z values"):
        validate_window(wd._replace(z=z), **kw, level="content")
    with pytest.raises(CorruptWindowError, match="bitmap table"):
        validate_window(wd._replace(bitmap=wd.bitmap[:-1]), **kw, level="structural")
    for plan in (FaultPlan(p_corrupt=1.0), FaultPlan(p_truncate=1.0)):
        res = ResilientSource(FaultySource(src, plan))
        with pytest.raises(WindowQuarantined):
            res.fetch(np.arange(8), pad_to=16)
        np.testing.assert_array_equal(res.take_quarantined(), np.arange(8))


def test_host_window_reaches_round_on_card(cuda):
    """A host-resident source hands over host windows; the scheduler moves
    each to the card once and the kernels run on it: the same answers as
    the resident table."""
    from repro_torch.io import InMemorySource

    ds, blocked = _fault_fixture()
    runs = []
    for resident in (False, True):
        src = InMemorySource(blocked, device_resident=resident, device=cuda)
        if not resident:
            assert src.fetch(np.arange(4)).z.device.type == "cpu"
        before = {name: kern.launches for name, kern in ops.KERNELS.items()}
        srv = MatchServer(src, max_queries=2, lookahead=16, seed=3)
        rid = srv.submit(ds.target, k=5, eps=0.3, delta=0.05)
        res = srv.run_until_idle()[rid]
        launched = {name: kern.launches - before[name] for name, kern in ops.KERNELS.items()}
        assert launched["anyactive"] == launched["histogram"] == srv.scheduler.rounds > 0
        assert launched["distance_multi"] > 0
        assert srv.scheduler.state.counts.is_cuda
        runs.append(res)
    a, b = runs
    np.testing.assert_array_equal(a.ids, b.ids)
    assert (a.rounds, a.tuples_read) == (b.rounds, b.tuples_read)
    assert torch.equal(a.state.counts, b.state.counts) and torch.equal(a.state.tau, b.state.tau)


def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "block-prefetch" and t.is_alive()]


def test_prefetch_over_host_resident_source_bitwise(cuda):
    """FastMatch from host memory with and without prefetch, and from the
    resident table with prefetch: bitwise the same answer."""
    from repro_torch.io import InMemorySource

    ds, blocked = _fault_fixture()
    params = histsim.HistSimParams(v_z=48, v_x=16, k=5, eps=0.08, delta=0.05)
    runs = []
    for resident, prefetch in ((False, False), (False, True), (True, True)):
        src = InMemorySource(blocked, device_resident=resident, device=cuda)
        cfg = engine.EngineConfig(variant="fastmatch", seed=3, lookahead=16, prefetch=prefetch)
        runs.append(engine.run_engine(src, ds.target, params, cfg))
    for r in runs[1:]:
        np.testing.assert_array_equal(r.ids, runs[0].ids)
        assert (r.rounds, r.blocks_read) == (runs[0].rounds, runs[0].blocks_read)
        assert torch.equal(r.state.counts, runs[0].state.counts)
        assert torch.equal(r.state.tau, runs[0].state.tau)
    assert not _prefetch_threads()


def test_prefetch_side_stream_waits_on_its_event(cuda, monkeypatch):
    """The staging copies run on a side stream held back by a sleep
    kernel; the round's stream must wait on their event, so what it reads
    is the window, not the memory before the copy."""
    from repro_torch.io import InMemorySource, PrefetchSource
    from repro_torch.io import prefetch as prefetch_mod

    _, blocked = _fault_fixture()
    host = InMemorySource(blocked, device_resident=False, device=cuda)
    stage = prefetch_mod._stage

    def slow_stage(wd, device, side):
        with torch.cuda.stream(side):
            torch.cuda._sleep(100_000_000)
        return stage(wd, device, side)

    monkeypatch.setattr(prefetch_mod, "_stage", slow_stage)
    wins = [np.arange(i * 16, (i + 1) * 16) for i in range(4)]
    got = PrefetchSource(host).stream(wins, pad_to=16)
    for a, b in zip(got, host.stream(wins, pad_to=16)):
        assert a.z.is_cuda and torch.cuda.current_stream() == torch.cuda.default_stream()
        for f in ("indices", "z", "x", "bitmap", "valid"):
            assert torch.equal(getattr(a, f), getattr(b, f).to(cuda)), f
    assert not _prefetch_threads()


def test_snapshot_written_on_card_restores_on_cpu(cuda, tmp_path):
    ds, blocked = _fault_fixture()
    srv = MatchServer(blocked, checkpoint_dir=str(tmp_path), max_queries=2, lookahead=16, seed=3)
    srv.submit(ds.target, k=5, eps=0.3, delta=0.05)
    srv.run_until_idle()
    srv.save_cache()
    back = MatchServer.restore(blocked, checkpoint_dir=str(tmp_path), device="cpu",
                               max_queries=2, lookahead=16)
    assert torch.equal(back.scheduler.state.counts, srv.scheduler.state.counts.cpu())
    np.testing.assert_array_equal(back.scheduler.read_mask, srv.scheduler.read_mask)
    assert back.scheduler.tuples_read == srv.scheduler.tuples_read


# ---------------------------------------------------------------------------
# telemetry on the card: the registry's binning is kernel B at V_Z = 1
# ---------------------------------------------------------------------------

# the registry's three edge sets: the latency bins, fastmatch_query_tuples'
# and fastmatch_query_rounds'
REGISTRY_EDGES = {
    "latency": None,
    "tuples": tuple(float(10 ** e) for e in range(2, 11)),
    "rounds": tuple(float(2 ** e) for e in range(0, 14)),
}


def _registry_samples(edges, n, seed):
    """``n`` samples spread log-uniformly around the edges, a quarter of
    them exactly on an edge (le semantics: they count in that bucket)."""
    rng = np.random.default_rng(seed)
    e = np.asarray(edges)
    vals = np.exp(rng.uniform(np.log(e[0] / 10), np.log(e[-1] * 10), size=n))
    on_edge = rng.random(n) < 0.25
    vals[on_edge] = rng.choice(e, size=int(on_edge.sum()))
    return vals


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1_000_000])
@pytest.mark.parametrize("which", list(REGISTRY_EDGES))
def test_registry_histogram_on_card(cuda, which, n):
    """A card histogram bins bitwise as np.bincount(np.searchsorted(...)),
    with one kernel-B launch per non-empty flush and none for an empty one."""
    from repro_torch.obs import DEFAULT_LATENCY_BINS, MetricsRegistry

    edges = REGISTRY_EDGES[which] or DEFAULT_LATENCY_BINS
    reg = MetricsRegistry()
    assert reg.device.type == "cuda"
    h = reg.histogram(f"{which}_seconds", edges=edges)
    vals = _registry_samples(edges, n, seed=n + len(which))
    h.observe_many(vals)
    want = np.bincount(np.searchsorted(edges, vals, side="left"), minlength=len(edges) + 1)
    before = ops.KERNELS["histogram"].launches
    got = h.bucket_counts()
    assert ops.KERNELS["histogram"].launches == before + (n > 0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and h.count == n
    # a second flush with nothing pending launches nothing; new samples add
    h.bucket_counts()
    assert ops.KERNELS["histogram"].launches == before + (n > 0)
    h.observe(edges[0])
    want[0] += 1
    np.testing.assert_array_equal(h.bucket_counts(), want)
    assert ops.KERNELS["histogram"].launches == before + (n > 0) + 1


def test_registry_flush_on_side_stream_thread(cuda):
    """A registry read from a second thread whose current stream is a side
    stream (as the prefetch worker's is) gets its own kernel-B scratch and
    the same counts as a read from the default stream."""
    import threading

    from repro_torch.obs import MetricsRegistry

    edges = REGISTRY_EDGES["rounds"]
    vals = _registry_samples(edges, 50_000, seed=5)
    want = np.bincount(np.searchsorted(edges, vals, side="left"), minlength=len(edges) + 1)
    reg = MetricsRegistry(device=cuda)
    main, side_h = reg.histogram("a_total_rounds", edges=edges), reg.histogram("b_rounds", edges=edges)
    main.observe_many(vals)
    side_h.observe_many(vals)
    out, errors = {}, []

    def read():
        try:
            side = torch.cuda.Stream(cuda)
            with torch.cuda.stream(side):
                torch.cuda._sleep(10_000_000)  # the side stream is busy first
                out["side"] = side_h.bucket_counts()
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    t = threading.Thread(target=read)
    t.start()
    out["main"] = main.bucket_counts()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(out["main"], want)
    np.testing.assert_array_equal(out["side"], want)


def test_server_telemetry_bitwise_on_card(cuda):
    """On the 3M fixture: a `MatchServer(telemetry=True)` serves bitwise as
    its telemetry=None twin, with the same polls and the same launches;
    its registry is binned on the card afterwards."""
    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.data.synth import perturb_distribution

    spec = SynthSpec(v_z=80, v_x=16, num_tuples=3_000_000, k=8, n_close=8,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=7)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=80, v_x=16, block_size=512, seed=7)
    rng = np.random.default_rng(17)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.05, 0.1)]
    runs = []
    for telemetry in (None, True, None, True):
        before = {name: kern.launches for name, kern in ops.KERNELS.items()}
        srv = MatchServer(blocked, device=cuda, max_queries=4, lookahead=64, seed=3,
                          telemetry=telemetry)
        srv.submit(targets[0], k=8, eps=0.08, delta=0.05)
        srv.submit(targets[1], k=8, eps=0.08, delta=0.05, stop=StopPolicy(tuples=20_000))
        srv.submit(targets[2], k=4, eps=0.08, delta=0.05)
        while not srv.results:
            srv.step()
        for tg in targets[:2]:
            srv.submit_closeness(tg, eps=0.1, gap=0.2, delta=0.05)
        results = srv.run_until_idle()
        torch.cuda.synchronize()
        launched = {name: kern.launches - before[name] for name, kern in ops.KERNELS.items()}
        runs.append((srv, results, launched))
    (off, off_res, off_launched) = runs[0]
    for srv, results, launched in runs[1:]:
        assert launched == off_launched
        assert sorted(results) == sorted(off_res) == list(range(5))
        for rid, b in off_res.items():
            a = results[rid]
            np.testing.assert_array_equal(a.ids, b.ids)
            for f in ("rounds", "passes", "blocks_read", "tuples_read", "exact", "stopped",
                      "stop_reason", "qtype"):
                assert getattr(a, f) == getattr(b, f), (rid, f)
            assert torch.equal(a.state.tau, b.state.tau)
        s, o = srv.scheduler, off.scheduler
        assert (s.host_syncs, s.loop_syncs, s.rounds) == (o.host_syncs, o.loop_syncs, o.rounds)
        for x, y in zip(s.export_cache(), o.export_cache()):
            assert torch.equal(x, y)
    on = runs[1][0]
    reg = on.telemetry.registry
    assert reg.device.type == "cuda"
    before = ops.KERNELS["histogram"].launches
    snap = reg.snapshot()
    hists = [name for name, m in snap.items() if m["kind"] == "histogram" and m["count"]]
    assert ops.KERNELS["histogram"].launches == before + len(hists)
    assert snap["fastmatch_rounds_total"]["value"] == on.scheduler.rounds
    assert snap["fastmatch_query_rounds"]["count"] == 5
    assert sum(snap["fastmatch_query_rounds"]["buckets"]) == 5


def _card_lockstep_rank(rank, world, shape):
    """One rank on the card: its `DistributedPump` and a single-stream
    scheduler driven with the same 12 shuffled windows (an admission at
    round 3, retirements at the polls), then, with one worker, a `pump()`
    loop of each; every rank returns its checks and kernel launches."""
    from repro_torch.core import distributed
    from repro_torch.core import multiquery as mq
    from repro_torch.core.pump import DistributedPump
    from repro_torch.data.synth import perturb_distribution

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = distributed.init_mesh(shape, device_type="cuda")
    ds = make_dataset(SynthSpec(v_z=64, v_x=16, num_tuples=300_000, k=5, n_close=5, seed=3))
    blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=3)
    spec = mq.MultiQuerySpec(v_z=64, v_x=16, max_queries=4)
    rng = np.random.default_rng(9)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.03, 0.05)]
    ref = mq.SharedCountsScheduler(blocked, spec, window=32, seed=0, start_block=7, device=dev)
    pmp = DistributedPump(blocked, spec, mesh=mesh, window=32, seed=0, start_block=7)
    for t in targets[:3]:
        ref.admit(t, k=5, eps=0.08, delta=0.02)
        pmp.admit(t, k=5, eps=0.08, delta=0.02)
    order = np.random.default_rng(1).permutation(blocked.num_blocks)
    before = {k: c.launches for k, c in ops.KERNELS.items()}
    checks = []

    def same():
        counts, n = pmp._full_counts()
        return [torch.equal(counts, ref.state.counts), torch.equal(n, ref.state.n),
                torch.equal(pmp.state.tau, ref.state.tau),
                torch.equal(pmp.state.delta_upper, ref.state.delta_upper),
                bool(np.array_equal(ref.read_mask, pmp.read_mask)),
                (ref.rounds, ref.tuples_read) == (pmp.rounds, pmp.tuples_read),
                sorted(ref.tickets) == sorted(pmp.tickets)]

    for r in range(12):
        if r == 3:
            ref.admit(targets[3], k=3, eps=0.1, delta=0.02)
            pmp.admit(targets[3], k=3, eps=0.1, delta=0.02)
        win = order[r * 32 : (r + 1) * 32]
        ref.run_window(win)
        pmp.run_window(win)
        ref._poll_terminated()
        pmp._poll_terminated()
        checks.append(all(same()))
    if pmp.num_workers == 1:
        # one worker: the whole pump() loop is the scheduler's too (more
        # workers read other blocks a round)
        for s in (ref, pmp):
            s.admit(targets[0], k=3, eps=0.05, delta=0.05)
            s.pump(max_passes=2)
        checks.append(all(same()))
    launched = {k: c.launches - before[k] for k, c in ops.KERNELS.items()}
    return dict(checks=checks, retired=len(ref.outcomes), launched=launched,
                on_card=pmp.state.counts.is_cuda and pmp.shard._z.is_cuda)


def test_one_rank_nccl_pump_bitwise_scheduler(cuda):
    """A one-rank NCCL mesh: the pump is the single-stream scheduler, bit
    for bit, through the hand-written kernels."""
    from repro_torch.core import distributed

    (res,) = distributed.run_ranks(_card_lockstep_rank, 1, (1, 1), backend="nccl",
                                   device_type="cuda", timeout=600)
    assert all(res["checks"]) and res["retired"] > 0 and res["on_card"], res
    assert res["launched"]["anyactive"] > 0 and res["launched"]["histogram"] > 0
    assert res["launched"]["distance_multi"] > 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_two_gloo_ranks_on_one_card_lockstep(cuda, shape):
    """Two gloo ranks on cuda:0 (data- or candidate-sharded): bitwise the
    single-stream scheduler every round; every rank launches kernels A, B
    and C."""
    from repro_torch.core import distributed

    ranks = distributed.run_ranks(_card_lockstep_rank, 2, shape, backend="gloo",
                                  device_type="cuda", timeout=600)
    for res in ranks:
        assert all(res["checks"]) and res["retired"] > 0 and res["on_card"], res
        for kernel in ("anyactive", "histogram", "distance_multi"):
            assert res["launched"][kernel] > 0, (kernel, res["launched"])


# ---------------------------------------------------------------------------
# the data layer and the LM on the card
# ---------------------------------------------------------------------------


def test_monitor_bin_ids_on_card_equal_cpu(cuda):
    """CUDA's saturating cast and the CPU's wrapping one give the same
    bins, because the ids are clamped in float first."""
    from repro_torch.train import monitor

    rng = np.random.default_rng(11)
    x = np.concatenate([
        np.asarray([np.nan, np.inf, -np.inf, 1e30, -1e30, 3e38, -3e38, -8.0, 8.0, 7.9999995,
                    -8.0000005, 0.0], np.float32),
        (rng.standard_normal(100_000) * 5).astype(np.float32),
    ])
    for bins in (64, 7):
        want = monitor._bin_ids(torch.from_numpy(x), -8.0, 8.0, bins)
        got = monitor._bin_ids(_t(x, cuda), -8.0, 8.0, bins)
        assert torch.equal(got.cpu(), want)
        assert int(want[0]) == 0 and int(want[1]) == bins - 1 and int(want[3]) == bins - 1


@pytest.mark.parametrize("n", [0, 1, 4096, 587_776])
def test_monitor_histogram_is_kernel_b(cuda, n):
    """Kernel B at (1, 64), the monitor's shape, bitwise `histogram_ref`,
    one launch a monitored tensor."""
    from repro_torch.train import ActivationMonitor

    rng = np.random.default_rng(n)
    x = _t((rng.standard_normal(n) * 3).astype(np.float32), cuda).to(torch.bfloat16)
    mon = ActivationMonitor(names=["a", "b"], bins=64)
    before = ops.KERNELS["histogram"].launches
    h = mon._histogram({"a": x, "b": x * 4})
    assert ops.KERNELS["histogram"].launches == before + 2
    from repro_torch.train import monitor

    for row, t in zip(h, (x, x * 4)):
        ids = monitor._bin_ids(t, mon.lo, mon.hi, mon.bins)
        want = ref.histogram_ref(torch.zeros_like(ids), ids, v_z=1, v_x=64)[0]
        assert np.array_equal(row, want.cpu().numpy())
        assert row.sum() == n


def test_lm_decode_consistency_on_card(cuda):
    """prefill(first half) + decode(second half) == forward at the smoke
    config on the card, in float32 (atol 1e-4) and bfloat16 (0.06)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model

    for dtype, atol in (("float32", 1e-4), ("bfloat16", 0.06)):
        cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype=dtype)
        model = get_model(cfg, device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(0))
        toks = _t(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
                  cuda)
        with torch.no_grad():
            full, _ = model(toks)
        lg, cache = model.prefill(toks[:, :8], 16)
        outs = []
        for t in range(8, 16):
            step, cache = model.decode_step(cache, toks[:, t])
            outs.append(step)
        torch.testing.assert_close(lg, full[:, :8], atol=atol, rtol=0)
        torch.testing.assert_close(torch.stack(outs, 1), full[:, 8:], atol=atol, rtol=0)


def _smoke_pair(cuda, dtype="float32", remat="none"):
    """A smoke qwen2.5-3b drawn on the CPU from seed 0 and its copy on the
    card, each with a fresh AdamW train state."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import TrainState

    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype=dtype, remat=remat)
    host = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(host).to(cuda)
    opt = get_optimizer("adamw", 1e-3)
    return (host, TrainState.create(host, opt)), (card, TrainState.create(card, opt)), opt


def _leaf_bits(state):
    from repro_torch.optimizer.base import tree_leaves

    return [x.detach().view(torch.int16) if x.dtype == torch.bfloat16 else x.detach().clone()
            for x in tree_leaves((state.params, state.opt_state))]


def test_train_step_on_card_equals_cpu(cuda):
    """One train step of the f32 smoke model on the card and on the CPU,
    the same weights and batch: loss and ce within 1e-5, grad_norm within
    1e-5 relative, parameters within 5 % of the learning rate (the CPU
    twins' f32 bars against the reference: Adam's first step normalises
    each grad element)."""
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import make_train_step

    (host, hs), (card, cs), opt = _smoke_pair(cuda)
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    hs, hm = make_train_step(host, opt)(hs, {"tokens": torch.from_numpy(toks)})
    cs, cm = make_train_step(card, opt)(cs, {"tokens": _t(toks, cuda)})
    for k in ("loss", "ce"):
        assert abs(float(cm[k]) - float(hm[k])) <= 1e-5, k
    assert float(cm["step_ok"]) == 1.0
    np.testing.assert_allclose(float(cm["grad_norm"]), float(hm["grad_norm"]), rtol=1e-5)
    assert int(cs.step) == 1
    for a, b in zip(tree_leaves(cs.params), tree_leaves(hs.params)):
        assert a.device.type == "cuda"
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 0.05 * 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_equal_grads_on_card(cuda, dtype):
    """remat full and dots against none on the card: the loss and every
    grad bit for bit (the recomputation reruns the same kernels)."""
    import dataclasses

    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train.step import make_loss_fn

    _, (card, cs), _ = _smoke_pair(cuda, dtype)
    toks = _t(np.random.default_rng(1).integers(0, 256, (2, 32)).astype(np.int32), cuda)
    out = {}
    for remat in ("none", "full", "dots"):
        card.cfg = dataclasses.replace(card.cfg, remat=remat)
        loss = make_loss_fn(card)({"tokens": toks})[0]
        loss.backward()
        out[remat] = (loss.detach(), [p.grad.clone() for p in tree_leaves(cs.params)])
        for p in tree_leaves(cs.params):
            p.grad = None
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))


def test_nan_guard_on_card(cuda):
    """A NaN in an embedding row the batch uses: step_ok 0, every
    parameter and moment bitwise as it was, the step incremented."""
    from repro_torch.train import make_train_step

    _, (card, cs), opt = _smoke_pair(cuda, "bfloat16")
    step = make_train_step(card, opt)
    rng = np.random.default_rng(2)
    cs, _ = step(cs, {"tokens": _t(rng.integers(0, 256, (2, 16)).astype(np.int32), cuda)})
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    with torch.no_grad():
        card.embed["table"][int(toks[0, 3])] = float("nan")
    before = _leaf_bits(cs)
    new, m = step(cs, {"tokens": _t(toks, cuda)})
    assert float(m["step_ok"]) == 0.0 and int(new.step) == int(cs.step) + 1
    assert all(torch.equal(a, b) for a, b in zip(before, _leaf_bits(new)))


def test_bf16_train_state_checkpoint_from_card(cuda, tmp_path):
    """A bf16 train state on the card, after a step, through
    `CheckpointManager` (bf16 leaves as their bits, the step int32) into a
    fresh state on the card: every leaf bitwise, the step back as int64."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import make_train_step

    _, (card, cs), opt = _smoke_pair(cuda, "bfloat16")
    toks = _t(np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32), cuda)
    cs, _ = make_train_step(card, opt)(cs, {"tokens": toks})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(cs.to_disk(), 1)
    _, (other, fresh), _ = _smoke_pair(cuda, "bfloat16")
    loaded = fresh.load_(mgr.restore(fresh.skeleton()))
    assert loaded.step.dtype == torch.int64 and int(loaded.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(_leaf_bits(cs), _leaf_bits(loaded)))
    assert all(p.device.type == "cuda" for p in other.parameters())


def test_train_loop_on_card(cuda):
    """`train_loop` at the smoke config on the card: the selection finds
    the planted domains with kernels A, B and C, every step is finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.launch.train import train_loop

    corpus = make_corpus(CorpusSpec(num_domains=16, num_buckets=32, vocab_size=256,
                                    num_blocks=256, block_tokens=512, n_reference=4,
                                    reference_alpha=0.08, seed=1))
    before = {k: ops.KERNELS[k].launches for k in ("anyactive", "histogram", "distance_multi")}
    out = train_loop(cfg=get_smoke_config("qwen2_5_3b"), steps=4, batch_size=4, seq_len=64,
                     corpus=corpus, select_k=4, log_every=1, log_fn=lambda *_: None)
    assert set(out["selection"].selected_domains.tolist()) == set(corpus.close_ids.tolist())
    assert all(ops.KERNELS[k].launches > n for k, n in before.items())
    assert all(h["step_ok"] == 1.0 and np.isfinite(h["loss"]) for h in out["history"])
    assert out["model"].device.type == "cuda"


FAMILY_ARCHS = ("mixtral_8x7b", "grok_1_314b", "recurrentgemma_2b", "xlstm_125m",
                "whisper_medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_consistency_on_card(cuda, arch):
    """Each family added with MoE, the RG-LRU hybrid, xLSTM and whisper at
    its smoke size in float32 on the card: prefill 8 tokens, decode 8,
    against `forward` on all 16 (atol 1e-4; the prefill stays inside
    recurrentgemma's 16-token window; whisper with seeded encoder frames
    in both)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = get_model(cfg, device=cuda, generator=gen)
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
              cuda)
    extra = {}
    if cfg.frontend == "audio_stub":
        extra["encoder_frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                                              device=cuda) * 0.02
    with torch.no_grad():
        full, _ = model(toks, **extra)
    lg, cache = model.prefill(toks[:, :8], 16, **extra)
    outs = [lg]
    for t in range(8, 16):
        step, cache = model.decode_step(cache, toks[:, t])
        outs.append(step[:, None])
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=1e-4, rtol=0)


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.0), (2, 8.0), (3, 1.0)])
def test_moe_routing_and_combine_on_card_equal_cpu(cuda, top_k, cf):
    """`moe.route` on the card gives the CPU's experts, kept pairs and
    slots bit for bit (weights within 1e-6: the router's products round
    otherwise), and `moe.combine` of the same expert outputs and weights
    is the CPU's bit for bit (products and sums in k order, no atomics)."""
    from repro_torch.models import moe

    rng = np.random.default_rng(top_k)
    e, d, t = 8, 64, 96
    router = torch.from_numpy((rng.standard_normal((d, e)) / 8).astype(np.float32))
    xt = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    kw = dict(num_experts=e, top_k=top_k, capacity_factor=cf)
    host = moe.route(router, xt, **kw)
    card = moe.route(router.to(cuda), xt.to(cuda), **kw)
    assert card["capacity"] == host["capacity"]
    for k in ("experts", "keep", "slot", "slot_token", "slot_used"):
        assert torch.equal(card[k].cpu(), host[k]), k
    torch.testing.assert_close(card["weights"].cpu(), host["weights"], atol=1e-6, rtol=0)
    ye = torch.from_numpy(rng.standard_normal((e * host["capacity"], d)).astype(np.float32))
    want = moe.combine(ye, host["slot"], host["keep"], host["weights"])
    got = moe.combine(ye.to(cuda), host["slot"].to(cuda), host["keep"].to(cuda),
                      host["weights"].to(cuda))
    assert torch.equal(got.cpu(), want)
    if cf < e:
        assert not bool(host["keep"].all())  # the case drops pairs


# ---------------------------------------------------------------------------
# LM sharding on the card
# ---------------------------------------------------------------------------


def _tp_cfg(dtype: str, seq: bool):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("llama3_405b"), d_model=128, num_heads=8,
                               num_kv_heads=2, d_ff=256, dtype=dtype, decode_seq_shard=seq)


def _tp_decode(model, toks):
    logits, cache = model.prefill(toks[:, :16], 32)
    steps = [logits[:, -1]]
    for i in range(16, 20):
        step, cache = model.decode_step(cache, toks[:, i])
        steps.append(step)
    return steps


def _card_tp_rank(rank, world, toks):
    """A 1 x 2 mesh of gloo ranks on the card: the widened llama smoke with
    local heads and under flash-decoding, bf16 and f32."""
    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model

    mesh = distributed.init_mesh((1, 2), device_type="cuda")
    out = {}
    for dtype in ("bfloat16", "float32"):
        for seq in (False, True):
            model = shard_model(_tp_cfg(dtype, seq), mesh,
                                generator=torch.Generator(device="cuda").manual_seed(0))
            steps = _tp_decode(model, torch.from_numpy(toks).cuda())
            out[(dtype, seq)] = dict(
                logits=[s.float().cpu().numpy() for s in steps], cols=model.tp.logits,
                attn=model.tp.attn, on_card=model.embed["table"].is_cuda,
                pick=model.greedy_pick(steps[-1]))
    return out


def test_tp_decode_on_card_equals_one_process(cuda):
    """Two gloo ranks sharing the card, tensor-parallel prefill and decode
    (local heads, then flash-decoding with the cache's sequence split):
    every rank's logit columns within 0.05 (bf16) and 1e-4 (f32) of one
    process's model on the card with the same seed, and the reduced greedy
    pick the one process's argmax."""
    from repro_torch.core import distributed
    from repro_torch.models import model_zoo

    toks = np.random.default_rng(1).integers(0, 512, (4, 32)).astype(np.int32)
    ranks = distributed.run_ranks(_card_tp_rank, 2, toks, backend="gloo", device_type="cuda",
                                  timeout=600)
    for dtype, atol in (("bfloat16", 0.05), ("float32", 1e-4)):
        for seq in (False, True):
            model = model_zoo.get_model(_tp_cfg(dtype, seq), device=cuda,
                                        generator=torch.Generator(device="cuda").manual_seed(0))
            want = [s.float().cpu().numpy() for s in _tp_decode(model, _t(toks, cuda))]
            for res in ranks:
                got = res[(dtype, seq)]
                assert got["on_card"] and got["attn"] == ("whole" if seq else "heads")
                lo, hi = got["cols"]
                for g, w in zip(got["logits"], want):
                    np.testing.assert_allclose(g, w[:, lo:hi], atol=atol, rtol=0)
                assert got["pick"].tolist() == np.argmax(want[-1], -1).tolist()


_FAMILY_ARCHS = ("recurrentgemma_2b", "xlstm_125m", "whisper_medium")


def _family_decode(model, toks, frames):
    extra = {} if frames is None else {"encoder_frames": frames}
    logits, cache = model.prefill(toks[:, :8], 16, **extra)
    steps = [logits[:, -1]]
    for i in range(8, 12):
        step, cache = model.decode_step(cache, toks[:, i])
        steps.append(step)
    return steps


def _family_frames(arch, dtype, rows, device):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if cfg.frontend != "audio_stub":
        return None
    f = np.random.default_rng(2).standard_normal((4, cfg.encoder_seq, cfg.d_model)) * 0.02
    return torch.from_numpy(f[rows].astype(np.float32)).to(device, getattr(torch, dtype))


def _card_family_rank(rank, world, toks):
    """A 1 x 2 mesh of gloo ranks on the card: each recurrent / audio
    family's smoke config sharded, bf16 and f32."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model

    mesh = distributed.init_mesh((1, 2), device_type="cuda")
    out = {}
    for arch in _FAMILY_ARCHS:
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
            model = shard_model(cfg, mesh,
                                generator=torch.Generator(device="cuda").manual_seed(0))
            with torch.no_grad():
                steps = _family_decode(model, torch.from_numpy(toks[arch]).cuda(),
                                       _family_frames(arch, dtype, slice(None), "cuda"))
            out[(arch, dtype)] = dict(
                logits=[s.float().cpu().numpy() for s in steps], cols=model.tp.logits,
                layout=model.tp.layout, on_card=model.embed["table"].is_cuda,
                pick=model.greedy_pick(steps[-1]))
    return out


def test_family_tp_decode_on_card_equals_one_process(cuda):
    """Two gloo ranks sharing the card, the RG-LRU hybrid, xLSTM and whisper
    smoke configs served tensor-parallel (LRU channels, mLSTM and sLSTM
    heads, whisper heads): prefill and 4 decode steps, every rank's logit
    columns within 0.06 (bf16) and 1e-4 (f32) of one process's model on
    the card with the same seed, and the reduced greedy pick its argmax."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import distributed
    from repro_torch.models import model_zoo

    toks = {a: np.random.default_rng(1).integers(
        0, get_smoke_config(a).vocab_size, (4, 12)).astype(np.int32) for a in _FAMILY_ARCHS}
    ranks = distributed.run_ranks(_card_family_rank, 2, toks, backend="gloo",
                                  device_type="cuda", timeout=600)
    for arch in _FAMILY_ARCHS:
        for dtype, atol in (("bfloat16", 0.06), ("float32", 1e-4)):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
            model = model_zoo.get_model(cfg, device=cuda,
                                        generator=torch.Generator(device="cuda").manual_seed(0))
            with torch.no_grad():
                want = [s.float().cpu().numpy() for s in _family_decode(
                    model, _t(toks[arch], cuda), _family_frames(arch, dtype, slice(None), cuda))]
            for res in ranks:
                got = res[(arch, dtype)]
                assert got["on_card"] and got["cols"] is not None
                lo, hi = got["cols"]
                for g, w in zip(got["logits"], want):
                    np.testing.assert_allclose(g, w[:, lo:hi], atol=atol, rtol=0)
                assert got["pick"].tolist() == np.argmax(want[-1], -1).tolist()
