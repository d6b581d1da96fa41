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
