"""The port's fused ingest against the reference's `ingest`.

`ops.ingest_counts(counts, n, z, x)` returns ``(counts + hist(z, x),
n + rowsum(hist))`` in new tensors; on the CPU it runs its plain
version, which these tests hold bitwise against
`repro.core.multiquery.ingest`: through the reference's plain histogram
(what `ingest` runs on the CPU) and through the Pallas histogram kernel
in interpret mode. Inputs are made with numpy from a seed. The kernel
itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiquery as jmq
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import multiquery as tmq
from repro_torch.io import InMemorySource
from repro_torch.kernels import histogram as thistogram
from repro_torch.kernels import ops

# (v_z, v_x, samples): V_Z off every tile size, the main path's width,
# and widths on both sides of the kernel's one-thread-per-row limit
SHAPES = [
    (7548, 24, 3_000),
    (2110, 5, 2_000),
    (301, 33, 1_500),
    (64, 161, 1_000),
    (1, 1, 16),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(rng, v_z, v_x, n, *, dropped=0.1):
    """A state's counts and n (n == row sums) and a batch of ids, a share
    of them out of range on either side."""
    counts = rng.integers(0, 50, size=(v_z, v_x)).astype(np.float32)
    counts[rng.random(v_z) < 0.2] = 0.0
    z = rng.integers(0, v_z, size=n).astype(np.int32)
    x = rng.integers(0, v_x, size=n).astype(np.int32)
    off = rng.random(n) < dropped
    z[off] = rng.choice([-1, -7, v_z, v_z + 3], size=int(off.sum()))
    off = rng.random(n) < dropped / 2
    x[off] = rng.choice([-1, v_x], size=int(off.sum()))
    return counts, counts.sum(axis=1), z, x


def _reference(counts, n, z, x, *, v_z, v_x, pallas=False):
    spec = jmq.MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=1)
    state = jmq.init_multi_state(spec)._replace(counts=jnp.asarray(counts), n=jnp.asarray(n))
    if not pallas:
        out = jmq.ingest(state, jnp.asarray(z), jnp.asarray(x), spec=spec)
    else:
        # the reference's ingest body, its histogram forced onto the Pallas
        # kernel in interpret mode
        hist = functools.partial(jops.histogram_with_rowsums, impl="pallas", interpret=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmq.ops, "histogram_with_rowsums", hist)
            out = jmq.ingest.__wrapped__(state, jnp.asarray(z), jnp.asarray(x), spec=spec)
    return np.asarray(out.counts), np.asarray(out.n)


def _port(counts, n, z, x, *, v_z, v_x):
    c, m = ops.ingest_counts(_t(counts), _t(n), _t(z), _t(x), v_z=v_z, v_x=v_x)
    return c.numpy(), m.numpy()


class TestIngestCounts:
    @pytest.mark.parametrize("v_z,v_x,n", SHAPES)
    def test_matches_reference(self, v_z, v_x, n):
        rng = np.random.default_rng(v_z * 31 + v_x)
        args = _inputs(rng, v_z, v_x, n)
        got = _port(*args, v_z=v_z, v_x=v_x)
        want = _reference(*args, v_z=v_z, v_x=v_x)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    @pytest.mark.parametrize("v_z,v_x,n", [(300, 7, 777), (10, 2, 100), (1, 1, 16)])
    def test_matches_pallas_interpret(self, v_z, v_x, n):
        rng = np.random.default_rng(n)
        args = _inputs(rng, v_z, v_x, n)
        got = _port(*args, v_z=v_z, v_x=v_x)
        want = _reference(*args, v_z=v_z, v_x=v_x, pallas=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    def test_inputs_not_mutated(self):
        rng = np.random.default_rng(4)
        counts, n, z, x = (_t(a) for a in _inputs(rng, 97, 24, 5_000))
        before = [t.clone() for t in (counts, n, z, x)]
        c, m = ops.ingest_counts(counts, n, z, x, v_z=97, v_x=24)
        for t, b in zip((counts, n, z, x), before):
            assert torch.equal(t, b)
        assert c.data_ptr() != counts.data_ptr() and m.data_ptr() != n.data_ptr()
        assert not torch.equal(c, counts)

    @pytest.mark.parametrize("n", [0, 200], ids=["empty", "all-dropped"])
    def test_nothing_kept_returns_the_inputs(self, n):
        rng = np.random.default_rng(9)
        counts, rows, _, _ = _inputs(rng, 50, 7, 0)
        z = np.full(n, -1, np.int32)
        x = rng.integers(0, 7, size=n).astype(np.int32)
        got = _port(counts, rows, z, x, v_z=50, v_x=7)
        np.testing.assert_array_equal(got[0], counts)
        np.testing.assert_array_equal(got[1], rows)
        want = _reference(counts, rows, z, x, v_z=50, v_x=7)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    def test_fresh_histograms_are_ingest_from_zero(self):
        rng = np.random.default_rng(12)
        _, _, z, x = (_t(a) for a in _inputs(rng, 40, 9, 3_000))
        zeros = torch.zeros((40, 9)), torch.zeros(40)
        c, m = ops.ingest_counts(*zeros, z, x, v_z=40, v_x=9)
        hc, hr = ops.histogram_with_rowsums(z, x, v_z=40, v_x=9)
        assert torch.equal(c, hc) and torch.equal(m, hr)
        assert torch.equal(ops.histogram(z, x, v_z=40, v_x=9), hc)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        counts, n = torch.zeros((2, 2)), torch.zeros(2)
        z = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            thistogram.ingest_counts(counts, n, z, z, v_z=2, v_x=2)


@pytest.fixture(scope="module")
def small_dataset():
    spec = SynthSpec(v_z=40, v_x=6, num_tuples=150_000, k=4, n_close=4,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.5, seed=5)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=40, v_x=6, block_size=256, seed=5)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return ds, blocked, ported


def _leaves(named_tuple) -> dict:
    return {k: np.asarray(v) for k, v in jax.device_get(named_tuple)._asdict().items()}


def test_fused_round_marking_nothing_returns_the_old_state(small_dataset):
    """A window where nothing is marked: the ingest and stats still run,
    and `fused_round` returns the old state leaf by leaf, as the
    reference's ``lax.cond`` does; only the cursor's round counters move."""
    ds, blocked, ported = small_dataset
    jspec = jmq.MultiQuerySpec(v_z=40, v_x=6, max_queries=2, k_cap=4)
    sched = jmq.SharedCountsScheduler(blocked, jspec, window=32, seed=0, start_block=0)
    sched.admit(ds.target, k=4, eps=0.1, delta=0.05)
    win = sched.order[:32]
    sched.run_window(win)
    assert sched.blocks_read > 0
    state = convert.multi_state_from_numpy(_leaves(sched.state), device="cpu")
    cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
    tspec = tmq.MultiQuerySpec(v_z=40, v_x=6, max_queries=2, k_cap=4)
    wd = InMemorySource(ported, device="cpu").fetch(win, pad_to=32)  # every block read

    new_state, new_cursor = tmq.fused_round(state, cursor, wd, spec=tspec, policy="anyactive")
    for name in tmq.MultiQueryState._fields:
        assert torch.equal(getattr(new_state, name), getattr(state, name)), name
    assert torch.equal(new_cursor.read_mask, cursor.read_mask)
    assert int(new_cursor.blocks_read) == int(cursor.blocks_read)
    assert int(new_cursor.rounds) == int(cursor.rounds) + 1

    ref_state, _ = jmq.fused_round(
        sched.state, sched.cursor, sched.source.fetch(win, pad_to=32), spec=jspec,
        policy="anyactive", plans=sched.plans,
    )
    for name, want in _leaves(ref_state).items():
        if name in tmq.MultiQueryState._fields:
            got = getattr(new_state, name).numpy()
            np.testing.assert_array_equal(got.view(want.dtype) if want.dtype == np.uint32
                                          else got, want.astype(got.dtype), err_msg=name)
