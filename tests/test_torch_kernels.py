"""The port's kernels against the JAX reference's.

On the CPU every `repro_torch.kernels.ops` entry point runs its plain
PyTorch version; these tests hold each against `repro.kernels.ref` /
`repro.kernels.metrics` on the shape lists of tests/test_kernels.py, and
a small subset against the Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them). Inputs are made with numpy from a
seed and handed to both packages. Integer outputs (counts, rows, marks)
must be equal; tau agrees to 2e-5, the reference kernels' own bar.

The CUDA kernels themselves compile and run only on a GPU; the tests in
tests/test_torch_cuda.py hold each against its plain version there.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import metrics as jmetrics
from repro.kernels import ref as jref
from repro.kernels.anyactive import anyactive_pallas
from repro.kernels.histogram import histogram_pallas, histogram_with_rowsums_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import anyactive as tanyactive
from repro_torch.kernels import histogram as thistogram
from repro_torch.kernels import metrics as tmetrics
from repro_torch.kernels import ops, ref

TAU_ATOL = 2e-5

HIST_SHAPES = [
    (161, 24, 5_000),
    (7548, 24, 2_000),
    (64, 161, 1_000),
    (10, 2, 100),
    (300, 7, 777),
    (1, 1, 16),
    (2110, 5, 3_000),
]
DIST_SHAPES = [(161, 24), (7548, 12), (33, 161), (5, 2), (256, 2048)]
ANYACTIVE_SHAPES = [(1000, 161), (333, 7548), (17, 33), (4096, 64)]
METRICS = list(tmetrics.METRIC_NAMES)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(rng, v_z, v_x, n):
    """(z, x) ids including the out-of-range values the kernels drop."""
    z = rng.integers(-2, v_z + 2, size=n).astype(np.int32)
    x = rng.integers(-2, v_x + 2, size=n).astype(np.int32)
    return z, x


def _counts(rng, v_z, v_x):
    c = rng.integers(0, 40, size=(v_z, v_x)).astype(np.float32)
    c[rng.random(v_z) < 0.2] = 0.0  # never-sampled candidates
    return c


def _targets(rng, q, v_x):
    return np.stack([rng.dirichlet(np.ones(v_x)).astype(np.float32) for _ in range(q)])


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


class TestHistogram:
    @pytest.mark.parametrize("v_z,v_x,n", HIST_SHAPES)
    def test_matches_reference(self, v_z, v_x, n):
        rng = np.random.default_rng(v_z * 7 + n)
        z, x = _ids(rng, v_z, v_x, n)
        c, r = ops.histogram_with_rowsums(_t(z), _t(x), v_z=v_z, v_x=v_x)
        wc, wr = jref.histogram_with_rowsums_ref(jnp.asarray(z), jnp.asarray(x), v_z=v_z, v_x=v_x)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(r.numpy(), np.asarray(wr))
        unfused = ops.histogram(_t(z), _t(x), v_z=v_z, v_x=v_x)
        np.testing.assert_array_equal(unfused.numpy(), c.numpy())

    @pytest.mark.parametrize("v_z,v_x,n", [(10, 2, 100), (300, 7, 777), (1, 1, 16)])
    def test_matches_pallas_interpret(self, v_z, v_x, n):
        rng = np.random.default_rng(n)
        z, x = _ids(rng, v_z, v_x, n)
        c, r = ops.histogram_with_rowsums(_t(z), _t(x), v_z=v_z, v_x=v_x)
        wc, wr = histogram_with_rowsums_pallas(
            jnp.asarray(z), jnp.asarray(x), v_z=v_z, v_x=v_x, interpret=True
        )
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(r.numpy(), np.asarray(wr))

    def test_out_of_range_dropped(self):
        z = torch.tensor([0, 5, 99, -1, 1, 2], dtype=torch.int32)
        x = torch.tensor([0, 1, 0, 0, -1, 2], dtype=torch.int32)
        c, r = ops.histogram_with_rowsums(z, x, v_z=4, v_x=2)
        assert float(c.sum()) == 1.0  # only (0, 0) is in range
        np.testing.assert_array_equal(r.numpy(), [1.0, 0.0, 0.0, 0.0])

    def test_rows_are_row_sums(self):
        rng = np.random.default_rng(5)
        z, x = _ids(rng, 50, 9, 4_000)
        c, r = ops.histogram_with_rowsums(_t(z), _t(x), v_z=50, v_x=9)
        np.testing.assert_array_equal(r.numpy(), c.numpy().sum(axis=1))


    @pytest.mark.parametrize("bins", [14, 64])
    def test_z_less_matches_pallas_interpret(self, bins):
        """A V_Z = 1 histogram without z ids (the monitor's and the
        registry's call) is the reference's call with zeros for z."""
        rng = np.random.default_rng(bins)
        x = rng.integers(-2, bins + 2, size=3_001).astype(np.int32)
        got = ops.histogram(None, _t(x), v_z=1, v_x=bins)
        want = histogram_pallas(jnp.zeros_like(jnp.asarray(x)), jnp.asarray(x), v_z=1,
                                v_x=bins, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_z_less_needs_one_row(self):
        x = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="v_z == 1"):
            ops.histogram(None, x, v_z=2, v_x=3)

    @pytest.mark.parametrize(
        "v_z,v_x,form",
        [(1, 64, "private"), (1, 14, "private"), (64, 128, "private"), (7548, 24, "global"),
         (1, thistogram.PRIVATE_MAX_BINS, "private"),
         (1, thistogram.PRIVATE_MAX_BINS + 1, "global")],
    )
    def test_form_rule(self, v_z, v_x, form):
        """Kernel B's form is a function of (V_Z, V_X) alone: the private
        form where the counts fit its bound, the global form past it."""
        assert thistogram.form_for(v_z, v_x) == form


class TestDistance:
    @pytest.mark.parametrize("v_z,v_x", DIST_SHAPES)
    def test_l1_matches_reference(self, v_z, v_x):
        rng = np.random.default_rng(v_z + v_x)
        counts = (rng.random((v_z, v_x)) * 100).astype(np.float32)
        counts[rng.random(v_z) < 0.2] = 0.0
        q = rng.dirichlet(np.ones(v_x)).astype(np.float32)
        got = ops.l1_distance(_t(counts), _t(q)).numpy()
        want = np.asarray(jref.l1_distance_ref(jnp.asarray(counts), jnp.asarray(q)))
        np.testing.assert_allclose(got, want, atol=TAU_ATOL)

    @pytest.mark.parametrize("metric", METRICS)
    @pytest.mark.parametrize("q", [1, 3, 8])
    @pytest.mark.parametrize("v_x", [64, 4096, 8192])
    def test_multi_matches_reference(self, metric, q, v_x):
        rng = np.random.default_rng(q * 100 + v_x)
        counts, q_hat = _counts(rng, 96, v_x), _targets(rng, q, v_x)
        got = ops.distance_multi(_t(counts), _t(q_hat), metric=metric).numpy()
        want = np.asarray(
            jmetrics.distance_multi_ref(jnp.asarray(counts), jnp.asarray(q_hat), metric=metric)
        )
        assert got.shape == (q, 96) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TAU_ATOL)

    @pytest.mark.parametrize("metric", METRICS)
    @pytest.mark.parametrize("sweeps", [1, 2])
    def test_multi_matches_pallas_interpret(self, metric, sweeps):
        rng = np.random.default_rng(11)
        counts, q_hat = _counts(rng, 40, 300), _targets(rng, 3, 300)
        got = ops.distance_multi(_t(counts), _t(q_hat), metric=metric).numpy()
        want = np.asarray(
            jmetrics.distance_multi_pallas(
                jnp.asarray(counts), jnp.asarray(q_hat), metric=metric,
                x_tile=128 if sweeps == 2 else 4096, sweeps=sweeps, interpret=True,
            )
        )
        np.testing.assert_allclose(got, want, atol=TAU_ATOL)

    @pytest.mark.parametrize("metric", METRICS)
    def test_empty_row_tau(self, metric):
        rng = np.random.default_rng(2)
        counts, q_hat = _counts(rng, 12, 24), _targets(rng, 2, 24)
        counts[3] = 0.0
        got = ops.distance_multi(_t(counts), _t(q_hat), metric=metric).numpy()
        np.testing.assert_allclose(got[:, 3], tmetrics.METRICS[metric].empty_row_tau, atol=1e-6)

    def test_single_query_bound(self):
        with pytest.raises(ValueError, match="exceeds single-block"):
            tmetrics.distance(torch.zeros((8, 5000)), torch.zeros((5000,)))

    def test_unknown_metric(self):
        with pytest.raises(ValueError, match="unknown metric"):
            tmetrics.coerce_metric("cosine")


class TestAnyActive:
    @pytest.mark.parametrize("nb,v_z", ANYACTIVE_SHAPES)
    def test_matches_reference(self, nb, v_z):
        rng = np.random.default_rng(nb + v_z)
        w = -(-v_z // 32)
        bm, mask = _words(rng, (nb, w)), _words(rng, (w,))
        bm[rng.random(nb) < 0.3] = 0  # rows with no candidate
        got = ops.anyactive(_t(bm.view(np.int32)), _t(mask.view(np.int32))).numpy()
        want = np.asarray(jref.anyactive_ref(jnp.asarray(bm), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)

    def test_matches_pallas_interpret(self):
        rng = np.random.default_rng(17)
        bm, mask = _words(rng, (17, 2)), _words(rng, (2,))
        bm[::3] &= ~mask  # some rows miss the mask entirely
        got = ops.anyactive(_t(bm.view(np.int32)), _t(mask.view(np.int32))).numpy()
        want = np.asarray(anyactive_pallas(jnp.asarray(bm), jnp.asarray(mask), interpret=True))
        np.testing.assert_array_equal(got, want)

    def test_empty_mask_skips_all(self):
        bm = _words(np.random.default_rng(1), (100, 3)).view(np.int32)
        assert not ops.anyactive(_t(bm), torch.zeros(3, dtype=torch.int32)).any()

    def test_full_mask_reads_nonempty(self):
        bm = _words(np.random.default_rng(2), (100, 3))
        bm[0] = 0
        mask = np.full((3,), 0xFFFFFFFF, np.uint32)
        got = ops.anyactive(_t(bm.view(np.int32)), _t(mask.view(np.int32))).numpy()
        assert not got[0] and got[1:].sum() == bm[1:].any(axis=1).sum()

    def test_bit_31(self):
        """Candidate 31 of a word is the int32 sign bit."""
        bm = np.zeros((4, 2), np.uint32)
        bm[1, 0] = 1 << 31  # block 1 holds candidate 31
        bm[2, 1] = 1 << 31  # block 2 holds candidate 63
        bm[3, 0] = 1 << 30
        mask = np.array([1 << 31, 0], np.uint32)
        got = ops.anyactive(_t(bm.view(np.int32)), _t(mask.view(np.int32))).numpy()
        np.testing.assert_array_equal(got, [False, True, False, False])
        want = np.asarray(jref.anyactive_ref(jnp.asarray(bm), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)


class TestDispatch:
    def test_cpu_tensors_take_plain_versions(self):
        launches = {name: k.launches for name, k in ops.KERNELS.items()}
        z = torch.tensor([0, 1], dtype=torch.int32)
        ops.histogram_with_rowsums(z, z, v_z=2, v_x=2)
        ops.ingest_counts(torch.zeros((2, 2)), torch.zeros(2), z, z, v_z=2, v_x=2)
        ops.distance_multi(torch.ones((2, 2)), torch.full((1, 2), 0.5))
        ops.anyactive(torch.ones((2, 1), dtype=torch.int32), torch.ones(1, dtype=torch.int32))
        assert {name: k.launches for name, k in ops.KERNELS.items()} == launches

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """A kernel wrapper never runs the plain version in its place."""
        z = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            thistogram.histogram_with_rowsums(z, z, v_z=2, v_x=2)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tmetrics.distance_multi(torch.ones((2, 2)), torch.ones((1, 2)))
        words = torch.ones(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tanyactive.anyactive(words[None, :], words)

    def test_ref_histogram_has_fixed_shape(self):
        """The plain histogram keeps out-of-range ids as zero weights
        instead of filtering them (no data-dependent shapes)."""
        z = torch.tensor([-1, 3], dtype=torch.int32)
        c = ref.histogram_ref(z, torch.tensor([0, 0], dtype=torch.int32), v_z=2, v_x=1)
        np.testing.assert_array_equal(c.numpy(), [[0.0], [0.0]])

    def test_failed_build_raises(self):
        """Without a CUDA toolkit a kernel cannot be built, and the build
        raises; nothing falls back to the plain version."""
        from torch.utils.cpp_extension import CUDA_HOME

        if shutil.which("nvcc") or CUDA_HOME:
            pytest.skip("a CUDA toolkit is installed here")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all()
        with pytest.raises(ValueError, match="unknown kernel source"):
            _build.CudaKernel("gemm", "fm_gemm", ())
