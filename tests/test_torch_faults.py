"""The port's I/O fault layer against the JAX reference's.

Twins of tests/test_faults.py on its fixture (120K tuples, V_Z = 32,
V_X = 16, blocks of 512), on the CPU, each run through both packages on
the same numpy-seeded data: window validation gives the same verdict on
every window of the reference's catalogue (and the port's by-id window
of a device-resident source passes its structural check), the same
`FaultPlan` and seed inject the same faults attempt by attempt and back
off on the same schedule, a `MatchServer` run under faults quarantines
the same block ids with the same ``eps_effective``, a run under
`maybe_chaos` is bitwise the fault-free run and within the tolerance
contract of the reference's run under the same chaos seed, and
`PrefetchSource` (with `EngineConfig(prefetch=True)`) changes no answer
and leaves no worker thread behind. With a `repro_torch.obs.Telemetry`
the resilient source's ``io_*`` counters and ``window_quarantine`` event
equal the reference's for the same faults, and the prefetch stream's
failure counters and events are the reference's.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.io import InMemorySource as JSource
from repro.io.block_source import WindowData as JWindow
from repro.io import faults as jfaults
from repro.obs import Telemetry as JTelemetry
from repro.serve.fastmatch_server import MatchServer as JServer
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import histsim as thistsim
from repro_torch.core import multiquery as tmq
from repro_torch.io import InMemorySource, PrefetchSource, WindowData
from repro_torch.io import faults as tfaults
from repro_torch.obs import Telemetry
from repro_torch.io.faults import (
    CorruptWindowError,
    FaultInjector,
    FaultPlan,
    FaultySource,
    FetchCancelled,
    ResilientSource,
    RetryPolicy,
    TransientIOError,
    UnrecoverableIOError,
    WindowQuarantined,
    find_resilient,
    maybe_chaos,
    validate_window,
)
from repro_torch.serve import MatchServer

TAU_ATOL = 2e-5
K, EPS, DELTA = 5, 0.08, 0.05
CHAOS_ENV = {"FASTMATCH_CHAOS": "1", "FASTMATCH_CHAOS_SEED": "0"}


@pytest.fixture(scope="module")
def dataset():
    spec = SynthSpec(v_z=32, v_x=16, num_tuples=120_000, k=K, n_close=5,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=3)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=5)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return ds, blocked, ported


@pytest.fixture(scope="module")
def sources(dataset):
    """(the reference's host source, the port's host source)."""
    _, blocked, ported = dataset
    return (JSource(blocked, device_resident=False),
            InMemorySource(ported, device_resident=False, device="cpu"))


@pytest.fixture(scope="module")
def targets(dataset):
    ds, _, _ = dataset
    rng = np.random.default_rng(9)
    return [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.04)]


def _windows(nb, width=8, count=6):
    return [np.arange(i * width, min((i + 1) * width, nb)) for i in range(count)]


def _assert_windows_equal(a, b):
    """A port window against a port or reference window, leaf by leaf
    (the port's bitmap words are the reference's uint32 bits)."""
    for f in JWindow._fields:
        got = getattr(a, f).numpy()
        want = getattr(b, f)
        want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        if f == "bitmap":
            got, want = got.view(np.uint32), want.view(np.uint32)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)


class _FlakySource:
    """``script[i]`` is what fetch attempt i does: None serves, an
    exception instance raises; attempts past the script serve."""

    def __init__(self, inner, script):
        self.inner = inner
        self.script = list(script)
        self.calls = 0
        self.num_blocks = inner.num_blocks
        self.block_size = inner.block_size
        self.v_z = inner.v_z
        self.v_x = inner.v_x
        self.tuples_per_block = inner.tuples_per_block
        self.device = getattr(inner, "device", None)

    def fetch(self, win, pad_to=None):
        i = self.calls
        self.calls += 1
        if i < len(self.script) and self.script[i] is not None:
            raise self.script[i]
        return self.inner.fetch(win, pad_to)

    def stream(self, windows, pad_to=None):
        for w in windows:
            yield self.fetch(w, pad_to)


# ------------------------------------------------------------- validation


def _kwargs(src):
    return dict(num_blocks=src.num_blocks, block_size=src.block_size, v_z=src.v_z, v_x=src.v_x)


def _catalogue(wd, v_z, pkg):
    """The windows of the reference's TestValidateWindow, made in one
    package's representation: name -> (window, validate_window kwargs)."""
    copy = (lambda a: a.clone()) if pkg == "port" else (lambda a: np.asarray(a).copy())
    z, x, bm = copy(wd.z), copy(wd.x), copy(wd.bitmap)
    z_out = copy(wd.z)
    z_out[0, 0] = v_z + 7
    x_pad = copy(wd.x)
    x_pad[0, 0] = -1
    if pkg == "port":
        bm[0, 0] ^= 1 << 5
        z_float = wd.z.to(torch.float32)
        cut = WindowData(*(getattr(wd, f)[:-1] for f in JWindow._fields))
    else:
        bm[0, 0] ^= np.uint32(1 << 5)
        z_float = np.asarray(wd.z).astype(np.float32)
        cut = JWindow(*(leaf[:-1] for leaf in wd))
    return {
        "good_content": (wd, dict(pad_to=wd.indices.shape[0], level="content")),
        "truncated": (cut, dict(pad_to=wd.indices.shape[0])),
        "z_out_of_range_structural": (wd._replace(z=z_out), dict(level="structural")),
        "z_out_of_range_content": (wd._replace(z=z_out), dict(level="content")),
        "z_out_of_range_auto": (wd._replace(z=z_out), dict(level="auto")),
        "bitmap_inconsistent": (wd._replace(bitmap=bm), dict(level="content")),
        "padding_mismatch": (wd._replace(x=x_pad), dict(level="content")),
        "wrong_dtype": (wd._replace(z=z_float), dict(level="structural")),
        "untouched_structural": (wd._replace(z=z, x=x), dict(level="structural")),
    }


def _verdict(validate, error, wd, kwargs):
    try:
        validate(wd, **kwargs)
    except error as exc:
        return str(exc).split(":")[0]
    return "ok"


class TestValidateWindow:
    def test_same_verdict_as_reference(self, sources):
        """Every window of the reference's catalogue: the same verdict,
        the same leading words of the message."""
        jsrc, src = sources
        jcat = _catalogue(jsrc.fetch(np.arange(4), pad_to=8), jsrc.v_z, "ref")
        cat = _catalogue(src.fetch(np.arange(4), pad_to=8), src.v_z, "port")
        verdicts = {}
        for name in jcat:
            want = _verdict(jfaults.validate_window, jfaults.CorruptWindowError,
                            jcat[name][0], dict(_kwargs(jsrc), **jcat[name][1]))
            got = _verdict(validate_window, CorruptWindowError,
                           cat[name][0], dict(_kwargs(src), **cat[name][1]))
            verdicts[name] = got
            assert got == want, name
        assert verdicts["good_content"] == "ok" and verdicts["z_out_of_range_structural"] == "ok"
        assert verdicts["truncated"].startswith("window length")
        assert verdicts["bitmap_inconsistent"] == "bitmap inconsistent with window tuples"
        assert verdicts["wrong_dtype"] == "z"

    def test_by_id_window_passes_structural(self, dataset):
        """A device-resident source's window carries the whole table: the
        structural check holds the table to (num_blocks, W) instead of
        the window length, and the content check reads the window's rows."""
        _, _, ported = dataset
        src = InMemorySource(ported, device="cpu")
        wd = src.fetch(np.arange(4), pad_to=8)
        assert wd.bitmap_by_id and wd.bitmap.shape[0] == src.num_blocks
        for level in ("structural", "content", "auto"):
            validate_window(wd, **_kwargs(src), pad_to=8, level=level)

    def test_broken_by_id_window_rejected(self, dataset):
        _, _, ported = dataset
        src = InMemorySource(ported, device="cpu")
        wd = src.fetch(np.arange(4), pad_to=8)
        with pytest.raises(CorruptWindowError, match="bitmap table"):
            validate_window(wd._replace(bitmap=wd.bitmap[:-1]), **_kwargs(src),
                            level="structural")
        with pytest.raises(CorruptWindowError, match="truncated"):
            validate_window(wd._replace(z=wd.z[:-1], x=wd.x[:-1]), **_kwargs(src),
                            level="structural")
        with pytest.raises(CorruptWindowError, match="bitmap width"):
            validate_window(wd._replace(bitmap=wd.bitmap[:, :0]), **_kwargs(src),
                            level="structural")

    def test_numpy_leaf_rejected(self, sources):
        _, src = sources
        wd = src.fetch(np.arange(4))
        with pytest.raises(CorruptWindowError, match="tensor"):
            validate_window(wd._replace(z=wd.z.numpy()), **_kwargs(src))


# ---------------------------------------------------------- fault injection


class TestFaultInjector:
    @pytest.mark.parametrize("seed", [0, 7, 1234])
    def test_same_schedule_as_reference(self, seed):
        plan = dict(p_transient=0.3, p_stall=0.05, p_corrupt=0.2, p_truncate=0.1,
                    eof_at=3, crash_at=11)
        a = FaultInjector(FaultPlan(**plan), seed=seed)
        b = jfaults.FaultInjector(jfaults.FaultPlan(**plan), seed=seed)
        assert [a.next_fault() for _ in range(300)] == [b.next_fault() for _ in range(300)]
        assert a.injected == b.injected and a.attempts == b.attempts

    def test_one_shots_fire_exactly_once_and_keep_schedule(self):
        base = FaultInjector(FaultPlan(p_transient=0.3), seed=1)
        shot = FaultInjector(FaultPlan(p_transient=0.3, crash_at=5), seed=1)
        seq_base = [base.next_fault() for _ in range(20)]
        seq_shot = [shot.next_fault() for _ in range(20)]
        assert seq_shot[5] == "crash" and shot.injected["crash"] == 1
        assert seq_shot[:5] == seq_base[:5] and seq_shot[6:] == seq_base[6:]

    def test_probability_sum_validated(self):
        with pytest.raises(ValueError, match="probabilities"):
            FaultPlan(p_transient=0.8, p_corrupt=0.4)

    def test_faulty_source_raises_and_mutates(self, sources):
        _, src = sources
        win = np.arange(4)
        with pytest.raises(TransientIOError):
            FaultySource(src, FaultPlan(p_transient=1.0)).fetch(win)
        wd = FaultySource(src, FaultPlan(p_corrupt=1.0)).fetch(win)
        assert int(wd.z.max()) >= src.v_z
        wd = FaultySource(src, FaultPlan(p_truncate=1.0)).fetch(win)
        assert wd.indices.shape[0] == win.size - 1
        with pytest.raises(UnrecoverableIOError):
            FaultySource(src, FaultPlan(crash_at=0)).fetch(win)

    def test_fault_copy_of_by_id_window_is_its_rows(self, dataset):
        """A corrupted or truncated copy of a resident window carries the
        window's own rows, gathered, not the whole table."""
        _, _, ported = dataset
        src = InMemorySource(ported, device="cpu")
        clean = src.fetch(np.arange(6), pad_to=8)
        bad = FaultySource(src, FaultPlan(p_corrupt=1.0)).fetch(np.arange(6), pad_to=8)
        assert not bad.bitmap_by_id and bad.bitmap.shape[0] == 8
        assert torch.equal(bad.bitmap, clean.bitmap_rows())
        cut = FaultySource(src, FaultPlan(p_truncate=1.0)).fetch(np.arange(6), pad_to=8)
        assert not cut.bitmap_by_id and cut.bitmap.shape[0] == 7


# ------------------------------------------------------- resilient boundary


class TestResilientSource:
    def test_p0_stream_bit_identical(self, sources):
        jsrc, src = sources
        wins = _windows(src.num_blocks)
        wrapped = ResilientSource(FaultySource(src, FaultPlan()))
        got = list(wrapped.stream(wins, pad_to=8))
        assert len(got) == len(wins)
        for a, b, c in zip(got, src.stream(wins, pad_to=8), jsrc.stream(wins, pad_to=8)):
            _assert_windows_equal(a, b)
            _assert_windows_equal(a, c)
        assert wrapped.retries_total == 0 and wrapped.blocks_quarantined == 0

    def test_transient_heals_on_retry(self, sources):
        _, src = sources
        flaky = _FlakySource(src, [TransientIOError("x"), TransientIOError("x"), None])
        res = ResilientSource(flaky, policy=RetryPolicy(max_retries=4, backoff_s=0.0))
        _assert_windows_equal(res.fetch(np.arange(4)), src.fetch(np.arange(4)))
        assert res.retries_total == 2 and res.transient_faults == 2
        assert res.permanent_faults == 0 and res.take_quarantined().size == 0

    def test_retries_exhausted_quarantines(self, sources):
        _, src = sources
        flaky = _FlakySource(src, [TransientIOError("x")] * 10)
        res = ResilientSource(flaky, policy=RetryPolicy(max_retries=2, backoff_s=0.0))
        win = np.array([3, 5, 7])
        with pytest.raises(WindowQuarantined) as ei:
            res.fetch(win)
        np.testing.assert_array_equal(ei.value.block_ids, win)
        assert res.permanent_faults == 1 and res.blocks_quarantined == 3
        np.testing.assert_array_equal(res.take_quarantined(), win)
        assert res.take_quarantined().size == 0

    def test_corrupt_window_is_immediately_permanent(self, sources):
        _, src = sources
        res = ResilientSource(FaultySource(src, FaultPlan(p_corrupt=1.0)),
                              policy=RetryPolicy(max_retries=5, backoff_s=0.0))
        with pytest.raises(WindowQuarantined):
            res.fetch(np.arange(4))
        assert res.retries_total == 0 and res.validation_failures == 1

    def test_truncated_window_fails_validation(self, sources):
        _, src = sources
        res = ResilientSource(FaultySource(src, FaultPlan(p_truncate=1.0)))
        with pytest.raises(WindowQuarantined):
            res.fetch(np.arange(4), pad_to=4)
        assert res.validation_failures == 1

    def test_corrupt_resident_window_caught_by_auto(self, dataset):
        """A fault copy of a device-resident window lands on the host, so
        "auto" runs the content checks on it."""
        _, _, ported = dataset
        res = ResilientSource(FaultySource(InMemorySource(ported, device="cpu"),
                                           FaultPlan(p_corrupt=1.0)))
        with pytest.raises(WindowQuarantined, match="z values"):
            res.fetch(np.arange(4), pad_to=8)

    def test_unrecoverable_propagates_untouched(self, sources):
        _, src = sources
        res = ResilientSource(FaultySource(src, FaultPlan(crash_at=0)),
                              policy=RetryPolicy(max_retries=8, backoff_s=0.0))
        with pytest.raises(UnrecoverableIOError):
            res.fetch(np.arange(4))
        assert res.take_quarantined().size == 0 and res.permanent_faults == 0

    def test_deadline_escalates_with_retries_left(self, sources):
        _, src = sources
        clock = iter([0.0, 10.0, 20.0]).__next__
        flaky = _FlakySource(src, [TransientIOError("x")] * 10)
        res = ResilientSource(
            flaky, policy=RetryPolicy(max_retries=100, backoff_s=0.0, deadline_s=5.0), clock=clock
        )
        with pytest.raises(WindowQuarantined):
            res.fetch(np.arange(2))
        assert res.permanent_faults == 1 and flaky.calls == 1

    @pytest.mark.parametrize("seed", [3, 4])
    def test_backoff_schedule_equals_reference(self, sources, seed):
        jsrc, src = sources

        def run(pkg, inner):
            sleeps = []
            flaky = _FlakySource(inner, [pkg.TransientIOError("x")] * 3 + [None])
            res = pkg.ResilientSource(
                flaky, policy=pkg.RetryPolicy(max_retries=5, backoff_s=0.01, seed=seed),
                sleep=sleeps.append,
            )
            res.fetch(np.arange(2))
            return sleeps

        got, want = run(tfaults, src), run(jfaults, jsrc)
        assert got == want and len(got) == 3 and got[1] > got[0] and got[2] > got[1]

    def test_stream_skips_quarantined_window(self, sources):
        _, src = sources
        wins = _windows(src.num_blocks, width=4, count=4)
        script = [None] + [TransientIOError("x")] * 3 + [None, None]
        res = ResilientSource(_FlakySource(src, script),
                              policy=RetryPolicy(max_retries=2, backoff_s=0.0))
        assert len(list(res.stream(wins, pad_to=4))) == len(wins) - 1
        np.testing.assert_array_equal(res.take_quarantined(), wins[1])

    def test_cancel_event_stops_retry_loop(self, sources):
        _, src = sources
        ev = threading.Event()
        ev.set()
        res = ResilientSource(_FlakySource(src, []))
        res.set_cancel_event(ev)
        with pytest.raises(FetchCancelled):
            res.fetch(np.arange(2))
        assert res.take_quarantined().size == 0

    def test_nested_quarantine_drains_through_outer(self, sources):
        _, src = sources
        inner = ResilientSource(_FlakySource(src, [TransientIOError("x")] * 4),
                                policy=RetryPolicy(max_retries=1, backoff_s=0.0))
        outer = ResilientSource(inner)
        with pytest.raises(WindowQuarantined):
            outer.fetch(np.array([9, 2]))
        np.testing.assert_array_equal(outer.take_quarantined(), [2, 9])

    def test_find_resilient_walks_wrapper_chain(self, sources):
        _, src = sources
        res = ResilientSource(FaultySource(src, FaultPlan()))
        assert find_resilient(PrefetchSource(res)) is res
        assert find_resilient(src) is None

    def test_maybe_chaos_env_gate(self, sources):
        _, src = sources
        assert maybe_chaos(src, env={}) is src
        wrapped = maybe_chaos(src, env={"FASTMATCH_CHAOS": "1"})
        assert isinstance(wrapped, ResilientSource) and isinstance(wrapped.inner, FaultySource)
        assert wrapped.policy == RetryPolicy(max_retries=16, backoff_s=0.001, seed=0)

    @pytest.mark.parametrize("p_transient", [0.0, 0.6])
    def test_config_hash_probes_through_the_wrapper(self, dataset, p_transient):
        """The snapshot hash fetches its probe through the wrappers, as
        the reference's does: the same hash, the same injector attempts."""
        from repro.core import multiquery as jmq

        _, blocked, ported = dataset
        hashes, attempts = [], []
        for mq, pkg, inner in ((tmq, tfaults, InMemorySource(ported, device="cpu")),
                               (jmq, jfaults, JSource(blocked))):
            src = pkg.ResilientSource(
                pkg.FaultySource(inner, pkg.FaultPlan(p_transient=p_transient), seed=4),
                policy=pkg.RetryPolicy(max_retries=16, backoff_s=0.0))
            spec = mq.MultiQuerySpec(v_z=32, v_x=16, max_queries=2)
            hashes.append(mq.cache_config_hash(src, spec))
            attempts.append(src.inner.injector.attempts)
        assert hashes[0] == hashes[1] and attempts[0] == attempts[1] >= 1

    def test_telemetry_counters(self, sources):
        """Two transient faults with one retry allowed: the same counters,
        Prometheus text and quarantine event as the reference's."""
        out = {}
        for pkg, inner, mod, tel in (("port", sources[1], tfaults, Telemetry(device="cpu")),
                                     ("ref", sources[0], jfaults, JTelemetry())):
            flaky = _FlakySource(inner, [mod.TransientIOError("x")] * 10)
            src = mod.ResilientSource(flaky, policy=mod.RetryPolicy(max_retries=1, backoff_s=0.0),
                                      telemetry=tel)
            with pytest.raises(mod.WindowQuarantined):
                src.fetch(np.array([1, 2]))
            reg = tel.registry
            assert reg.get("io_fetch_retries_total").value == 1
            assert reg.get("io_transient_faults_total").value == 2
            assert reg.get("io_permanent_faults_total").value == 1
            assert reg.get("io_blocks_quarantined_total").value == 2
            (ev,) = tel.tracer.events("window_quarantine")
            assert ev["blocks"] == 2 and ev["why"] == "retries-exhausted"
            out[pkg] = reg.to_prometheus(), tel.tracer.skeleton()
        assert out["port"] == out["ref"]

    def test_telemetry_refused(self, sources):
        """Both wrappers take a `Telemetry` and record into it: a corrupt
        window's validation failure, and a prefetched stream."""
        _, src = sources
        tel = Telemetry(device="cpu")
        corrupt = FaultySource(src, FaultPlan(p_corrupt=1.0), seed=0)
        res = ResilientSource(corrupt, telemetry=tel)
        with pytest.raises(WindowQuarantined):
            res.fetch(np.arange(4), pad_to=4)
        assert tel.registry.get("io_validation_failures_total").value == 1
        assert tel.registry.get("io_permanent_faults_total").value == 1
        assert [e["why"] for e in tel.tracer.events("window_quarantine")] == ["validation"]
        wins = _windows(src.num_blocks, width=4, count=3)
        got = list(PrefetchSource(src, telemetry=tel).stream(wins, pad_to=4))
        assert len(got) == 3
        (ev,) = tel.tracer.events("prefetch_stream")
        assert ev["windows"] == 4 and ev["source"] == "InMemorySource"
        assert tel.registry.get("prefetch_fetch_seconds").count == 3


# ------------------------------------------------ prefetch


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "block-prefetch" and t.is_alive()]


class _HangingSource(_FlakySource):
    """The first window serves; every later fetch is transient forever."""

    def __init__(self, inner):
        super().__init__(inner, [])

    def fetch(self, win, pad_to=None):
        self.calls += 1
        if self.calls > 1:
            raise TransientIOError("flaky forever")
        return self.inner.fetch(win, pad_to)


class TestPrefetch:
    def test_close_cancels_inflight_retry(self, sources):
        """Closing the stream stops a worker stuck in a 30 s backoff at its
        next cancellation check, not after the join timeout."""
        _, src = sources
        res = ResilientSource(_HangingSource(src),
                              policy=RetryPolicy(max_retries=100, backoff_s=30.0))
        tel = Telemetry(device="cpu")
        pf = PrefetchSource(res, telemetry=tel, join_timeout=5.0)
        it = pf.stream(_windows(src.num_blocks, width=4, count=4), pad_to=4)
        next(it)
        t0 = time.perf_counter()
        it.close()
        assert time.perf_counter() - t0 < 5.0
        # a clean shutdown: no error, no abandoned worker, no quarantine
        assert tel.registry.get("prefetch_worker_errors_total").value == 0
        assert tel.registry.get("prefetch_join_timeouts_total").value == 0
        assert res.take_quarantined().size == 0 and res.cancel_event is None
        assert not _prefetch_threads()

    def test_post_close_failure_is_logged(self, sources, caplog):
        _, src = sources

        class _LateFailSource(_HangingSource):
            def fetch(self, win, pad_to=None):
                self.calls += 1
                if self.calls > 1:
                    time.sleep(0.1)  # lets the consumer close first
                    raise RuntimeError("disk on fire")
                return self.inner.fetch(win, pad_to)

        tel = Telemetry(device="cpu")
        pf = PrefetchSource(_LateFailSource(src), telemetry=tel)
        it = pf.stream(_windows(src.num_blocks, width=4, count=4), pad_to=4)
        next(it)
        with caplog.at_level(logging.WARNING, logger="repro_torch.io.prefetch"):
            it.close()
        assert "disk on fire" in caplog.text and "after the stream was closed" in caplog.text
        assert tel.registry.get("prefetch_dropped_errors_total").value == 1
        (ev,) = tel.tracer.events("prefetch_dropped_error")
        assert ev["source"] == "_LateFailSource" and "disk on fire" in ev["error"]
        assert not _prefetch_threads()

    def test_worker_error_raised_at_next_pull(self, sources):
        _, src = sources
        flaky = _FlakySource(src, [None, RuntimeError("bad disk")])
        it = PrefetchSource(flaky).stream(_windows(src.num_blocks, width=4, count=4), pad_to=4)
        next(it)
        with pytest.raises(RuntimeError, match="bad disk"):
            next(it)
        assert not _prefetch_threads()

    def test_stream_bitwise_inner(self, sources, dataset):
        _, src = sources
        wins = _windows(src.num_blocks, width=8, count=6)
        for inner in (src, InMemorySource(dataset[2], device="cpu")):
            got = list(PrefetchSource(inner).stream(wins, pad_to=8))
            want = list(inner.stream(wins, pad_to=8))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _assert_windows_equal(a, b)
        assert not _prefetch_threads()

    @pytest.mark.parametrize("resident", [True, False], ids=["resident", "host"])
    @pytest.mark.parametrize("variant", ["fastmatch", "scan"])
    def test_engine_prefetch_bitwise(self, dataset, resident, variant):
        ds, _, ported = dataset
        src = InMemorySource(ported, device_resident=resident, device="cpu")
        params = thistsim.HistSimParams(v_z=32, v_x=16, k=K, eps=EPS, delta=DELTA)
        runs = [tengine.run_engine(
            src, ds.target, params,
            tengine.EngineConfig(variant=variant, seed=3, lookahead=16, prefetch=prefetch))
            for prefetch in (False, True)]
        a, b = runs
        np.testing.assert_array_equal(a.ids, b.ids)
        assert (a.rounds, a.blocks_read, a.tuples_read, a.exact, a.host_syncs) == (
            b.rounds, b.blocks_read, b.tuples_read, b.exact, b.host_syncs)
        assert torch.equal(a.state.counts, b.state.counts) and torch.equal(a.state.tau, b.state.tau)
        assert not b.degraded and b.eps_effective == EPS
        assert not _prefetch_threads()


# ----------------------------------------- end to end: degraded guarantees


def _serve(Server, source, targets, **kw):
    srv = Server(source, max_queries=2, lookahead=64, poll_every=2, seed=11, **kw)
    rids = [srv.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
    res = srv.run_until_idle()
    return srv, [res[r] for r in rids]


def _assert_same_result(got, want):
    for f in ("ids", "rounds", "passes", "blocks_read", "blocks_considered", "tuples_read",
              "exact", "degraded", "eps_effective"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))
    np.testing.assert_allclose(got.state.tau.numpy(), np.asarray(want.state.tau), atol=TAU_ATOL)
    np.testing.assert_allclose(got.delta_upper, want.delta_upper, rtol=1e-5, atol=1e-12)


class TestServeUnderFaults:
    def test_transient_faults_bit_identical(self, dataset, sources, targets):
        _, _, ported = dataset
        _, src = sources
        _, clean = _serve(MatchServer, ported, targets, device="cpu")
        chaotic = ResilientSource(FaultySource(src, FaultPlan(p_transient=0.4), seed=2),
                                  policy=RetryPolicy(max_retries=32, backoff_s=0.0))
        srv, got = _serve(MatchServer, chaotic, targets, device="cpu")
        assert chaotic.retries_total > 0
        for a, b in zip(got, clean):
            np.testing.assert_array_equal(a.ids, b.ids)
            assert (a.rounds, a.blocks_read, a.tuples_read, a.exact) == (
                b.rounds, b.blocks_read, b.tuples_read, b.exact)
            assert torch.equal(a.state.counts, b.state.counts)
            assert not a.degraded and a.eps_effective == EPS
        m = srv.metrics
        assert m["blocks_quarantined"] == 0 and m["degraded"] is False

    @pytest.mark.parametrize(
        "plan,policy",
        [(dict(p_transient=0.2, p_corrupt=0.3), dict(max_retries=1, backoff_s=0.0)),
         (dict(p_corrupt=0.1, p_truncate=0.1), dict(backoff_s=0.0)),
         (dict(p_transient=0.5, eof_at=4), dict(max_retries=1, backoff_s=0.0))],
        ids=["corrupt", "truncate", "retries-exhausted"],
    )
    def test_same_quarantine_as_reference(self, sources, targets, plan, policy):
        """The same plan and seed: the same faults injected, attempt by
        attempt, the same block ids quarantined, the same answers with
        the same eps_effective."""
        jsrc, src = sources
        jres = jfaults.ResilientSource(
            jfaults.FaultySource(jsrc, jfaults.FaultPlan(**plan), seed=2),
            policy=jfaults.RetryPolicy(**policy))
        res = ResilientSource(FaultySource(src, FaultPlan(**plan), seed=2),
                              policy=RetryPolicy(**policy))
        jsrv, want = _serve(JServer, jres, targets)
        srv, got = _serve(MatchServer, res, targets, device="cpu")
        assert res.inner.injector.injected == jres.inner.injector.injected
        assert res.inner.injector.attempts == jres.inner.injector.attempts
        assert srv.scheduler.blocks_quarantined > 0
        np.testing.assert_array_equal(srv.scheduler.quarantined, jsrv.scheduler.quarantined)
        assert srv.scheduler.tuples_quarantined == jsrv.scheduler.tuples_quarantined
        for a, b in zip(got, want):
            _assert_same_result(a, b)
        assert srv.metrics == pytest.approx(jsrv.metrics)
        assert srv.metrics["degraded"] is True

    def test_corruption_degrades_honestly(self, sources, targets):
        _, src = sources
        chaotic = ResilientSource(
            FaultySource(src, FaultPlan(p_transient=0.2, p_corrupt=0.3), seed=2),
            policy=RetryPolicy(max_retries=1, backoff_s=0.0))
        srv, res = _serve(MatchServer, chaotic, targets, device="cpu")
        sched = srv.scheduler
        m = srv.metrics
        assert m["degraded"] is True and m["blocks_quarantined"] == sched.blocks_quarantined
        assert m["eps_inflation"] == pytest.approx(2.0 * sched.quarantine_fraction)
        degraded = [r for r in res if r.degraded]
        assert degraded
        for r in degraded:
            assert EPS < r.eps_effective <= EPS + sched.eps_inflation + 1e-9
        for r in res:
            assert len(r.ids) == K

    def test_quarantine_blocks_scheduler_semantics(self, sources, targets):
        """Read blocks are never quarantined, the widening is twice the
        quarantined tuple share, and exact means complete over the
        survivors: the same in both packages."""
        from repro.core import multiquery as jmq

        jsrc, src = sources
        outs = []
        for mq, source, kw in ((jmq, jsrc, {}), (tmq, src, dict(device="cpu"))):
            spec = mq.MultiQuerySpec(v_z=src.v_z, v_x=src.v_x, max_queries=2, k_cap=K)
            sched = mq.SharedCountsScheduler(source, spec, policy="scan", window=8, seed=0,
                                             start_block=0, **kw)
            sched.admit(targets[0], k=K, eps=EPS, delta=DELTA)
            sched.run_window(np.arange(8))
            read = np.where(sched.read_mask)[0]
            assert read.size and sched.quarantine_blocks(read[:2]) == 0
            fresh = np.where(~sched.read_mask)[0][:10]
            assert sched.quarantine_blocks(fresh) == 10 and sched.quarantine_blocks(fresh) == 0
            tpb = np.asarray(src.tuples_per_block, np.int64)
            q = tpb[fresh].sum() / tpb.sum()
            assert sched.eps_inflation == pytest.approx(2.0 * q)
            sched.complete_remaining()
            out = sched.retire(0, exact=False, terminated=False)
            assert out.degraded and out.exact and out.blocks_quarantined == 10
            assert out.eps_effective == pytest.approx(EPS + 2.0 * q)
            assert not sched.read_mask[fresh].any()
            outs.append((out, sched))
        (want, jsched), (got, sched) = outs
        assert got.eps_effective == want.eps_effective
        np.testing.assert_array_equal(sched.read_mask, jsched.read_mask)
        np.testing.assert_array_equal(got.state.counts.numpy(), np.asarray(want.state.counts))

    def test_fault_free_outcome_fields_equal_reference(self, dataset, targets):
        _, blocked, ported = dataset
        _, want = _serve(JServer, blocked, targets)
        _, got = _serve(MatchServer, ported, targets, device="cpu")
        for a, b in zip(got, want):
            _assert_same_result(a, b)
            assert not a.degraded and a.eps_effective == EPS


class TestChaos:
    def test_chaos_run_is_the_fault_free_run(self, dataset, targets):
        """maybe_chaos heals every fault: bitwise the fault-free port run,
        and the reference's run under the same chaos seed within the
        tolerance contract, with the same faults injected."""
        _, blocked, ported = dataset
        _, clean = _serve(MatchServer, ported, targets, device="cpu")
        chaos = maybe_chaos(InMemorySource(ported, device="cpu"), env=CHAOS_ENV)
        srv, got = _serve(MatchServer, chaos, targets, device="cpu")
        jchaos = jfaults.maybe_chaos(JSource(blocked), env=CHAOS_ENV)
        _, want = _serve(JServer, jchaos, targets)
        assert chaos.retries_total > 0 and chaos.retries_total == jchaos.retries_total
        assert chaos.inner.injector.injected == jchaos.inner.injector.injected
        for a, b, c in zip(got, clean, want):
            np.testing.assert_array_equal(a.ids, b.ids)
            assert (a.rounds, a.tuples_read, a.exact) == (b.rounds, b.tuples_read, b.exact)
            assert torch.equal(a.state.counts, b.state.counts)
            assert torch.equal(a.state.tau, b.state.tau)
            _assert_same_result(a, c)
        assert srv.metrics["degraded"] is False

    def test_server_wraps_its_source_under_the_variable(self, dataset, monkeypatch):
        _, _, ported = dataset
        monkeypatch.setenv("FASTMATCH_CHAOS", "1")
        srv = MatchServer(ported, device="cpu")
        assert isinstance(srv.scheduler.source, ResilientSource)
        monkeypatch.setenv("FASTMATCH_CHAOS", "0")
        assert isinstance(MatchServer(ported, device="cpu").scheduler.source, InMemorySource)
