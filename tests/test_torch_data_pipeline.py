"""The port's token corpus, FastMatch domain selection and token stream
against the JAX reference.

The corpus and the stream are numpy in both packages, so their arrays
and batches must be bitwise equal. `select_domains` runs the port's
engine on the CPU through its plain kernel versions: ids, rounds, the
read counters and the counts must be equal, tau within 2e-5, and
delta_upper within the repo's end-to-end bound: rtol 1e-5, or where n
is large enough that tau's last-ulp differences move it further, the
Theorem-1 derivative bound of tests/test_torch_rounds.py on
log(delta_upper), with tau's difference D measured.
"""

import numpy as np
import pytest

from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro_torch.data import corpus as tcorpus
from repro_torch.data import pipeline as tpipe

TAU_ATOL = 2e-5

# tests/test_data_pipeline.py's corpus and tests/test_train_serve.py's
SPECS = {
    "pipeline": dict(num_domains=32, num_buckets=64, num_blocks=3000, block_tokens=1024,
                     n_reference=6, close_distance=0.03, far_distance=0.4, seed=5),
    "train_serve": dict(num_domains=16, num_buckets=32, vocab_size=256, num_blocks=256,
                        block_tokens=512, n_reference=4, reference_alpha=0.08, seed=1),
}
CORPUS_FIELDS = ("tokens", "domains", "reference", "domain_bucket_dists", "close_ids")


@pytest.fixture(scope="module")
def corpora():
    return {
        name: (jcorpus.make_corpus(jcorpus.CorpusSpec(**kw)),
               tcorpus.make_corpus(tcorpus.CorpusSpec(**kw)))
        for name, kw in SPECS.items()
    }


@pytest.fixture(scope="module")
def selected(corpora):
    want, _ = corpora["pipeline"]
    return jpipe.select_domains(want, k=6, eps=0.1, seed=0).selected_domains


@pytest.mark.parametrize("name", sorted(SPECS))
def test_corpus_bitwise(corpora, name):
    want, got = corpora[name]
    for f in CORPUS_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(got.true_dists, want.true_dists)


def test_blocked_view_bitwise(corpora):
    want, got = corpora["pipeline"]
    a, b = jpipe.corpus_as_blocked(want), tpipe.corpus_as_blocked(got)
    for f in ("z_blocks", "x_blocks", "bitmap"):
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert (a.v_z, a.v_x) == (b.v_z, b.v_x)


SELECT_CASES = [
    dict(k=6, eps=0.1, delta=0.05, seed=0),
    dict(k=6, eps=0.15, delta=0.05, seed=1),
    dict(k=6, seed=2),
    dict(k=4, eps=0.1, delta=0.05, seed=3, lookahead=64, poll_every=4),
    dict(k=6, eps=0.1, delta=0.05, seed=0, prefetch=True),
]


@pytest.mark.parametrize("kw", SELECT_CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_select_domains_matches_reference(corpora, name, kw):
    want_c, got_c = corpora[name]
    want = jpipe.select_domains(want_c, **kw)
    got = tpipe.select_domains(got_c, device="cpu", **kw)
    np.testing.assert_array_equal(got.selected_domains, want.selected_domains)
    assert got.blocks_scanned_frac == want.blocks_scanned_frac
    for f in ("rounds", "blocks_read", "blocks_considered", "tuples_read", "passes", "exact"):
        assert getattr(got.result, f) == getattr(want.result, f), f
    st, sw = got.result.state, want.result.state
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sw.counts))
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(sw.n))
    np.testing.assert_allclose(st.tau.numpy(), np.asarray(sw.tau), atol=TAU_ATOL)
    _assert_delta_upper_close(got.result, want.result)


def _assert_delta_upper_close(got, want):
    """rtol 1e-5, else |Δ log delta_upper| <= max_i n_i (eps_i + 2D) 2D
    + 1e-6 (the derivation is tests/test_torch_rounds.py's)."""
    g, w = float(got.delta_upper), float(want.delta_upper)
    if abs(g - w) <= 1e-12 + 1e-5 * abs(w):
        return
    d = float(np.abs(got.state.tau.numpy().astype(np.float64)
                     - np.asarray(want.state.tau, np.float64)).max())
    n = np.asarray(want.state.n, np.float64)
    eps_i = np.asarray(want.state.eps_i, np.float64)
    bound = float(np.max(n * (eps_i + 2 * d) * 2 * d)) + 1e-6
    assert abs(np.log(g) - np.log(w)) <= bound, (g, w, d, bound)


def test_select_domains_finds_planted(corpora):
    _, got_c = corpora["train_serve"]
    rep = tpipe.select_domains(got_c, k=4, device="cpu")
    assert set(rep.selected_domains.tolist()) == set(got_c.close_ids.tolist())


def _streams(corpora, selected, **kw):
    want_c, got_c = corpora["pipeline"]
    return (jpipe.TokenStream(want_c, selected, **kw),
            tpipe.TokenStream(got_c, selected, **kw))


def _same_batches(a, b, count: int):
    for _ in range(count):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(y, x)
    assert vars(a.state) == vars(b.state)


STREAM_CASES = [
    dict(batch_size=4, seq_len=512),
    dict(batch_size=2, seq_len=256, seed=3),
    dict(batch_size=1, seq_len=1024, worker=0, num_workers=16, seed=0),
]


@pytest.mark.parametrize("kw", STREAM_CASES, ids=("plain", "seeded", "stealing"))
def test_stream_batches_bitwise(corpora, selected, kw):
    a, b = _streams(corpora, selected, **kw)
    np.testing.assert_array_equal(b.owned, a.owned)
    np.testing.assert_array_equal(b.others, a.others)
    # past the worker's own blocks: steals, then a new epoch
    count = 8 if kw.get("num_workers", 1) == 1 else a.owned.size + a.others.size // 16 + 4
    _same_batches(a, b, count)
    if kw.get("num_workers", 1) > 1:
        assert b.state.epoch > 0


def test_stream_cursor_resume_bitwise(corpora, selected):
    """The port resumed from its saved cursor gives the reference's next
    batches."""
    kw = dict(batch_size=2, seq_len=256, seed=3)
    a, b = _streams(corpora, selected, **kw)
    _same_batches(a, b, 3)
    saved = tpipe.StreamState(**vars(b.state))
    want = [next(a)["tokens"] for _ in range(2)]
    resumed = tpipe.TokenStream(corpora["pipeline"][1], selected, state=saved, **kw)
    for w in want:
        np.testing.assert_array_equal(next(resumed)["tokens"], w)
    assert vars(resumed.state) == vars(a.state)


@pytest.mark.parametrize("worker", range(4))
def test_stream_four_worker_partition(corpora, selected, worker):
    kw = dict(batch_size=2, seq_len=128, worker=worker, num_workers=4, seed=1)
    a, b = _streams(corpora, selected, **kw)
    np.testing.assert_array_equal(b.owned, a.owned)
    np.testing.assert_array_equal(b._steal_order, a._steal_order)
    _same_batches(a, b, 5)
    others = [_streams(corpora, selected, **dict(kw, worker=w))[1].owned
              for w in range(4) if w != worker]
    assert not set(b.owned.tolist()) & set(np.concatenate(others).tolist())
