"""The port's training side (`repro_torch.train`, `repro_torch.launch.train`,
`convert.train_state_from_numpy`, bf16 snapshots) against the JAX
reference.

Every twin starts both packages from the reference's own parameters and
optimizer state, carried over with `convert` (bf16 bit for bit). The
reference's steps run jitted, as its launcher runs them. Bars, each with
its reason at its test:

* The loss and the grads differ only by the forward's f32 products and
  the backward's reductions (another order than XLA's; in bf16 also the
  embedding gradient, which accumulates repeated tokens in another order
  and rounds to bf16).
* Adam's first step normalises every grad element, g / (|g| + eps), so a
  parameter whose grad is near eps moves by up to the learning rate on a
  grad difference of ~eps: the post-step parameters are held to a
  fraction of the learning rate, not to the grads' bar.
* `remat` none / full / dots: equal grads, bit for bit (recomputation
  reruns the same operations on the same inputs).
* A skipped (NaN) step leaves every parameter and moment bitwise as it
  was.
"""

import dataclasses
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.data.corpus import CorpusSpec as JCorpusSpec
from repro.data.corpus import make_corpus as jmake_corpus
from repro.launch.train import train_loop as jtrain_loop
from repro.models.model_zoo import get_model as jget_model
from repro.optimizer import get_optimizer as jget_optimizer
from repro.train import TrainState as JTrainState
from repro.train import make_eval_step as jmake_eval_step
from repro.train import make_train_step as jmake_train_step
from repro.train.step import cross_entropy_loss as jcross_entropy_loss
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, config_hash
from repro_torch.configs import base as tbase
from repro_torch.data.corpus import CorpusSpec, make_corpus
from repro_torch.launch import train as tlaunch
from repro_torch.models import model_zoo
from repro_torch.optimizer import get_optimizer
from repro_torch.optimizer.base import tree_leaves
from repro_torch.train import TrainState, cross_entropy_loss, make_eval_step, make_train_step
from repro_torch.train.step import make_loss_fn

ARCHS = ("qwen2_5_3b", "granite_8b")
LR = 1e-3
# (loss and ce atol, grads: fraction of each leaf's largest |g|,
#  grad_norm rtol, param_norm rtol)
BARS = {"float32": (1e-5, 1e-5, 1e-5, 1e-6), "bfloat16": (0.01, 0.05, 0.02, 1e-3)}
CORPUS_KW = dict(num_domains=16, num_buckets=32, vocab_size=256, num_blocks=256, block_tokens=512,
                 n_reference=4, reference_alpha=0.08, seed=1)


@pytest.fixture(scope="module")
def tiny_corpus():
    # tests/test_train_serve.py's: a very peaked token mix, a strong
    # learnable unigram signal for the loss-decrease check
    return make_corpus(CorpusSpec(**CORPUS_KW))


def _cfgs(arch: str, dtype: str, **kw):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().copy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _pair(arch: str, dtype: str, seed: int = 0, **kw):
    """The reference's model, its train state, and the port's model and
    state holding the same parameters and moments."""
    jc, tc = _cfgs(arch, dtype, **kw)
    jm = jget_model(jc)
    jstate = JTrainState.create(jm.init(jax.random.PRNGKey(seed)),
                                jget_optimizer(jc.optimizer, LR))
    model, state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.opt_state),
        jstate.step, tc, device="cpu")
    return jm, jstate, model, state


def _tokens(vocab: int, shape=(2, 16), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _ref_loss_and_grads(jm, params, toks):
    """The reference's train-step loss (tests/test_train_serve.py's batch:
    no loss mask) and its grads, jitted."""
    def loss_fn(p):
        logits, _ = jm.forward(p, jnp.asarray(toks))
        targets = jnp.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        mask = jnp.ones(toks.shape, jnp.float32).at[:, -1].set(0.0)
        return jcross_entropy_loss(logits, targets, mask, 1e-4)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _port_grads(model, state, toks):
    loss, _, _ = make_loss_fn(model)({"tokens": torch.from_numpy(toks)})
    loss.backward()
    grads = [p.grad.detach().clone() for p in tree_leaves(state.params)]
    for p in tree_leaves(state.params):
        p.grad = None
    return loss.detach(), grads


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked):
    """logsumexp and the masked means reduce in another order than XLA's:
    within 1e-6 relative."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                               None if mask is None else jnp.asarray(mask), 1e-3)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                             None if mask is None else torch.from_numpy(mask), 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype):
    """The loss, every grad, the post-step parameters and every metric.

    Bars (`BARS`): f32 loss within 1e-5 and each grad within 1e-5 of its
    leaf's largest |g| (the products and reductions round in another
    order; measured 1.8e-6); bf16 loss within 0.01 (the LM twins' bf16
    logits bar is 0.06) and each grad within 5 % of its leaf's largest
    |g| (bf16 grads, the embedding's accumulated in another order;
    measured 2.1 %). Post-step parameters: within 5 % of the learning
    rate in f32 (Adam's first step; measured 1.2 %); in bf16 within one
    bf16 ulp of the leaf's largest |p| plus twice the learning rate (a
    bf16 grad near zero can round to the other sign, and Adam's first
    step then moves that parameter by -lr where the other moves it by
    +lr; measured 2.01e-3 at lr 1e-3)."""
    jm, jstate, model, state = _pair(arch, dtype)
    toks = _tokens(jm.cfg.vocab_size)
    loss_atol, grad_frac, gnorm_rtol, pnorm_rtol = BARS[dtype]

    jloss, jgrads = _ref_loss_and_grads(jm, jstate.params, toks)
    tloss, tgrads = _port_grads(model, state, toks)
    assert abs(float(tloss) - float(jloss)) <= loss_atol
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for g, w in zip(tgrads, jleaves):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= grad_frac * np.abs(w).max()

    jnew, jm_metrics = jax.jit(jmake_train_step(jm, jget_optimizer(jm.cfg.optimizer, LR)))(
        jstate, {"tokens": jnp.asarray(toks)})
    step = make_train_step(model, get_optimizer(model.cfg.optimizer, LR))
    tnew, t_metrics = step(state, {"tokens": torch.from_numpy(toks)})
    assert int(tnew.step) == int(jnew.step) == 1 and tnew.step.dtype == torch.int64
    assert set(t_metrics) == set(jm_metrics)
    for k in ("loss", "ce"):
        assert abs(float(t_metrics[k]) - float(jm_metrics[k])) <= loss_atol, k
    assert float(t_metrics["step_ok"]) == float(jm_metrics["step_ok"]) == 1.0
    np.testing.assert_allclose(float(t_metrics["grad_norm"]), float(jm_metrics["grad_norm"]),
                               rtol=gnorm_rtol)
    np.testing.assert_allclose(float(t_metrics["param_norm"]), float(jm_metrics["param_norm"]),
                               rtol=pnorm_rtol)
    for g, w in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params)):
        w = _np(w)
        bar = 0.05 * LR if dtype == "float32" else 2.0 ** -8 * np.abs(w).max() + 2 * LR
        assert np.abs(_np(g) - w).max() <= bar
    # the state holds the model's own parameters, updated in place
    assert {id(p) for p in tree_leaves(tnew.params)} == {id(p) for p in model.parameters()}


@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_equal_grads(remat, dtype):
    """qwen2.5-3b smoke with remat full / dots against none, the same
    weights: the loss and every grad bit for bit."""
    jm, jstate, model, state = _pair("qwen2_5_3b", dtype, seed=2)
    toks = _tokens(jm.cfg.vocab_size, seed=2)
    base_loss, base = _port_grads(model, state, toks)
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    loss, grads = _port_grads(model, state, toks)
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base):
        assert torch.equal(a, b)


class _OpCounter(TorchDispatchMode):
    """Counts the aten operations that run (an operation whose output a
    selective checkpoint cached is served above this mode and not run)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_what_it_says():
    """What the backward pass runs: "full" recomputes each block's
    forward, weight products included; "dots" keeps the weight products
    (`aten.mm`) and recomputes the rest, so its backward runs no more
    products than without remat, but more other operations."""
    _, _, model, state = _pair("qwen2_5_3b", "float32")
    toks = torch.from_numpy(_tokens(256, (2, 32)))
    mm, ops = {}, {}
    for remat in ("none", "dots", "full"):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        loss = make_loss_fn(model)({"tokens": toks})[0]
        with _OpCounter() as counter:
            loss.backward()
        mm[remat] = counter.counts.get(torch.ops.aten.mm.default, 0)
        ops[remat] = sum(counter.counts.values())
        for p in tree_leaves(state.params):
            p.grad = None
    assert mm["none"] == mm["dots"] < mm["full"], mm
    assert ops["none"] < ops["dots"] < ops["full"], ops
    model.cfg = dataclasses.replace(model.cfg, remat="some")
    with pytest.raises(ValueError, match="unknown remat"):
        make_loss_fn(model)({"tokens": toks})


def test_nan_batch_skipped():
    """tests/test_train_serve.py::TestTrainLoop::test_nan_batch_skipped on
    the port, held harder: a poisoned embedding row makes the step report
    step_ok == 0, every parameter and moment stays bitwise as it was, and
    the step still increments (the reference's metrics agree)."""
    jm, jstate, model, state = _pair("granite_8b", "bfloat16")
    step = make_train_step(model, get_optimizer("adamw", 1e-3))
    toks = _tokens(jm.cfg.vocab_size, seed=1)
    toks[0, 0] = 0  # the poisoned row is hit
    # a first good step, so the moments are not zero
    state, _ = step(state, {"tokens": torch.from_numpy(_tokens(jm.cfg.vocab_size, seed=5))})
    with torch.no_grad():
        model.embed["table"][0, 0] = float("nan")
    before = [_bits(x) for x in tree_leaves((state.params, state.opt_state))]
    new, metrics = step(state, {"tokens": torch.from_numpy(toks)})
    assert float(metrics["step_ok"]) == 0.0
    assert not np.isfinite(float(metrics["loss"]))
    assert int(new.step) == int(state.step) + 1
    after = [_bits(x) for x in tree_leaves((new.params, new.opt_state))]
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    # the reference, poisoned the same way, skips as well
    bad = jax.tree.map(lambda x: x, jstate.params)
    bad["embed"]["table"] = bad["embed"]["table"].at[0, 0].set(jnp.nan)
    _, jmet = jax.jit(jmake_train_step(jm, jget_optimizer("adamw", 1e-3)))(
        JTrainState(bad, jstate.opt_state, jstate.step), {"tokens": jnp.asarray(toks)})
    assert float(jmet["step_ok"]) == 0.0


def test_eval_step_matches_reference():
    """ce and ppl of the same weights and batch, f32: within 1e-5."""
    jm, jstate, model, _ = _pair("qwen2_5_3b", "float32", seed=3)
    toks = _tokens(jm.cfg.vocab_size, seed=3)
    want = jax.jit(jmake_eval_step(jm))(jstate.params, {"tokens": jnp.asarray(toks)})
    got = make_eval_step(model)({"tokens": torch.from_numpy(toks)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def _quiet(*_):
    pass


def test_train_loop_matches_reference(monkeypatch):
    """`train_loop` in both packages on tests/test_train_serve.py's corpus,
    f32 qwen2.5-3b smoke, the port's model holding the reference's initial
    parameters (`get_model` patched here): the same selected domains,
    rounds and blocks, and the same loss history within 1e-4 (the step
    twin's f32 bar, grown over six steps)."""
    jc, tc = _cfgs("qwen2_5_3b", "float32")
    init = jget_model(jc).init(jax.random.PRNGKey(4))
    kw = dict(steps=6, batch_size=4, seq_len=32, lr=3e-3, select_k=4, seed=4, log_every=1,
              log_fn=_quiet)
    want = jtrain_loop(cfg=jc, corpus=jmake_corpus(JCorpusSpec(**CORPUS_KW)), **kw)

    def reference_weights(cfg, *, device=None, generator=None):
        return convert.lm_params_from_numpy(jax.tree.map(np.asarray, init), cfg, device=device)

    monkeypatch.setattr(tlaunch, "get_model", reference_weights)
    got = tlaunch.train_loop(cfg=tc, corpus=make_corpus(CorpusSpec(**CORPUS_KW)),
                             device="cpu", **kw)
    ws, gs = want["selection"], got["selection"]
    np.testing.assert_array_equal(np.sort(gs.selected_domains), np.sort(ws.selected_domains))
    assert (gs.result.rounds, gs.result.blocks_read) == (ws.result.rounds, ws.result.blocks_read)
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "ce"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g, w)
        assert g["step_ok"] == w["step_ok"] == 1.0
    assert got["final_loss"] == got["history"][-1]["loss"]
    assert got["model"] is not None and set(got) >= set(want)


def test_loss_decreases(tiny_corpus):
    """TestTrainLoop.test_loss_decreases on the port; the SIGTERM handler
    the loop installs is restored after it."""
    before = signal.getsignal(signal.SIGTERM)
    out = tlaunch.train_loop(
        cfg=tbase.get_smoke_config("qwen2_5_3b"), steps=30, batch_size=8, seq_len=64, lr=1e-2,
        corpus=tiny_corpus, select_k=4, log_every=1, log_fn=_quiet, device="cpu")
    first = out["history"][0]["ce"]  # after 1 update: ~ln(vocab)
    last = min(h["ce"] for h in out["history"][-5:])
    assert last < first - 0.3, (first, last)
    assert signal.getsignal(signal.SIGTERM) == before


def test_selection_finds_reference_domains(tiny_corpus):
    out = tlaunch.train_loop(
        cfg=tbase.get_smoke_config("qwen2_5_3b"), steps=2, batch_size=2, seq_len=64,
        corpus=tiny_corpus, select_k=4, log_fn=_quiet, device="cpu")
    assert set(out["selection"].selected_domains.tolist()) == set(tiny_corpus.close_ids.tolist())


def test_checkpoint_resume_matches(tiny_corpus, tmp_path):
    """TestTrainLoop.test_checkpoint_resume_matches on the port, with its
    xlstm-125m smoke (bf16, vocab 256): 20 steps against 10, a save, and
    a resume to 20, within the reference test's atol 2e-2 on every
    parameter; the snapshots hold bf16 leaves and an int32 step."""
    cfg = tbase.get_smoke_config("xlstm_125m")
    assert cfg.dtype == "bfloat16" and cfg.vocab_size == 256
    kw = dict(cfg=cfg, batch_size=4, seq_len=64, lr=1e-3, corpus=tiny_corpus, select_k=4,
              log_fn=_quiet, seed=3, device="cpu")
    full = tlaunch.train_loop(steps=20, **kw)
    tlaunch.train_loop(steps=10, ckpt_dir=str(tmp_path / "ck"), ckpt_every=10, **kw)
    meta = json.loads((tmp_path / "ck" / "step_10" / "META.json").read_text())
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in meta["leaves"]}
    assert dtypes[".params/embed/table"] == "bfloat16" and dtypes[".step"] == "int32"
    assert dtypes[".opt_state/mu/embed/table"] == "float32"
    resumed = tlaunch.train_loop(steps=20, ckpt_dir=str(tmp_path / "ck"), ckpt_every=10, **kw)
    assert int(resumed["state"].step) == 20
    for a, b in zip(tree_leaves(full["state"].params), tree_leaves(resumed["state"].params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-2)


def test_main_smoke_on_cpu(capsys):
    assert tlaunch.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "32"]) == 0
    out = capsys.readouterr().out
    assert "[fastmatch] selected domains" in out and "final loss:" in out


# ---------------------------------------------------------------------------
# snapshots across packages
# ---------------------------------------------------------------------------


def _port_state_bits(state):
    return [_bits(x) for x in tree_leaves((state.params, state.opt_state))]


def test_bf16_train_state_reference_to_port(tmp_path):
    """A bf16 `TrainState` saved by the reference restores in the port bit
    for bit (parameters bf16, moments f32, the step)."""
    jm, jstate, model, state = _pair("qwen2_5_3b", "bfloat16", seed=6)
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    JManager(str(tmp_path), config_hash="h").save(jstate, 7)
    restored = CheckpointManager(str(tmp_path), config_hash="h").restore(state.skeleton())
    assert restored.params["embed"]["table"].dtype == torch.bfloat16
    fresh = TrainState.create(model_zoo.get_model(model.cfg, device="cpu"),
                              get_optimizer("adamw", LR))
    loaded = fresh.load_(restored)
    assert int(loaded.step) == 7 and loaded.step.dtype == torch.int64
    want = [_bits(x) for x in jax.tree.leaves((jstate.params, jstate.opt_state))]
    assert all(np.array_equal(a, b) for a, b in zip(_port_state_bits(loaded), want))


def test_bf16_train_state_port_to_reference(tmp_path):
    """The reverse: the port's bf16 state, saved, restores in the
    reference bit for bit; both managers write the same files (names,
    dtypes, shapes, bytes and checksums) for the same state."""
    jm, jstate, model, state = _pair("qwen2_5_3b", "bfloat16", seed=7)
    step = make_train_step(model, get_optimizer("adamw", LR))
    state, _ = step(state, {"tokens": torch.from_numpy(_tokens(256, seed=7))})
    CheckpointManager(str(tmp_path / "port"), config_hash="h").save(state.to_disk(), 1)
    like = JTrainState(jax.tree.map(jnp.asarray, jstate.params),
                       jax.tree.map(jnp.asarray, jstate.opt_state), jstate.step)
    back = JManager(str(tmp_path / "port"), config_hash="h").restore(like)
    assert back.params["embed"]["table"].dtype == jnp.bfloat16
    assert int(back.step) == 1
    want = _port_state_bits(state)
    assert all(np.array_equal(a, _bits(b))
               for a, b in zip(want, jax.tree.leaves((back.params, back.opt_state))))
    # the same state written by the reference: the same files
    JManager(str(tmp_path / "ref"), config_hash="h").save(back, 1)
    port_dir, ref_dir = tmp_path / "port" / "step_1", tmp_path / "ref" / "step_1"
    pm, rm = (json.loads((d / "META.json").read_text()) for d in (port_dir, ref_dir))
    assert pm["leaves"] == rm["leaves"]
    psum, rsum = (json.loads((d / "CHECKSUMS.json").read_text()) for d in (port_dir, ref_dir))
    assert {k: v for k, v in psum.items() if k != "META.json"} == \
        {k: v for k, v in rsum.items() if k != "META.json"}


def test_bf16_leaves_round_trip(tmp_path):
    """The port's own manager: a bf16 leaf is stored as its uint16 bits
    with ``"dtype": "bfloat16"`` and comes back bf16, bit for bit."""
    t = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"w": t, "n": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), config_hash=config_hash("x"))
    mgr.save(tree, 2)
    meta = json.loads((tmp_path / "step_2" / "META.json").read_text())
    assert meta["leaves"][1] == {"name": "w", "dtype": "bfloat16", "shape": [5, 3]}
    assert np.load(tmp_path / "step_2" / "arr_1.npy").dtype == np.uint16
    back = mgr.restore(tree)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
