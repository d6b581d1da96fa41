"""What the model-family twins share (tests/test_torch_moe.py and
tests/test_torch_families.py): both packages' smoke models on the same
weights, seeded inputs, and the four twin checks every family × dtype
runs against the JAX reference on XLA:CPU: its model op by op (the
path the port follows; ``jit``'s fusion rounds bf16 intermediates
otherwise), its train step jitted, as its launcher runs it.

Bars: logits within `ATOL` (tests/test_torch_lm.py's: 1e-4 in float32,
0.06 in bfloat16); a train step within `BARS` (tests/test_torch_train.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models.model_zoo import get_model as jget_model
from repro.optimizer import get_optimizer as jget_optimizer
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.optimizer import get_optimizer
from repro_torch.optimizer.base import tree_leaves
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_train_step

ATOL = {"float32": 1e-4, "bfloat16": 0.06}
LR = 1e-3
# (loss and ce atol, grad_norm rtol, param_norm rtol): tests/test_torch_train.py's
BARS = {"float32": (1e-5, 1e-5, 1e-6), "bfloat16": (0.01, 0.02, 1e-3)}


def cfgs(arch: str, dtype: str, **kw):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def pair(arch: str, dtype: str, seed: int = 0, **kw):
    """(reference model, its params, the port's model with those params)."""
    jc, tc = cfgs(arch, dtype, **kw)
    jm = jget_model(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jm, params, tm


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def tokens(vocab: int, shape=(2, 16), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def extras(cfg, batch: int, seed: int = 0) -> tuple:
    """The stub inputs of ``cfg`` for both packages, the same values:
    whisper's encoder frames N(0, 0.02^2) (tests/test_models.py's
    `_extras` draws them so), cast to the model's dtype."""
    if cfg.frontend != "audio_stub":
        return {}, {}
    frames = (np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return ({"encoder_frames": jnp.asarray(frames).astype(jnp.dtype(cfg.dtype))},
            {"encoder_frames": torch.from_numpy(frames).to(getattr(torch, cfg.dtype))})


def check_forward(arch: str, dtype: str):
    """`forward`'s logits on 24 tokens (past the smoke configs' 16-token
    windows and mLSTM chunks) within ATOL; the aux terms' names equal,
    each within ATOL, ``drop_frac`` (a count of pairs) equal. Returns the
    aux."""
    jm, params, tm = pair(arch, dtype)
    toks = tokens(jm.cfg.vocab_size, (2, 24))
    jx, tx = extras(jm.cfg, 2)
    want, waux = jm.forward(params, jnp.asarray(toks), **jx)
    got, gaux = tm.forward(torch.from_numpy(toks), **tx)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL[dtype], rtol=0)
    assert set(gaux) == set(waux)
    for k in waux:
        if k == "drop_frac":
            assert float(gaux[k]) == float(waux[k])
        else:
            assert abs(float(gaux[k]) - float(waux[k])) <= ATOL[dtype], k
    return gaux


def check_prefill_decode(arch: str, dtype: str, *, prompt: int = 8, steps: int = 8):
    """`prefill` of ``prompt`` tokens, then ``steps`` decode steps: every
    logit within ATOL of the reference's."""
    jm, params, tm = pair(arch, dtype, seed=1)
    toks = tokens(jm.cfg.vocab_size, (2, prompt + steps), seed=1)
    jx, tx = extras(jm.cfg, 2, seed=1)
    max_len = prompt + steps
    want, jcache = jm.prefill(params, jnp.asarray(toks[:, :prompt]), max_len, **jx)
    got, tcache = tm.prefill(torch.from_numpy(toks[:, :prompt]), max_len, **tx)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL[dtype], rtol=0)
    assert tcache.length == int(jcache.length) == prompt
    for t in range(prompt, prompt + steps):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[:, t]))
        got, tcache = tm.decode_step(tcache, torch.from_numpy(toks[:, t]))
        assert got.shape == (2, jm.cfg.vocab_size)
        np.testing.assert_allclose(np32(got), np32(want), atol=ATOL[dtype], rtol=0)
    assert tcache.length == int(jcache.length) == prompt + steps


def check_serving(arch: str, dtype: str):
    """4 requests of ragged prompts (left-padded to 8) through 2 slots:
    every output and the engines' metrics equal. The shapes are
    `check_prefill_decode`'s, so the reference's op-by-op calls reuse
    what that check compiled.

    In bfloat16 the reference engine runs its decode step unjitted: XLA's
    fusion under ``jit`` rounds bf16 intermediates otherwise than the
    reference's own op-by-op path (the one the port follows), and a near
    tie of two logits then flips a greedy token between the reference's
    two paths (seen on grok-1 smoke, seed 2: a top-two margin of 0.024).
    """
    jm, params, tm = pair(arch, dtype, seed=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jm.cfg.vocab_size, size=n).astype(np.int32) for n in (6, 8, 8, 7)]
    jeng = JServeEngine(jm, params, slots=2, max_len=16)
    if dtype == "bfloat16":
        jeng._decode = jm.decode_step
    teng = ServeEngine(tm, slots=2, max_len=16)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.output == a.output, b.rid
    assert teng.metrics == jeng.metrics == {"prefills": 2, "decode_ticks": 6, "tokens_out": 16}


def check_train_step(arch: str, dtype: str, **kw):
    """One `make_train_step` step from the same parameters and moments:
    loss, ce, grad norm, param norm and every aux metric within `BARS`,
    ``step_ok`` 1 in both, the post-step parameters within 5 % of the
    learning rate in f32 (Adam's first step) and within one bf16 ulp of
    the leaf's largest |p| plus twice the learning rate in bf16
    (tests/test_torch_train.py's bars and reasons). ``kw`` overrides
    fields of both configs. Returns the metrics."""
    jc, tc = cfgs(arch, dtype, **kw)
    jm = jget_model(jc)
    jstate = JTrainState.create(jm.init(jax.random.PRNGKey(3)), jget_optimizer(jc.optimizer, LR))
    model, state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.opt_state),
        jstate.step, tc, device="cpu")
    toks = tokens(jc.vocab_size, seed=3)
    jx, tx = extras(jc, 2, seed=3)
    jnew, jmet = jax.jit(jmake_train_step(jm, jget_optimizer(jc.optimizer, LR)))(
        jstate, {"tokens": jnp.asarray(toks), **jx})
    tnew, tmet = make_train_step(model, get_optimizer(tc.optimizer, LR))(
        state, {"tokens": torch.from_numpy(toks), **tx})
    loss_atol, gnorm_rtol, pnorm_rtol = BARS[dtype]
    assert set(tmet) == set(jmet)
    assert float(tmet["step_ok"]) == float(jmet["step_ok"]) == 1.0
    for k in tmet:
        if k in ("loss", "ce") or k.startswith("aux/"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= loss_atol, k
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=gnorm_rtol)
    np.testing.assert_allclose(float(tmet["param_norm"]), float(jmet["param_norm"]),
                               rtol=pnorm_rtol)
    jleaves = jax.tree.leaves(jnew.params)
    tleaves = tree_leaves(tnew.params)
    assert len(tleaves) == len(jleaves)
    for g, w in zip(tleaves, jleaves):
        w = np32(w)
        bar = 0.05 * LR if dtype == "float32" else 2.0 ** -8 * np.abs(w).max() + 2 * LR
        assert np.abs(np32(g) - w).max() <= bar
    return tmet
