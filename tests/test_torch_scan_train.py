"""Training under ``scan_layers``: each per-layer leaf one stacked
``(L, ...)`` parameter under the reference's stacked name, against the
JAX reference's jitted `make_train_step` over its stacked tree (its
layers under ``lax.scan``), and against the port's own unrolled model.

The stacked model computes the unrolled model's forward and gradients;
what changes is the optimizer's view of the leaves, as in the
reference: a stacked norm scale is an (L, D) matrix that AdamW decays
and Adafactor factors over the stack, and Adafactor's ``rms_u`` and
``scale`` are taken over the whole stack (mixtral's expert leaves are
(L, E, D, F)).

Bars are tests/test_torch_train.py's f32 ones (`torch_lm_twins.BARS`):
loss, ce and the aux terms within 1e-5, grad_norm within 1e-5 relative,
param_norm within 1e-6, and every stacked leaf after step k within k
times 5 % of the learning rate (each step's update is held to 5 % of lr
there, Adam's first step normalising a grad near eps).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.models.model_zoo import get_model as jget_model
from repro.optimizer import get_optimizer as jget_optimizer
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo
from repro_torch.optimizer import get_optimizer
from repro_torch.optimizer.base import tree_leaves
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import make_grad_fn

from torch_lm_twins import BARS

LR = 1e-3
STEPS = 3
# (arch, fields both configs change): qwen2.5-3b and mixtral-8x7b with AdamW,
# llama3-405b with Adafactor; mixtral at capacity factor 0.5, where pairs drop
CASES = {
    "qwen2_5_3b": ("qwen2_5_3b", {}),
    "qwen2_5_3b-remat_full": ("qwen2_5_3b", dict(remat="full")),
    "mixtral_8x7b-cf0.5": ("mixtral_8x7b", dict(expert_capacity_factor=0.5)),
    "llama3_405b-adafactor": ("llama3_405b", {}),
}


def _cfgs(arch: str, dtype: str = "float32", **kw):
    kw = dict(dtype=dtype, scan_layers=True, **kw)
    return (dataclasses.replace(jbase.get_smoke_config(arch), **kw),
            dataclasses.replace(tbase.get_smoke_config(arch), **kw))


def _pair(arch: str, dtype: str = "float32", seed: int = 0, **kw):
    """The reference's stacked model and train state, and the port's
    stacked model and state holding the same parameters and moments."""
    jc, tc = _cfgs(arch, dtype, **kw)
    jm = jget_model(jc)
    jstate = JTrainState.create(jm.init(jax.random.PRNGKey(seed)),
                                jget_optimizer(jc.optimizer, LR))
    model, state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.opt_state),
        jstate.step, tc, device="cpu")
    return jm, jstate, model, state


def _tokens(vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (2, 16)).astype(np.int32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().copy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_steps_match_reference(case):
    """Three steps on three batches: every metric within the bars after
    each step, and every stacked leaf (the stack kept whole: (L, ...))
    within step k's bar of the reference's."""
    arch, kw = CASES[case]
    jm, jstate, model, state = _pair(arch, **kw)
    assert tuple(model.layers.attn["wq"].shape[:1]) == (jm.cfg.num_layers,)
    jstep = jax.jit(jmake_train_step(jm, jget_optimizer(jm.cfg.optimizer, LR)))
    step = make_train_step(model, get_optimizer(model.cfg.optimizer, LR))
    loss_atol, gnorm_rtol, pnorm_rtol = BARS["float32"]
    for k in range(1, STEPS + 1):
        toks = _tokens(jm.cfg.vocab_size, seed=10 + k)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, tmet = step(state, {"tokens": torch.from_numpy(toks)})
        assert set(tmet) == set(jmet)
        assert float(tmet["step_ok"]) == float(jmet["step_ok"]) == 1.0
        for name in tmet:
            if name in ("loss", "ce") or name.startswith("aux/"):
                assert abs(float(tmet[name]) - float(jmet[name])) <= loss_atol, (k, name)
        if "aux/drop_frac" in tmet:
            assert float(tmet["aux/drop_frac"]) == float(jmet["aux/drop_frac"]) > 0
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=gnorm_rtol)
        np.testing.assert_allclose(float(tmet["param_norm"]), float(jmet["param_norm"]),
                                   rtol=pnorm_rtol)
        jleaves = jax.tree_util.tree_leaves_with_path(jstate.params)
        tleaves = tree_leaves(state.params)
        assert len(tleaves) == len(jleaves)
        for got, (path, want) in zip(tleaves, jleaves):
            want = np.asarray(want, np.float32)
            assert tuple(got.shape) == want.shape
            err = float(np.abs(got.detach().numpy() - want).max())
            assert err <= k * 0.05 * LR, (k, jax.tree_util.keystr(path), err)


def _unrolled_name(name: str, i: int) -> str:
    return name.replace("layers.", f"layers.{i}.", 1)


def test_stacked_against_unrolled():
    """The port's stacked and unrolled qwen2.5-3b from one seed: the same
    values layer by layer, step 1's gradients equal bit for bit; after
    step 1 (AdamW) the moments and every per-layer matrix equal bit for
    bit, and each stacked 1-D scale ahead of the unrolled one by AdamW's
    decay of a matrix, -lr * wd * p, within two f32 ulps of the scale."""
    cfg = dataclasses.replace(tbase.get_smoke_config("qwen2_5_3b"), dtype="float32")
    scan_cfg = dataclasses.replace(cfg, scan_layers=True)
    unrolled = model_zoo.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    stacked = model_zoo.get_model(scan_cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    flat = dict(unrolled.named_parameters())
    before = {n: p.detach().clone() for n, p in stacked.named_parameters()}
    layer_leaves = [n for n in before if n.startswith("layers.")]
    for n in layer_leaves:
        assert before[n].shape[0] == cfg.num_layers
        for i in range(cfg.num_layers):
            assert torch.equal(before[n][i], flat[_unrolled_name(n, i)]), n
    toks = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, seed=1))}
    opt = get_optimizer("adamw", LR)
    s_state, u_state = TrainState.create(stacked, opt), TrainState.create(unrolled, opt)
    s_grads = make_grad_fn(stacked)(s_state, toks)[3]
    u_grads = make_grad_fn(unrolled)(u_state, toks)[3]
    names = {id(p): n for n, p in unrolled.named_parameters()}
    u_by_name = {names[id(p)]: g for p, g in zip(tree_leaves(u_state.params),
                                                  tree_leaves(u_grads))}
    s_names = {id(p): n for n, p in stacked.named_parameters()}
    for p, g in zip(tree_leaves(s_state.params), tree_leaves(s_grads)):
        n = s_names[id(p)]
        if n in layer_leaves:
            for i in range(cfg.num_layers):
                assert torch.equal(g[i], u_by_name[_unrolled_name(n, i)]), n
        else:
            assert torch.equal(g, u_by_name[n]), n
    s_state, _ = make_train_step(stacked, opt)(s_state, toks)
    u_state, _ = make_train_step(unrolled, opt)(u_state, toks)
    flat = dict(unrolled.named_parameters())
    mu_u = dict(zip([names[id(p)] for p in tree_leaves(u_state.params)],
                    tree_leaves(u_state.opt_state["mu"])))
    mu_s = dict(zip([s_names[id(p)] for p in tree_leaves(s_state.params)],
                    tree_leaves(s_state.opt_state["mu"])))
    decayed = 0
    for n, p in stacked.named_parameters():
        if n not in layer_leaves:
            assert torch.equal(p, flat[n]), n
            continue
        for i in range(cfg.num_layers):
            u_name = _unrolled_name(n, i)
            assert torch.equal(mu_s[n][i], mu_u[u_name]), n
            if p.ndim > 2:  # a per-layer matrix: AdamW decays it either way
                assert torch.equal(p[i], flat[u_name]), n
                continue
            # a per-layer 1-D leaf, a matrix once stacked: decayed here only
            diff = (p[i] - flat[u_name]).double()
            want = -LR * 0.1 * before[n][i].double()
            ulp = torch.finfo(torch.float32).eps * before[n][i].abs().double().clamp_min(1.0)
            assert bool(((diff - want).abs() <= 2 * ulp).all()), n
            decayed += int((diff != 0).sum())
    assert decayed > 0


def test_stacked_snapshot_cross_restore(tmp_path):
    """A bf16 ``scan_layers`` train state saved by either package
    restores in the other bit for bit, under the reference's stacked leaf
    names: the reference's snapshot into a fresh stacked port state, and
    the port's, after a step, into the reference; both managers write the
    same files for the same state."""
    jm, jstate, model, state = _pair("qwen2_5_3b", "bfloat16", seed=6)
    JManager(str(tmp_path / "ref_in"), config_hash="h").save(jstate, 0)
    restored = CheckpointManager(str(tmp_path / "ref_in"), config_hash="h").restore(
        state.skeleton())
    assert tuple(restored.params["layers"]["attn"]["wq"].shape)[0] == jm.cfg.num_layers
    fresh = TrainState.create(model_zoo.get_model(model.cfg, device="cpu"),
                              get_optimizer("adamw", LR))
    loaded = fresh.load_(restored)
    want = [_bits(x) for x in jax.tree.leaves((jstate.params, jstate.opt_state))]
    got = [_bits(x) for x in tree_leaves((loaded.params, loaded.opt_state))]
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))

    state, _ = make_train_step(model, get_optimizer("adamw", LR))(
        state, {"tokens": torch.from_numpy(_tokens(256, seed=7))})
    CheckpointManager(str(tmp_path / "port"), config_hash="h").save(state.to_disk(), 1)
    like = JTrainState(jax.tree.map(jnp.asarray, jstate.params),
                       jax.tree.map(jnp.asarray, jstate.opt_state), jstate.step)
    back = JManager(str(tmp_path / "port"), config_hash="h").restore(like)
    assert int(back.step) == 1
    mine = [_bits(x) for x in tree_leaves((state.params, state.opt_state))]
    assert all(np.array_equal(a, _bits(b))
               for a, b in zip(mine, jax.tree.leaves((back.params, back.opt_state))))
    JManager(str(tmp_path / "ref"), config_hash="h").save(back, 1)
    port_dir, ref_dir = tmp_path / "port" / "step_1", tmp_path / "ref" / "step_1"
    pm, rm = (json.loads((d / "META.json").read_text()) for d in (port_dir, ref_dir))
    assert pm["leaves"] == rm["leaves"]
    assert any("layers" in leaf["name"] and "attn" in leaf["name"] and
               leaf["shape"][0] == jm.cfg.num_layers for leaf in pm["leaves"])
