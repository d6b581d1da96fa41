"""The port's MoE (`repro_torch.models.moe` and the MoE branches of
`repro_torch.models.transformer`) against the JAX reference: mixtral-8x7b
and grok-1-314b at their smoke sizes, on the reference's own weights.

`moe_ffn`'s routing (experts, kept pairs, slots) is held bitwise to the
reference's and its ``drop_frac`` equal, with capacities that drop
tokens and the dropless one; outputs and the other aux terms at the LM
twins' bars (tests/torch_lm_twins.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral_8x7b", "grok_1_314b")
DTYPES = sorted(tw.ATOL)


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------


def _jax_route(router, xt, e: int, top_k: int, cf: float) -> dict:
    """The reference's routing and slotting, src/repro/models/moe.py:56-85
    line for line on XLA:CPU (moe_ffn returns none of it)."""
    t = xt.shape[0]
    logits = jnp.dot(xt.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    weights, experts = jax.lax.top_k(probs, top_k)
    weights = weights / jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-9)
    capacity = int(max(1, round(t * top_k / e * cf)))
    flat_expert = experts.reshape(-1)
    onehot = jax.nn.one_hot(flat_expert, e, dtype=jnp.int32)
    pos_in_expert = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.sum(pos_in_expert * onehot, axis=1)
    keep = pos < capacity
    slot = jnp.where(keep, flat_expert * capacity + pos, e * capacity)
    token_of_pair = jnp.repeat(jnp.arange(t, dtype=jnp.int32), top_k)
    slot_token = jnp.full((e * capacity + 1,), 0, jnp.int32).at[slot].set(token_of_pair)
    slot_used = jnp.zeros((e * capacity + 1,), bool).at[slot].set(keep)
    slot_token = jnp.where(slot_used, slot_token, 0)
    return dict(experts=experts, weights=weights, capacity=capacity, keep=keep, slot=slot,
                slot_token=slot_token, slot_used=slot_used)


def _moe_inputs(dtype: str, shape=(2, 16, 64), e: int = 4, d_ff: int = 96, seed: int = 0):
    jdt = jnp.dtype(dtype)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), shape[-1], d_ff, e, jdt)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tparams = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else getattr(torch, dtype))
        for k, v in params.items()}
    return params, jx, tparams, torch.from_numpy(x).to(getattr(torch, dtype))


# (capacity factor, top_k): 1.0 drops at every top-k, 1.25 is the full
# configs' factor, 4.0 = E is dropless
CASES = ((1.0, 1), (1.0, 2), (1.0, 3), (1.25, 2), (4.0, 2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cf,top_k", CASES)
def test_moe_ffn_routing_and_output(cf, top_k, dtype):
    params, jx, tparams, tx = _moe_inputs(dtype)
    e = 4
    want_route = _jax_route(params["router"], jx.reshape(-1, 64), e, top_k, cf)
    got_route = tmoe.route(tparams["router"], tx.reshape(-1, 64), num_experts=e, top_k=top_k,
                           capacity_factor=cf)
    assert got_route["capacity"] == want_route["capacity"]
    for k in ("experts", "keep", "slot", "slot_token", "slot_used"):
        np.testing.assert_array_equal(got_route[k].numpy(), np.asarray(want_route[k]), err_msg=k)
    np.testing.assert_allclose(got_route["weights"].numpy(), np.asarray(want_route["weights"]),
                               atol=1e-6, rtol=0)

    kw = dict(num_experts=e, top_k=top_k, capacity_factor=cf)
    want, waux = jmoe.moe_ffn(params, jx, **kw)
    got, gaux = tmoe.moe_ffn(tparams, tx, **kw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(tw.np32(got), tw.np32(want), atol=tw.ATOL[dtype], rtol=0)
    assert float(gaux["drop_frac"]) == float(waux["drop_frac"])
    dropped = float(gaux["drop_frac"]) > 0
    assert dropped == (cf < e), (cf, float(gaux["drop_frac"]))
    for k in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]), rtol=1e-5)
    # moe_ffn_local without a mesh is moe_ffn
    local, laux = tmoe.moe_ffn_local(tparams, tx, **kw)
    assert torch.equal(local, got) and all(torch.equal(laux[k], gaux[k]) for k in gaux)


def test_capacity_rounds_half_to_even():
    """t * k / e * cf = 2.5 gives capacity 2 (Python's round), as in the
    reference: its drop_frac shows the same capacity."""
    params, jx, tparams, tx = _moe_inputs("float32", shape=(1, 10, 64))
    kw = dict(num_experts=4, top_k=1, capacity_factor=1.0)
    r = tmoe.route(tparams["router"], tx.reshape(-1, 64), **kw)
    assert r["capacity"] == 2
    _, waux = jmoe.moe_ffn(params, jx, **kw)
    _, gaux = tmoe.moe_ffn(tparams, tx, **kw)
    assert float(gaux["drop_frac"]) == float(waux["drop_frac"]) > 0


def test_combine_is_deterministic_in_k_order():
    """The combine sums each token's k outputs in k order: equal bits on
    every call, and the weighted sum of the kept experts' outputs."""
    _, _, tparams, tx = _moe_inputs("float32", seed=4)
    kw = dict(num_experts=4, top_k=3, capacity_factor=4.0)
    a, _ = tmoe.moe_ffn(tparams, tx, **kw)
    b, _ = tmoe.moe_ffn(tparams, tx, **kw)
    assert torch.equal(a, b)
    r = tmoe.route(tparams["router"], tx.reshape(-1, 64), **kw)
    xt = tx.reshape(-1, 64)
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for k in range(3):
            ex = int(r["experts"][t, k])
            g = xt[t] @ tparams["w_gate"][ex]
            u = xt[t] @ tparams["w_up"][ex]
            want[t] += r["weights"][t, k] * ((torch.nn.functional.silu(g) * u)
                                             @ tparams["w_down"][ex])
    torch.testing.assert_close(a.reshape(-1, 64), want, atol=tw.ATOL["float32"], rtol=0)


# ---------------------------------------------------------------------------
# the MoE transformers against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(arch, dtype):
    aux = tw.check_forward(arch, dtype)
    assert set(aux) == {"load_balance_loss", "router_z_loss", "drop_frac"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, dtype):
    tw.check_prefill_decode(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches(arch, dtype):
    tw.check_serving(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches(arch, dtype):
    metrics = tw.check_train_step(arch, dtype)
    assert {"aux/load_balance_loss", "aux/router_z_loss", "aux/drop_frac"} <= set(metrics)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adafactor_train_step_matches(dtype):
    """grok-1-314b trains with Adafactor (its full config's optimizer):
    the step factors the (E, D, F) expert leaves as the reference does."""
    tw.check_train_step("grok_1_314b", dtype, optimizer="adafactor")


@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_gives_equal_grads(dtype):
    """mixtral smoke (its full config trains under remat "full") with
    remat full / dots against none: the loss, the aux terms carried out
    of each checkpointed block and every grad bit for bit."""
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState
    from repro_torch.train.step import make_loss_fn

    _, _, tm = tw.pair("mixtral_8x7b", dtype, seed=8)
    state = TrainState.create(tm, get_optimizer("adamw", tw.LR))
    toks = torch.from_numpy(tw.tokens(tm.cfg.vocab_size, (2, 32), seed=8))
    out = {}
    for remat in ("none", "full", "dots"):
        tm.cfg = dataclasses.replace(tm.cfg, remat=remat)
        loss, _, aux = make_loss_fn(tm)({"tokens": toks})
        loss.backward()
        out[remat] = [loss.detach(), *(aux[k].detach() for k in sorted(aux))] + [
            p.grad.clone() for p in tree_leaves(state.params)]
        for p in tree_leaves(state.params):
            p.grad = None
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out[remat], out["none"])), remat


def test_forward_drops_where_serving_does_not():
    """At capacity factor 1.0 `forward` drops pairs; `prefill` routes at
    the dropless capacity and gives the reference's prefill logits."""
    jm, params, tm = tw.pair("mixtral_8x7b", "float32", seed=5, expert_capacity_factor=1.0)
    toks = tw.tokens(jm.cfg.vocab_size, seed=5)
    want, waux = jm.forward(params, jnp.asarray(toks))
    got, gaux = tm.forward(torch.from_numpy(toks))
    assert float(gaux["drop_frac"]) == float(waux["drop_frac"]) > 0
    np.testing.assert_allclose(tw.np32(got), tw.np32(want), atol=tw.ATOL["float32"], rtol=0)
    wp, _ = jm.prefill(params, jnp.asarray(toks), 16)
    gp, _ = tm.prefill(torch.from_numpy(toks), 16)
    np.testing.assert_allclose(tw.np32(gp), tw.np32(wp), atol=tw.ATOL["float32"], rtol=0)
    assert np.abs(tw.np32(gp) - tw.np32(got)).max() > 1e-3


def test_scan_layers_forward():
    """mixtral smoke under ``scan_layers``: the reference's stacked tree
    (moe leaves (L, E, D, F)) loads into the port's stacked model, whose
    blocks read each layer's slice of those leaves, and gives its logits
    and aux."""
    jm, params, tm = tw.pair("mixtral_8x7b", "float32", seed=6, scan_layers=True)
    assert params["layers"]["moe"]["w_gate"].ndim == 4
    assert tm.layers.moe["w_gate"].shape == params["layers"]["moe"]["w_gate"].shape
    toks = tw.tokens(jm.cfg.vocab_size, seed=6)
    want, waux = jm.forward(params, jnp.asarray(toks))
    got, gaux = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(tw.np32(got), tw.np32(want), atol=1e-4, rtol=0)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]), atol=1e-5, rtol=0)
