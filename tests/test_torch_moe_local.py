"""`moe_ffn_local`'s mesh form (shard-local MoE dispatch) on 4 gloo CPU
ranks, a 2 x 2 ("data", "model") mesh, against the JAX reference on one
device.

The mixtral smoke (4 experts, top-2, capacity factor 4.0: dropless, as
tests/test_serving_sharded.py runs it) with the reference's weights,
``moe_impl="local"``: `forward`'s logits on each data shard's rows within
0.05 of the reference's one-device forward (the reference test's bar);
the aux terms the mean over the data shards of the reference's forward
on each shard's rows alone (the reference's ``pmean``: each shard routes
its own tokens), within the same bar, ``drop_frac`` 0. Then
`moe_ffn_local` alone on layer 1's experts (each rank's ff block) at
capacity factor 1.0, where tokens drop: each data shard's output against
the reference's `moe_ffn` on that shard's tokens alone (what capacity
per shard means), ``drop_frac`` and the other aux terms their mean over
the shards. The layer's output is bf16 and reaches |y| ~ 258 (the smoke
experts' weights have std 1/2: their fan-in is read from the expert
dim): the port sums the ranks' f32 partial outputs and casts once, where
the one-device reference casts its own f32 sum, so the two may round
apart by one bf16 ulp of |y|; under ``set_tp_reduce_dtype(bf16)`` in
both packages each partial is rounded to bf16 before the reduce (the
reference's ``psum`` of the bf16 output), and XLA's bf16 ``silu(g) * u``
rounds otherwise than PyTorch's on some elements (ROADMAP A12e). So this
check's bar is one bf16 ulp at the layer's activation scale, the larger
of its largest |silu(g) * u| and its largest |y|, not the logits' 0.05.

Then ``moe_impl="gather"`` on the same mesh in float32 at capacity
factor 0.5, where pairs drop: `forward` on each data shard's rows
against the reference's one-device forward of the whole batch (the
global batch's capacity and slotting, `models.moe.moe_ffn_mesh`), and
each data replica's `ServeEngine` against the reference engine. And
`moe_ffn_mesh`'s two expert buffers on one layer of those weights, at
that capacity and at the dropless one: the aux terms bitwise the same,
the output and the gradients within 1e-5 of each other, and the rows
each multiplies.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models.model_zoo import get_model as jget_model
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.core import distributed
from repro_torch.models.moe import route

import torch_shard_ranks

ATOL = 0.05
LAYER = 1


def _ulp_bf16(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.fixture(scope="module")
def runs():
    cfg = dataclasses.replace(jbase.get_smoke_config("mixtral_8x7b"), moe_impl="gather")
    jm = jget_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    x = np.random.default_rng(2).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    # "gather" in float32 at a capacity that drops, on the same weights
    gcfg = dataclasses.replace(cfg, expert_capacity_factor=torch_shard_ranks.GATHER_CF,
                               dtype="float32")
    gm = jget_model(gcfg)
    params32 = gm.init(jax.random.PRNGKey(0))
    tree32 = jax.tree.map(np.asarray, params32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (6, 8, 8, 7)]
    pending = pool.submit(distributed.run_ranks, torch_shard_ranks.moe_rank, 4, tree, toks, x,
                          LAYER, tree32, prompts, device_type="cpu", timeout=300)
    want = {}
    logits, aux = jax.jit(gm.forward)(params32, jnp.asarray(toks))
    want["gather"] = dict(logits=np.asarray(logits), aux={k: float(v) for k, v in aux.items()})
    engine = JServeEngine(gm, params32, slots=2, max_len=16)
    for i, p in enumerate(prompts):
        engine.submit(JRequest(rid=i, prompt=p, max_new_tokens=torch_shard_ranks.GATHER_NEW))
    want["gather_engine"] = {r.rid: r.output for r in engine.run()}
    want["logits"], _ = jm.forward(params, jnp.asarray(toks))
    want["buffer_x"] = x
    want["buffer_router"] = np.array(params32["layers"][LAYER]["moe"]["router"], np.float32)
    shard_aux = [jm.forward(params, jnp.asarray(toks[r : r + 2]))[1] for r in (0, 2)]
    want["aux"] = {k: np.mean([float(a[k]) for a in shard_aux]) for k in shard_aux[0]}
    moe = params["layers"][LAYER]["moe"]
    xs = jnp.asarray(x).astype(jnp.bfloat16)
    for name, reduce in (("drop_f32", None), ("drop_bf16", jnp.bfloat16)):
        try:
            jL.set_tp_reduce_dtype(reduce)
            outs = [jmoe_ffn(moe, xs[r : r + 2], num_experts=cfg.num_experts,
                             top_k=cfg.experts_per_token, capacity_factor=1.0)
                    for r in (0, 2)]
        finally:
            jL.set_tp_reduce_dtype(None)
        want[name] = dict(y=[np.asarray(o[0], np.float32) for o in outs],
                          aux={k: np.mean([float(o[1][k]) for o in outs]) for k in outs[0][1]})
    # the layer's largest |silu(g) * u| (f32, every token, every expert)
    xf = np.asarray(xs, np.float32)
    g = np.einsum("btd,edf->btef", xf, np.asarray(moe["w_gate"], np.float32))
    u = np.einsum("btd,edf->btef", xf, np.asarray(moe["w_up"], np.float32))
    want["h_max"] = float(np.abs(g / (1 + np.exp(-g)) * u).max())
    want["y_max"] = max(float(np.abs(y).max()) for n in ("drop_f32", "drop_bf16")
                        for y in want[n]["y"])
    ranks = pending.result()
    pool.shutdown()
    return ranks, want


def test_forward_logits_match_one_device(runs):
    ranks, want = runs
    for r in ranks:
        lo, hi = r["cols"]
        w = np.asarray(want["logits"], np.float32)[r["rows"][0] : r["rows"][1], :, lo:hi]
        assert r["attn"] == "heads" and r["w_gate"] == (4, 64, 64)  # ff 128 over 2
        np.testing.assert_allclose(r["logits"], w, atol=ATOL, rtol=0)


def test_forward_aux_is_the_shards_mean(runs):
    ranks, want = runs
    for r in ranks:
        assert set(r["aux"]) == set(want["aux"])
        assert r["aux"]["drop_frac"] == want["aux"]["drop_frac"] == 0.0
        for k in ("load_balance_loss", "router_z_loss"):
            assert abs(r["aux"][k] - want["aux"][k]) <= ATOL, k


@pytest.mark.parametrize("name", ("drop_f32", "drop_bf16"))
def test_capacity_is_per_shard(runs, name):
    ranks, want = runs
    bar = _ulp_bf16(max(want["h_max"], want["y_max"]))
    assert want[name]["aux"]["drop_frac"] > 0  # the capacity drops tokens
    for r in ranks:
        shard = r["rows"][0] // 2
        np.testing.assert_allclose(r[name]["y"], want[name]["y"][shard], atol=bar, rtol=0)
        assert r[name]["aux"]["drop_frac"] == pytest.approx(want[name]["aux"]["drop_frac"],
                                                            abs=1e-7)
        for k in ("load_balance_loss", "router_z_loss"):
            assert abs(r[name]["aux"][k] - want[name]["aux"][k]) <= 1e-4, k


def test_gather_on_data_mesh_slots_the_global_batch(runs):
    """``moe_impl="gather"`` on the 2 x 2 mesh in float32 at capacity
    factor 0.5: each data replica's `forward` logits within 1e-4 of the
    reference's one-device forward of the whole batch (whose capacity and
    cumulative sum span both replicas' rows), the aux terms the global
    batch's on every rank, ``drop_frac`` (pairs dropped, summed over the
    layers) equal and above 0."""
    ranks, want = runs
    w = want["gather"]
    assert w["aux"]["drop_frac"] > 0
    for r in ranks:
        lo, hi = r["cols"]
        np.testing.assert_allclose(r["gather"]["logits"],
                                   w["logits"][r["rows"][0] : r["rows"][1], :, lo:hi],
                                   atol=1e-4, rtol=0)
        assert r["gather"]["aux"] == ranks[0]["gather"]["aux"]
        assert r["gather"]["aux"]["drop_frac"] == w["aux"]["drop_frac"]
        for k in ("load_balance_loss", "router_z_loss"):
            assert abs(r["gather"]["aux"][k] - w["aux"][k]) <= 1e-5, k


def test_gather_engine_on_data_mesh_matches_reference(runs):
    """`ServeEngine` on the rank-local "gather" model, each data replica
    serving its half of 4 prompts (a prefill and 4 decode ticks each,
    routed at the dropless capacity): every output the reference
    engine's on one device."""
    ranks, want = runs
    got = {}
    for r in ranks:
        for rid, output in r["gather_engine"]["outputs"].items():
            assert got.setdefault(rid, output) == output
    assert got == want["gather_engine"]
    for r in ranks:
        assert r["gather_engine"]["metrics"] == {
            "prefills": 1, "decode_ticks": torch_shard_ranks.GATHER_NEW - 1,
            "tokens_out": 2 * torch_shard_ranks.GATHER_NEW}


@pytest.mark.parametrize("cf", (torch_shard_ranks.GATHER_CF, 4.0), ids=("drops", "dropless"))
def test_pair_buffer_matches_expert_buffer(runs, cf):
    """`moe_ffn_mesh` on a rank's ff block of layer 1's experts (float32,
    the global slotting), its products on the rank's pairs sorted by
    expert ("pairs") against the batched (E, min(C, T)) buffer
    ("batched") on the same routing: the aux terms bitwise equal, and
    ``drop_frac`` the share of the global batch's pairs `route` drops
    (some at capacity factor 0.5, none at 4.0, the dropless capacity of 4
    experts); the output and the gradients on the activations and every
    leaf within 1e-5 of the largest |value|; the rows each buffer's
    expert products ran, from the FLOPs its forward counted: the rank's
    T*K pairs sorted, E x min(C, T) batched."""
    ranks, want = runs
    t, top_k, e, d = 2 * 16, 2, 4, want["buffer_x"].shape[-1]
    xt = torch.from_numpy(want["buffer_x"].reshape(-1, d))
    keep = route(torch.from_numpy(want["buffer_router"]), xt, num_experts=e, top_k=top_k,
                 capacity_factor=cf)["keep"]
    capacity = max(1, round(2 * t * top_k / e * cf))  # the global batch's T is 2t
    for r in ranks:
        got, batched = r["buffers"][(cf, "pairs")], r["buffers"][(cf, "batched")]
        assert got["aux"] == batched["aux"]
        assert got["aux"]["drop_frac"] == pytest.approx(1.0 - float(keep.float().mean()),
                                                        abs=1e-7)
        assert (got["aux"]["drop_frac"] > 0) == (cf < e)
        for a, b, what in [(got["y"], batched["y"], "y"),
                           *((got["grads"][k], batched["grads"][k], k) for k in batched["grads"])]:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), what
        rows = {name: (res["flops"] - 2 * t * d * e) / (3 * 2 * d * res["ff"])
                for name, res in (("pairs", got), ("batched", batched))}
        assert rows == {"pairs": t * top_k, "batched": e * min(capacity, t)}
