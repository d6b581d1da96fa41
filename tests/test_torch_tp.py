"""Tensor-parallel serving (`distributed.shard_model`) on 4 gloo CPU ranks
against the JAX reference's one-device model, as the reference's own
sharded test holds its layout (tests/test_serving_sharded.py): a
re-sharding, not a different computation.

The reference's widened llama3-405b smoke (d_model 128, 8 heads, 2 kv
heads, d_ff 256; batch 4, context 32, a 16-token prefill) with its own
weights (`shard_model(params=...)`), on a 2 x 2 ("data", "model") mesh
with head-sharded caches and on 1 x 4 under ``decode_seq_shard``
(flash-decoding: 2 kv heads cannot split 4 ways, so q/k/v are assembled
whole and the cache's sequence dim is split): the prefill's last logits
and 4 decode steps' within 0.05 in bf16 (the reference test's bar) and
1e-4 in f32 (the LM twins'), every rank's vocab columns of every row of
its data shard. Also `ServeEngine` on the 2 x 2 mesh in f32, each data
replica serving its half of 8 ragged requests: every output the
reference engine's; and the qwen2.5-3b smoke under
``set_tp_reduce_dtype(bf16)`` in both packages (bf16 partial products
reduced in bf16): `forward` within the LM twins' 0.06. And the
qwen2.5-3b smoke in float32 on 1 x 4 without flash-decoding: its 4 q
heads split 4 ways and its 2 kv heads do not, so each rank attends its
own q head against the kv head it reads ("q_heads"); the prefill's last
logits and 4 decode steps within 1e-4 of the port's one-process model,
which is itself within 1e-4 of the reference's.

One spawn of 4 ranks runs every case, re-meshing the one process group.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models.model_zoo import get_model as jget_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import distributed

import torch_shard_ranks
from torch_shard_ranks import B, CTX, DECODE_CASES, PREFILL, STEPS, llama_cfg

ATOL = {"bfloat16": 0.05, "float32": 1e-4}
PROMPT_LENS = (6, 8, 8, 7, 5, 8, 3, 8)


def _cfgs(arch: str, dtype: str, **kw):
    if arch == "llama3_405b":
        return (dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype,
                                    **torch_shard_ranks.WIDEN, **kw), llama_cfg(dtype, **kw))
    return (dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **kw))


def _params(arch: str, dtype: str, seed: int = 0):
    jc, _ = _cfgs(arch, dtype)
    jm = jget_model(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, jax.tree.map(np.asarray, params)


def _arr(side: str, a: np.ndarray):
    """``a`` as the reference's (a jax array) or the port's (a tensor) input."""
    return jnp.asarray(a) if side == "reference" else torch.from_numpy(a)


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (B, CTX)).astype(np.int32)


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def runs():
    refs = {dtype: _params("llama3_405b", dtype) for dtype in ("bfloat16", "float32")}
    qwen = _params("qwen2_5_3b", "bfloat16", seed=3)
    vocab = refs["float32"][0].cfg.vocab_size
    toks = _tokens(vocab)
    qwen_toks = np.random.default_rng(3).integers(0, qwen[0].cfg.vocab_size, (2, 16)).astype(
        np.int32)
    qwen32 = _params("qwen2_5_3b", "float32", seed=4)
    qwen_serve = np.random.default_rng(4).integers(0, qwen32[0].cfg.vocab_size, (B, CTX)).astype(
        np.int32)
    trees = {"bfloat16": refs["bfloat16"][2], "float32": refs["float32"][2], "qwen": qwen[2],
             "qwen_f32": qwen32[2]}
    # the ranks run while this process computes the reference's side
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(distributed.run_ranks, torch_shard_ranks.tp_rank, 4, trees, toks,
                          _prompts(vocab), qwen_toks, qwen_serve, device_type="cpu", timeout=300)
    want = {}
    jm, params, tree = qwen32
    one = convert.lm_params_from_numpy(tree, _cfgs("qwen2_5_3b", "float32")[1], device="cpu")
    want["q_heads"] = {}
    for side, (prefill, decode_step) in (
            ("reference", (functools.partial(jm.prefill, params),
                           functools.partial(jm.decode_step, params))),
            ("one_process", (one.prefill, one.decode_step))):
        logits, cache = prefill(_arr(side, qwen_serve[:, :PREFILL]), CTX)
        steps = [np.asarray(logits[:, -1], np.float32)]
        for i in range(PREFILL, PREFILL + STEPS):
            step, cache = decode_step(cache, _arr(side, qwen_serve[:, i]))
            steps.append(np.asarray(step, np.float32))
        want["q_heads"][side] = steps
    for dtype, (jm, params, _) in refs.items():
        logits, cache = jm.prefill(params, jnp.asarray(toks[:, :PREFILL]), CTX)
        steps = [np.asarray(logits[:, -1], np.float32)]
        for i in range(PREFILL, PREFILL + STEPS):
            step, cache = jm.decode_step(params, cache, jnp.asarray(toks[:, i]))
            steps.append(np.asarray(step, np.float32))
        want[dtype] = steps
    jm, params, _ = refs["float32"]
    jeng = JServeEngine(jm, params, slots=2, max_len=16)
    for i, p in enumerate(_prompts(vocab)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    want["engine"] = {r.rid: r.output for r in jeng.run()}
    jm, params, _ = qwen
    try:
        jL.set_tp_reduce_dtype(jnp.bfloat16)
        logits, _ = jm.forward(params, jnp.asarray(qwen_toks))
    finally:
        jL.set_tp_reduce_dtype(None)
    want["tp_reduce_bf16"] = np.asarray(logits, np.float32)
    ranks = pending.result()
    pool.shutdown()
    return ranks, want


@pytest.mark.parametrize("case,shape,dtype,seq", DECODE_CASES)
def test_decode_logits_match_one_device(runs, case, shape, dtype, seq):
    ranks, want = runs
    for r in ranks:
        got = r[case]
        lo, hi = got["cols"]
        for step, (g, w) in enumerate(zip(got["logits"], want[dtype])):
            w = w[got["rows"][0] : got["rows"][1], lo:hi]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=ATOL[dtype], rtol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("case,shape,dtype,seq", DECODE_CASES)
def test_layout_and_placement(runs, case, shape, dtype, seq):
    """2 x 2: local heads (1 kv head a rank) and a head-sharded cache;
    1 x 4 flash-decoding: whole heads, the cache's 32 positions in 4
    ranges of 8; every rank holds 1/|model| of each split leaf (no rank
    the whole model); the reduced greedy pick is the reference's argmax
    (first index) on the rank's rows."""
    ranks, want = runs
    _, cfg = _cfgs("llama3_405b", dtype)
    m = shape[1]
    whole = sum(np.prod(a.shape) for a in jax.tree.leaves(_params("llama3_405b", dtype)[2]))
    for r in ranks:
        got = r[case]
        rows = slice(*got["rows"])
        if seq:
            assert got["attn"] == "whole"
            assert got["cache_shape"] == (B, CTX // m, cfg.num_kv_heads, cfg.head_dim)
            assert got["seq"][1] == CTX and got["seq"][0] in range(0, CTX, CTX // m)
        else:
            assert got["attn"] == "heads" and got["seq"] is None
            assert got["cache_shape"] == (B // shape[0], CTX, cfg.num_kv_heads // m, cfg.head_dim)
        assert got["params"] < whole / m * 1.05
        assert got["pick"].tolist() == np.argmax(want[dtype][-1][rows], -1).tolist()


def test_engine_on_mesh_matches_reference_engine(runs):
    ranks, want = runs
    got = {}
    for r in ranks:
        for rid, output in r["engine"]["outputs"].items():
            assert got.setdefault(rid, output) == output  # both model ranks agree
    assert got == want["engine"]
    assert ranks[0]["engine"]["metrics"] == {"prefills": 2, "decode_ticks": 6, "tokens_out": 16}


def test_dense_tp_reduce_bf16_matches(runs):
    ranks, want = runs
    for r in ranks:
        got = r["tp_reduce_bf16"]
        lo, hi = got["cols"]
        assert got["attn"] == "heads"
        w = want["tp_reduce_bf16"][got["rows"][0] : got["rows"][1], :, lo:hi]
        np.testing.assert_allclose(got["logits"], w, atol=0.06, rtol=0)


def test_q_heads_serving_matches_one_process(runs):
    """The qwen2.5-3b smoke in float32 on 1 x 4 ("q_heads": 4 q heads
    split 4 ways, 2 kv heads not, no flash-decoding): each rank's cache
    holds the one kv head its q head reads, whole over the sequence; the
    prefill's last logits and 4 decode steps, every rank's vocab
    columns, within 1e-4 of the port's one process, which is within 1e-4
    of the reference's."""
    ranks, want = runs
    w = want["q_heads"]
    for g, r in zip(w["one_process"], w["reference"]):
        np.testing.assert_allclose(g, r, atol=ATOL["float32"], rtol=0)
    cfg = tbase.get_smoke_config("qwen2_5_3b")
    for rk in ranks:
        got = rk["q_heads"]
        assert got["attn"] == "q_heads" and got["seq"] is None
        assert got["cache_shape"] == (B, CTX, 1, cfg.head_dim)
        lo, hi = got["cols"]
        for step, (g, o) in enumerate(zip(got["logits"], w["one_process"])):
            np.testing.assert_allclose(g, o[:, lo:hi], atol=ATOL["float32"], rtol=0,
                                       err_msg=f"step {step}")
