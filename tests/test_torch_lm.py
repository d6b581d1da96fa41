"""The port's LM side (configs, layers, the dense / vlm transformer, the
model zoo and `ServeEngine`) against the JAX reference.

Every model here holds the reference's own weights, carried over with
`convert.lm_params_from_numpy` (bf16 leaves bit for bit). Logits of
`forward`, `prefill` and `decode_step` must agree within atol 1e-4 in
float32 and 0.06 in bfloat16 (the reference's own bar between its
decode and forward paths, tests/test_models.py). `ServeEngine` runs in
float32, where greedy outputs must be equal, past ``max_len`` too (the
reference's cache write clamps at the last slot).
"""

import dataclasses

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
from repro_torch.models import layers as tL
from repro_torch.models import model_zoo
from repro_torch.serve import Request, ServeEngine

ATOL = {"float32": 1e-4, "bfloat16": 0.06}
ARCHS = ("qwen2_5_3b", "granite_8b")


def _cfgs(arch: str, dtype: str, **kw):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def _pair(arch: str, dtype: str, seed: int = 0, **kw):
    """(reference model, its params, the port's model with those params)."""
    jc, tc = _cfgs(arch, dtype, **kw)
    jm = jget_model(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jm, params, tm


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal(arch):
    for getter in ("get_config", "get_smoke_config"):
        a, b = getattr(jbase, getter)(arch), getattr(tbase, getter)(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count == b.param_count
        assert a.active_param_count == b.active_param_count
        assert a.sub_quadratic == b.sub_quadratic


def test_config_registry_equal():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.ALIASES == jbase.ALIASES
    assert tbase.SHAPES == {k: tbase.Shape(**dataclasses.asdict(v)) for k, v in jbase.SHAPES.items()}
    assert tbase.get_config("qwen2.5-3b") == tbase.get_config("qwen2_5_3b")


def _path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_every_family_builds(arch):
    """`get_model` builds every configuration at its smoke size, a
    `model_zoo.Model` whose parameters are the reference's tree: the same
    names, shapes and dtypes; its forward gives finite logits."""
    cfg = tbase.get_smoke_config(arch)
    model = model_zoo.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, model_zoo.Model)
    shapes = jax.eval_shape(jget_model(jbase.get_smoke_config(arch)).init, jax.random.PRNGKey(0))
    want = {_path_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {name: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for name, p in model.named_parameters()}
    assert got == want
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 8)))
    logits, _ = model.forward(toks)
    assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(ATOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch, dtype):
    jm, params, tm = _pair(arch, dtype)
    toks = _tokens(jm.cfg.vocab_size, (2, 16))
    want, _ = jm.forward(params, jnp.asarray(toks))
    got, aux = tm.forward(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and aux == {}
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", sorted(ATOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tp_reduce_matches(arch, dtype):
    """`set_tp_reduce_dtype(bf16)` in both packages: the wo / w_down products
    and the MLP boundaries in bf16 give the reference's logits, and stay
    within the reference's 0.25 of the f32-reduce baseline
    (tests/test_perf_variants.py::TestBF16Boundaries)."""
    jm, params, tm = _pair(arch, dtype, seed=3)
    toks = _tokens(jm.cfg.vocab_size, (2, 16), seed=3)
    base, _ = tm.forward(torch.from_numpy(toks))
    try:
        jL.set_tp_reduce_dtype(jnp.bfloat16)
        tL.set_tp_reduce_dtype(torch.bfloat16)
        want, _ = jm.forward(params, jnp.asarray(toks))
        got, _ = tm.forward(torch.from_numpy(toks))
    finally:
        jL.set_tp_reduce_dtype(None)
        tL.set_tp_reduce_dtype(None)
    assert not torch.equal(got, base)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["bfloat16"], rtol=0)
    np.testing.assert_allclose(_np(got), _np(base), atol=0.25, rtol=0)


@pytest.mark.parametrize("dtype", sorted(ATOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, dtype):
    jm, params, tm = _pair(arch, dtype, seed=1)
    toks = _tokens(jm.cfg.vocab_size, (2, 16), seed=1)
    want, jcache = jm.prefill(params, jnp.asarray(toks[:, :8]), 16)
    got, tcache = tm.prefill(torch.from_numpy(toks[:, :8]), 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    assert tcache.length == int(jcache.length) == 8
    for li in range(jm.cfg.num_layers):
        np.testing.assert_allclose(_np(tcache.k[li]), _np(jcache.k[li]), atol=ATOL[dtype])
    for t in range(8, 16):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[:, t]))
        got, tcache = tm.decode_step(tcache, torch.from_numpy(toks[:, t]))
        assert got.shape == (2, jm.cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    assert tcache.length == int(jcache.length) == 16


def test_decode_matches_own_forward():
    """prefill(first half) + decode(second half) == the port's forward."""
    _, _, tm = _pair("qwen2_5_3b", "float32", seed=2)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, (2, 16), seed=2))
    full, _ = tm.forward(toks)
    lg, cache = tm.prefill(toks[:, :8], 16)
    outs = []
    for t in range(8, 16):
        step, cache = tm.decode_step(cache, toks[:, t])
        outs.append(step)
    torch.testing.assert_close(lg, full[:, :8], atol=1e-4, rtol=0)
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 8:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", sorted(ATOL))
def test_vlm_forward_with_vision_embeds(dtype):
    jm, params, tm = _pair("internvl2_76b", dtype)
    cfg = jm.cfg
    toks = _tokens(cfg.vocab_size, (2, 16), seed=3)
    vis = (np.random.default_rng(3).standard_normal((2, cfg.vision_tokens, cfg.d_model))
           * 0.5).astype(np.float32)
    want, _ = jm.forward(params, jnp.asarray(toks), vision_embeds=jnp.asarray(vis))
    got, _ = tm.forward(torch.from_numpy(toks), vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    shapes = tm.extra_input_shapes(2, 16)
    assert list(shapes) == ["vision_embeds"]
    assert shapes["vision_embeds"].shape == (2, cfg.vision_tokens, cfg.d_model)
    assert shapes["vision_embeds"].dtype == getattr(torch, dtype)


def test_scan_layers_params_unstack():
    """The reference's stacked ``scan_layers`` tree loads into the port's
    stacked model (each leaf one (L, ...) parameter under the reference's
    name) and gives its logits."""
    jm, params, tm = _pair("granite_8b", "float32", scan_layers=True)
    assert not isinstance(params["layers"], list)
    wq = params["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(tm.layers.attn["wq"].numpy(), wq)
    toks = _tokens(jm.cfg.vocab_size, (2, 16), seed=4)
    want, _ = jm.forward(params, jnp.asarray(toks))
    got, _ = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


def test_tied_embeddings():
    jm, params, tm = _pair("qwen2_5_3b", "float32", tie_embeddings=True)
    assert not hasattr(tm, "lm_head")
    toks = _tokens(jm.cfg.vocab_size, (2, 8), seed=5)
    want, _ = jm.forward(params, jnp.asarray(toks))
    got, _ = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


def test_converter_moves_bf16_bits():
    _, params, tm = _pair("qwen2_5_3b", "bfloat16")
    want = np.asarray(params["layers"][1]["mlp"]["w_up"])
    assert want.dtype.name == "bfloat16"
    got = tm.layers[1].mlp["w_up"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_converter_rejects_other_trees():
    jc, tc = _cfgs("qwen2_5_3b", "float32")
    tree = jax.tree.map(np.asarray, jget_model(jc).init(jax.random.PRNGKey(0)))
    del tree["layers"][0]["attn"]["bq"]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_numpy(tree, tc, device="cpu")
    tree = jax.tree.map(np.asarray, jget_model(jc).init(jax.random.PRNGKey(0)))
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.lm_params_from_numpy(tree, tc, device="cpu")


def test_get_model_draws_from_generator():
    cfg = tbase.get_smoke_config("qwen2_5_3b")
    a = model_zoo.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    b = model_zoo.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad
    assert a.embed["table"].dtype == torch.bfloat16
    # the reference's init scales: embeddings 0.02, dense 1/sqrt(fan_in)
    assert abs(float(a.embed["table"].float().std()) - 0.02) < 0.002
    assert abs(float(a.layers[0].mlp["w_down"].float().std()) - cfg.d_ff ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _qkv(seed, b, sq, sk, h, kvh, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(dtype)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(dtype)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("window", [0, 40])
def test_attention_chunked_equals_direct(grouped, window):
    spec_kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, chunk=48, sliding_window=window,
                   gqa_grouped=grouped)
    q, k, v = _qkv(6, 2, 100, 100, 4, 2, 16)
    pos = np.arange(100, dtype=np.int32)
    tspec = tL.AttnSpec(**spec_kw)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    chunked = tL.attention_chunked(*args, tspec, tpos, tpos)
    direct = tL.attention_direct(*args, tspec, tpos, tpos)
    torch.testing.assert_close(chunked, direct, atol=1e-5, rtol=0)
    jspec = jL.AttnSpec(**spec_kw)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = jL.attention_chunked(*jargs, jspec, jnp.asarray(pos), jnp.asarray(pos))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-5)
    # the auto switch picks the chunked form past 2048 keys only
    assert tL.attention(*args, dataclasses.replace(tspec, chunk=1024), tpos, tpos).shape == q.shape


def test_attention_auto_switch_past_2048():
    q, k, v = _qkv(7, 1, 4, 2100, 2, 1, 8)
    qpos = torch.arange(2096, 2100, dtype=torch.int32)
    kpos = torch.arange(2100, dtype=torch.int32)
    spec = tL.AttnSpec(num_heads=2, num_kv_heads=1, head_dim=8, chunk=512)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    auto = tL.attention(*args, spec, qpos, kpos)
    chunked = tL.attention_chunked(*args, spec, qpos, kpos)
    assert torch.equal(auto, chunked)
    want = jL.attention(*[jnp.asarray(a) for a in (q, k, v)],
                        jL.AttnSpec(num_heads=2, num_kv_heads=1, head_dim=8, chunk=512),
                        jnp.asarray(qpos.numpy()), jnp.asarray(kpos.numpy()))
    np.testing.assert_allclose(auto.numpy(), np.asarray(want), atol=1e-5)


def test_mlps_and_norms_match():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32) for name, shape in (
        ("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)),
        ("b_up", (48,)), ("b_down", (32,)), ("scale", (32,)), ("bias", (32,)))}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    for name in ("mlp_swiglu", "mlp_geglu", "mlp_gelu"):
        want = getattr(jL, name)(jp, jnp.asarray(x))
        got = getattr(tL, name)(tp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    for name in ("rms_norm", "layer_norm"):
        want = getattr(jL, name)(jp, jnp.asarray(x), 1e-6)
        got = getattr(tL, name)(tp, torch.from_numpy(x), 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    x4 = x.reshape(2, 5, 2, 16)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x4), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x4), jnp.asarray(pos), 1e6)), atol=1e-5)


@pytest.mark.parametrize("spec_extra", [{}, {"decode_seq_shard": True}, {"sliding_window": 2}],
                         ids=("repeat", "seq_shard", "window"))
def test_decode_write_clamps_past_max_len(spec_extra):
    """A write at position >= max_len lands in the last slot, as the
    reference's clamped dynamic_update_slice puts it; the flash-decoding
    layout's grouped form and a sliding window give the reference's
    output too."""
    spec_kw = dict(num_heads=2, num_kv_heads=1, head_dim=8, **spec_extra)
    rng = np.random.default_rng(9)
    p = {"wq": rng.standard_normal((16, 16)), "wk": rng.standard_normal((16, 8)),
         "wv": rng.standard_normal((16, 8)), "wo": rng.standard_normal((16, 16))}
    p = {k: (a * 0.3).astype(np.float32) for k, a in p.items()}
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    ck = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
    for at in (2, 3, 4, 9):
        pos = np.full((2,), at, np.int32)
        want = jL.decode_attention({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                   jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
                                   jL.AttnSpec(**spec_kw), 1e4)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        got = tL.decode_attention({k: torch.from_numpy(a) for k, a in p.items()},
                                  torch.from_numpy(x), tk, tv, torch.from_numpy(pos),
                                  tL.AttnSpec(**spec_kw), 1e4)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(want[1]), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(want[2]), atol=1e-5)
        assert got[1] is tk  # written in place


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve(jm, params, tm, prompts, *, slots, max_len, max_new, eos=-1):
    jeng = JServeEngine(jm, params, slots=slots, max_len=max_len)
    teng = ServeEngine(tm, slots=slots, max_len=max_len)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=max_new, eos_id=eos))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new, eos_id=eos))
    return jeng, jeng.run(), teng, teng.run()


def _assert_same_serving(jeng, jdone, teng, tdone):
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.output == a.output, b.rid
        assert b.done and a.done
    assert teng.metrics == jeng.metrics


def test_greedy_batch_serving_matches():
    """tests/test_train_serve.py's batch: 6 requests through 4 slots."""
    jm, params, tm = _pair("granite_8b", "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=8).astype(np.int32) for _ in range(6)]
    out = _serve(jm, params, tm, prompts, slots=4, max_len=64, max_new=5)
    _assert_same_serving(*out)
    assert out[2].metrics == {"prefills": 2, "decode_ticks": 8, "tokens_out": 30}


def test_greedy_matches_reference_and_manual_decode():
    jm, params, tm = _pair("qwen2_5_3b", "float32")
    prompt = np.arange(1, 9, dtype=np.int32)
    jeng, jdone, teng, tdone = _serve(jm, params, tm, [prompt], slots=1, max_len=32, max_new=4)
    _assert_same_serving(jeng, jdone, teng, tdone)
    logits, cache = tm.prefill(torch.from_numpy(prompt[None]), 32)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    manual = []
    for _ in range(4):
        manual.append(int(tok[0]))
        lg, cache = tm.decode_step(cache, tok)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    assert tdone[0].output == manual


def test_serving_ragged_prompts_and_eos():
    """Left-padded prompts of three lengths; an EOS that ends some early."""
    jm, params, tm = _pair("granite_8b", "float32", seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7, 9, 3)]
    probe = _serve(jm, params, tm, prompts, slots=3, max_len=32, max_new=6)
    _assert_same_serving(*probe)
    eos = probe[1][0].output[2]  # a token some request emits
    _assert_same_serving(*_serve(jm, params, tm, prompts, slots=3, max_len=32, max_new=6,
                                 eos=eos))


def test_serving_past_max_len_clamps():
    """Prompt 8, max_len 10, 6 new tokens: the last 3 decode writes land
    in slot 9, in both packages."""
    jm, params, tm = _pair("qwen2_5_3b", "float32", seed=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=8).astype(np.int32) for _ in range(2)]
    out = _serve(jm, params, tm, prompts, slots=2, max_len=10, max_new=6)
    _assert_same_serving(*out)
    assert out[2].metrics == {"prefills": 1, "decode_ticks": 5, "tokens_out": 12}


def test_serving_budget_ticks():
    jm, params, tm = _pair("qwen2_5_3b", "float32", seed=5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=6).astype(np.int32) for _ in range(5)]
    jeng = JServeEngine(jm, params, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    _assert_same_serving(jeng, jeng.run(budget_ticks=5), teng, teng.run(budget_ticks=5))
    assert len(teng.queue) == len(jeng.queue) == 1
