"""Tensor-parallel serving of the recurrent and audio families
(`distributed.shard_model` on `rglru.HybridLM`, `xlstm.XLSTM`,
`whisper.Whisper`) on 4 gloo CPU ranks, against the JAX reference's
one-device models on the same weights (`shard_model(params=...)`).

Each family's smoke config (whisper's vocabulary cut to 521, which does
not divide over "model", as whisper-medium's 51,865 does not) on a
2 x 2 and a 1 x 4 ("data", "model") mesh: in float32 the sharded
`forward` (24 tokens, past the 16-token windows and mLSTM chunks),
`prefill` (8 tokens) and 4 `decode_step`s within 1e-4 of the
reference's (the LM twins' bar), every rank's vocab columns of every row
of its data shard; in bfloat16 within 0.06 of the port's one-process
model (the LM twins' bf16 bar), with the reduced greedy picks equal to
its argmax. Then the layouts and the blocks of the splits that do not
line up: the mLSTM's ``w_up`` blocks across its [x | z] halves, the
sLSTM's whole-gate ``w_gates`` blocks against its head-split
``r_gates`` (whole at 4 ranks: 2 heads), the 85-wide sLSTM feed-forward
and whisper's vocabulary whole on every rank (the guard's fallback), the
RG-LRU's single kv head split inside the head (its 2 q heads one a rank
at 2 ranks, "q_heads"; at 4 ranks 1, 1, 0, 0, the same layout with
uneven heads, as the xLSTM's "heads"). Uneven heads with every rank
holding one, on 1 x 4 (`torch_shard_ranks.FAM_UNEVEN`): recurrentgemma-2b
with 6 q heads (2, 2, 1, 1) and xlstm-125m with 6 heads at d_model 96.
And `ServeEngine` on the
2 x 2 mesh in float32, whisper's requests carrying their encoder frames:
every output the port's one-process engine's.

One spawn of 4 ranks runs every case (tests/torch_shard_ranks.py, which
loads no JAX); the reference runs in this process meanwhile.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model_zoo import get_model as jget_model
from repro_torch import convert
from repro_torch.core import distributed
from repro_torch.serve import Request, ServeEngine

import torch_shard_ranks as R

ATOL = {"float32": 1e-4, "bfloat16": 0.06}
CASES = [(arch, shape) for arch in R.FAMILIES for shape in R.FAM_MESHES] + [
    (name, (1, 4)) for name in R.FAM_UNEVEN]
NAMES = R.FAMILIES + tuple(R.FAM_UNEVEN)
PROMPT_LENS = (6, 8, 8, 7)


def _jcfg(arch: str, dtype: str):
    import dataclasses

    return dataclasses.replace(jbase.get_smoke_config(R.fam_arch(arch)), dtype=dtype,
                               **R.fam_kw(arch))


def _inputs(arch: str) -> tuple:
    cfg = R.family_cfg(arch, "float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (R.FAM_B, R.FAM_FWD))
    frames = None
    if cfg.frontend == "audio_stub":  # N(0, 0.02^2), as tests/test_models.py draws them
        frames = (np.random.default_rng(2).standard_normal(
            (R.FAM_B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    return toks.astype(np.int32), frames, prompts


def _reference(jm, params, toks, frames) -> dict:
    """The reference's forward, prefill and decode steps (`_family_case`'s),
    jitted (float32: XLA's fusion keeps it within the bar, and one
    compile a function is far quicker than op-by-op)."""
    jx = {} if frames is None else {
        "encoder_frames": jnp.asarray(frames).astype(jnp.dtype(jm.cfg.dtype))}
    t = jnp.asarray(toks)
    fwd, _ = jax.jit(jm.forward)(params, t, **jx)
    prefill = jax.jit(jm.prefill, static_argnums=2)
    logits, cache = prefill(params, t[:, :R.FAM_PREFILL], R.FAM_MAX_LEN, **jx)
    decode = jax.jit(jm.decode_step)
    steps = [np.asarray(logits[:, -1], np.float32)]
    for i in range(R.FAM_PREFILL, R.FAM_PREFILL + R.FAM_STEPS):
        step, cache = decode(params, cache, t[:, i])
        steps.append(np.asarray(step, np.float32))
    return dict(forward=np.asarray(fwd, np.float32), prefill=np.asarray(logits, np.float32),
                steps=steps)


@pytest.fixture(scope="module")
def runs():
    trees, toks, frames, prompts, jref = {}, {}, {}, {}, {}
    for arch in NAMES:
        toks[arch], f, prompts[arch] = _inputs(arch)
        if f is not None:
            frames[arch] = f
        trees[arch] = {}
        for dtype in ("float32", "bfloat16"):
            jm = jget_model(_jcfg(arch, dtype))
            params = jm.init(jax.random.PRNGKey(0))
            trees[arch][dtype] = jax.tree.map(np.asarray, params)
            if dtype == "float32":
                jref[arch] = (jm, params)
    # the ranks run while this process computes the reference's side
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(distributed.run_ranks, R.family_rank, 4, trees, toks, frames, prompts,
                          device_type="cpu", timeout=600)
    want = {}
    for arch in NAMES:
        jm, params = jref[arch]
        want[(arch, "float32")] = _reference(jm, params, toks[arch], frames.get(arch))
        # the port's one-process model in bf16, and its engine in f32
        model = convert.lm_params_from_numpy(trees[arch]["bfloat16"], R.family_cfg(
            arch, "bfloat16"), device="cpu")
        f = frames.get(arch)
        want[(arch, "bfloat16")] = R._family_case(
            model, torch.from_numpy(toks[arch]),
            None if f is None else torch.from_numpy(f).to(torch.bfloat16))
        if arch not in R.FAMILIES:
            continue
        model = convert.lm_params_from_numpy(trees[arch]["float32"],
                                             R.family_cfg(arch, "float32"), device="cpu")
        engine = ServeEngine(model, slots=2, max_len=R.FAM_MAX_LEN)
        for i, p in enumerate(prompts[arch]):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=4, extras=None if f is None
                                  else {"encoder_frames": f[i % R.FAM_B]}))
        want[(arch, "engine")] = {r.rid: r.output for r in engine.run()}
    ranks = pending.result()
    pool.shutdown()
    return ranks, want, trees


def _block(got, want, rows, cols):
    lo, hi = cols if cols is not None else (0, want.shape[-1])
    w = want[rows[0] : rows[1], ..., lo:hi]
    assert got.shape == w.shape
    return w


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_logits_match(runs, arch, shape, dtype):
    """float32 against the reference, bfloat16 against the port's one
    process: forward, prefill and every decode step, on each rank's rows
    and vocab columns; in bf16 the greedy picks are the argmax."""
    ranks, want, _ = runs
    ref = want[(arch, dtype)]
    for r in ranks:
        got = r[(arch, shape, dtype)]
        for name in ("forward", "prefill"):
            np.testing.assert_allclose(got[name], _block(got[name], ref[name], got["rows"],
                                                         got["cols"]),
                                       atol=ATOL[dtype], rtol=0, err_msg=name)
        for step, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
            np.testing.assert_allclose(g, _block(g, w, got["rows"], got["cols"]),
                                       atol=ATOL[dtype], rtol=0, err_msg=f"step {step}")
        if dtype == "bfloat16":
            for g, w in zip(got["picks"], ref["picks"]):
                assert g.tolist() == w[got["rows"][0] : got["rows"][1]].tolist()


def _expected_layout(arch: str, m: int) -> dict:
    if arch == "recurrentgemma_2b":  # 1 kv head: each rank its own q heads, even or not
        return dict(attn="q_heads", mlp=True, layout={"lru": "channels"})
    if arch == "xlstm_125m":  # each rank its own heads, even or not
        return dict(attn="replicated", mlp=False,
                    layout={"mlstm": "heads", "slstm": "heads", "slstm_ffn": "replicated"})
    return dict(attn="heads", mlp=True, layout={})


@pytest.mark.parametrize("arch,shape", CASES)
def test_layout_and_blocks(runs, arch, shape):
    """Each plan's layout, and each checked leaf's block: the slice of the
    reference's leaf this rank's model coordinate gives."""
    ranks, _, trees = runs
    m = shape[1]
    tree = convert._flatten(trees[arch]["float32"])
    whole = sum(np.prod(a.shape) for a in tree.values())
    case, arch = arch, R.fam_arch(arch)
    for r in ranks:
        got = r[(case, shape, "float32")]
        k = got["coord"]["model"]
        assert {key: got[key] for key in ("attn", "mlp", "layout")} == _expected_layout(arch, m)
        assert got["held"] < whole
        for name, block in got["blocks"].items():
            leaf = tree[name]
            if arch == "xlstm_125m" and name.endswith("w_up"):
                # the [x | z] halves: at 2 ranks rank 0 holds x, rank 1 z
                half = leaf.shape[1] // 2
                want = (leaf[:, :half] if k == 0 else leaf[:, half:]) if m == 2 else \
                    leaf[:, k * half // 2 : (k + 1) * half // 2]
            elif arch == "xlstm_125m" and name.endswith("w_gates"):
                d = leaf.shape[0]  # gate blocks [z, i, f, o]: 2 gates a rank, or 1
                want = leaf[:, k * 4 * d // m : (k + 1) * 4 * d // m]
            elif name.endswith("r_gates"):
                want = leaf[:, k : k + 1] if m == 2 else leaf  # 2 or 6 heads do not split 4 ways
            elif name.endswith("w_ff_up") or name == "embed.table":
                want = leaf  # 85, 127 and 521 divide by neither 2 nor 4: the guard keeps them
            elif name.endswith("w_out"):
                n = leaf.shape[0] // m
                want = leaf[k * n : (k + 1) * n]
            else:
                n = leaf.shape[-1] // m
                want = leaf[..., k * n : (k + 1) * n]
            np.testing.assert_array_equal(block, want, err_msg=name)
        if arch == "whisper_medium":
            assert got["vocab"] is None and got["cols"] is None
        else:
            assert got["vocab"] == got["cols"] if arch == "recurrentgemma_2b" else True
            assert got["cols"] is not None


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_engine_on_mesh_matches_one_process(runs, arch):
    ranks, want, _ = runs
    got = {}
    for r in ranks:
        for rid, output in r[(arch, "engine")]["outputs"].items():
            assert got.setdefault(rid, output) == output  # both model ranks agree
    assert got == want[(arch, "engine")]
    assert ranks[0][(arch, "engine")]["metrics"] == {"prefills": 1, "decode_ticks": 3,
                                                     "tokens_out": 8}


def test_norm_split_matches_the_whole_norm(runs):
    """`layers.norm_split` over 4 ranks' channel blocks (RMS, as the
    mLSTM's ``mix_norm`` runs, and a layer norm) against the one-device
    norm of the whole activation, each rank's block."""
    ranks, _, _ = runs
    for r in ranks:
        assert max(r["norm_split"].values()) <= 1e-6, r["norm_split"]
