"""The FSDP × TP training layout of every family besides the dense one
(`shard_model(serving=False)`, the reference's `param_pspecs`: each
leaf's d_model-like dim over "data", its heads / ff / vocab dim over
"model") trained on 4 gloo CPU ranks, against the JAX reference's jitted
`make_train_step` placed by `param_pspecs` and `opt_state_pspecs` on 4
XLA:CPU host devices (one subprocess a mesh shape), as
tests/test_torch_fsdp.py holds the dense family.

The smoke configs of mixtral-8x7b (AdamW; ``moe_impl`` "gather" and
"local"; float32, and bfloat16 with "gather"), grok-1-314b (Adafactor,
"gather"), internvl2-76b (Adafactor, its vision embeddings split with the
rows), recurrentgemma-2b (float32 and bfloat16), xlstm-125m (and its
"ff" variant, whose sLSTM feed-forward splits over "model") and
whisper-medium (its encoder frames split with the rows, its vocabulary
cut to 521, which does not divide over "model", so its logits stay whole
on a mesh with "data" > 1), on the reference's own weights, one step on
a 4 x 16 batch on a (2, 2) and a (4, 1) ("data", "model") mesh; the two
xLSTM cases also on (1, 4), where its 2 heads do not divide over
"model" and the mLSTM and sLSTM run each rank's own heads, 1, 1, 0 and
0 ("heads"), and the two recurrentgemma-2b cases, whose 2 q heads do
not divide over 4 ranks either, so each rank attends its own q heads
likewise ("q_heads", as on (2, 2), where they divide); on (1, 4) too,
uneven heads with every rank holding one
(`torch_shard_ranks.FAMILY_TRAIN_UNEVEN`): recurrentgemma-2b with 6 q
heads and xlstm-125m with 6 heads at d_model 96; and on (1, 4) the
"whole" attention layout, which serving's flash-decoding takes
(`torch_shard_ranks.FAMILY_TRAIN_WHOLE`: the qwen2.5-3b smoke under
``decode_seq_shard``, q, k and v assembled whole and every head attended
on every rank). The MoE
configs run at capacity factor 0.5 (their smoke configs' 4.0 is
dropless): the reference drops pairs on this batch, and "gather" must
slot them as the reference's jitted step slots the global batch.

Bars, as tests/test_torch_fsdp.py's: the loss, ce, every ``aux/*``,
grad_norm and param_norm within `torch_lm_twins.BARS`, the same bits on
every rank (and ``drop_frac``, a count of pairs, equal to the
reference's in float32); every rank's block of every leaf's gradient
within the grad_norm bar of the leaf's largest |grad| (in bfloat16 and
for xlstm-125m plus the one-process port's own distance from the
reference on the leaf: the mLSTM's exponential gates leave the port's
unsharded float32 gradient up to 2.4 bars from the reference's jitted
one on the "ff" variant, and the reference's own partitions round its
gradient differently); a
leaf whose gradient is zero in exact arithmetic (whisper's key biases: a
bias on every key of a softmax row shifts its scores alike) holds f32
rounding noise on both sides, so the leaf's scale is floored at 1e-3 of
the largest |grad| of the tree; post-step blocks within the train twins'
bars; each optimizer state leaf the block `launch.specs.opt_state_pspecs`
gives it (grok-1's 3-D expert leaves factored over their last two dims).
mixtral-8x7b also trains with its layers stacked (``scan_layers``),
issuing the unrolled step's all-reduce calls and bytes. A negative
control: the port's per-shard slotting (``moe_impl="local"``)
misses the reference's "gather" step on this batch by more than the bar,
so the twin tells the two apart.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model_zoo import get_model as jget_model
from repro_torch import convert
from repro_torch.core import distributed
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.specs import opt_state_pspecs
from repro_torch.models import model_zoo
from repro_torch.optimizer import get_optimizer
from repro_torch.optimizer.base import tree_leaves
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import make_grad_fn
from repro_torch.train.train_state import param_tree

import torch_shard_ranks as R
from torch_lm_twins import BARS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2, 2), (4, 1))
SEED = 3
CASES = R.FAMILY_TRAIN_CASES
# the cases each mesh shape runs: every case on SHAPES, xLSTM's and
# recurrentgemma's on (1, 4) with the uneven heads' cases and the "whole"
# attention layout's
CASES_BY_SHAPE = {**{shape: CASES for shape in SHAPES},
                  (1, 4): tuple(c for c in CASES
                                if c[0] in ("xlstm_125m", "recurrentgemma_2b"))
                  + R.FAMILY_TRAIN_UNEVEN + R.FAMILY_TRAIN_WHOLE}
ALL_CASES = CASES + R.FAMILY_TRAIN_UNEVEN + R.FAMILY_TRAIN_WHOLE
PAIRS = [(shape, case) for shape, cases in CASES_BY_SHAPE.items() for case in cases]
PAIR_IDS = [f"{a}x{b}-" + "-".join(str(c) for c in case if c) for (a, b), case in PAIRS]
MOE_F32 = [c for c in CASES if c[2] is not None and c[1] == "float32"]
# a leaf's gradient scale is at least this share of the tree's largest |grad|
NOISE_FLOOR = 1e-3
# AdamW's first step u = g / (|g| + eps) (eps 1e-8) follows the gradient
# smoothly where |g| is well over eps; an element whose clipped gradient is
# under this is rounding noise that moves u anywhere in -1..1, and its
# post-step value is held to the update's range, 2 lr (chip_smoke.py's
# SHARD_TRAIN_FULL_G, phase 14k's rule)
ADAMW_FULL_G = 9e-8

# the reference's gradient (the step's whole loss, aux terms included) and
# train step, jitted under param_pspecs and opt_state_pspecs on 4 host
# devices shaped as argv[4] ("2x2"), for each case key in argv[6]
# (comma-separated); the gradients, post-step parameters (float32) and
# metrics into argv[5]. A "local" MoE
# case runs with the mesh active, so its MoE layers run shard_map'd
_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed import sharding as shr
from repro.launch import specs as S
from repro.models import layers as L
from repro.models.model_zoo import get_model
from repro.optimizer import get_optimizer
from repro.train import TrainState, make_train_step
from repro.train.step import cross_entropy_loss

path, seed, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
inp = dict(np.load(path))
out = {}

def name(path_):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path_)

shape = tuple(int(n) for n in sys.argv[4].split("x"))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
S._MESH[0] = mesh
toks = jnp.asarray(inp["toks"])
for key in sys.argv[6].split(","):
    arch, dtype, impl, _ = key.split("/")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              **json.loads(str(inp["kw"]))[key])
    if impl != "none":
        cfg = dataclasses.replace(cfg, moe_impl=impl, expert_capacity_factor=float(inp["cf"]))
    if impl == "local":
        L.set_sharding_rules(None, mesh.axis_names, mesh)
    model = get_model(cfg)
    opt = get_optimizer(cfg.optimizer, lr)
    state = TrainState.create(model.init(jax.random.PRNGKey(seed)), opt)
    p_specs = shr.param_pspecs(state.params, mesh)
    o_specs = S.opt_state_pspecs(jax.eval_shape(opt.init, state.params), p_specs)
    place = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t)
    state = jax.device_put(state, TrainState(place(p_specs), place(o_specs),
                                             NamedSharding(mesh, P())))
    batch = {"tokens": toks}
    for k in ("vision_embeds", "encoder_frames"):
        if f"{arch}/{k}" in inp:
            batch[k] = jnp.asarray(inp[f"{arch}/{k}"]).astype(jnp.dtype(dtype))
    batch = jax.device_put(batch, {k: NamedSharding(mesh, shr.batch_pspec(mesh, v.shape[0],
                                                                          v.ndim))
                                   for k, v in batch.items()})

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, aux = model.forward(params, tokens, **extras)
        targets = jnp.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        mask = jnp.ones(tokens.shape, jnp.float32).at[:, -1].set(0.0)
        if cfg.vision_tokens:
            mask = mask.at[:, : cfg.vision_tokens].set(0.0)
        loss = cross_entropy_loss(logits, targets, mask, 1e-4)[0]
        if aux:
            loss = loss + 1e-2 * (aux["load_balance_loss"]
                                  + cfg.router_z_loss * aux["router_z_loss"])
        return loss

    def both(state, batch):
        new, metrics = make_train_step(model, opt)(state, batch)
        return jax.grad(loss_fn)(state.params, batch), new.params, metrics

    grads, new, metrics = jax.jit(both)(state, batch)
    L.clear_sharding_rules()
    for what, tree in (("grad", grads), ("param", new)):
        for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[f"{key}/{what}/{name(p)}"] = np.asarray(leaf, np.float32)
    for k, v in metrics.items():
        out[f"{key}/metric/{k}"] = np.asarray(v, np.float32)
np.savez(sys.argv[5], **out)
"""


def _slack(case) -> bool:
    """Whether ``case``'s gradient bars widen by the one-process port's
    own distance from the reference (the module docstring)."""
    return case[1] == "bfloat16" or case[0] == "xlstm_125m"


def _ckey(case) -> str:
    variant = case[3] if len(case) > 3 else "none"
    return f"{case[0]}/{case[1]}/{case[2] or 'none'}/{variant}"


def _jcfg(case):
    jc = dataclasses.replace(jbase.get_smoke_config(case[0]), dtype=case[1],
                             **R.family_train_kw(case[0], *case[3:]))
    if case[2] is not None:
        jc = dataclasses.replace(jc, moe_impl=case[2], expert_capacity_factor=R.FAMILY_TRAIN_CF)
    return jc


def _tree(case):
    return jax.tree.map(np.asarray, jget_model(_jcfg(case)).init(jax.random.PRNGKey(SEED)))


def _extras() -> dict:
    """Each stub frontend's input for the 4 rows, N(0, 0.02^2) (as
    tests/test_models.py draws whisper's frames), in float32."""
    out = {}
    for arch in {c[0] for c in ALL_CASES}:
        cfg = R.family_train_cfg(arch, "float32")
        rng = np.random.default_rng(SEED + 1)
        if cfg.frontend == "vision_stub":
            shape, name = (4, cfg.vision_tokens, cfg.d_model), "vision_embeds"
        elif cfg.frontend == "audio_stub":
            shape, name = (4, cfg.encoder_seq, cfg.d_model), "encoder_frames"
        else:
            continue
        out[arch] = {name: (rng.standard_normal(shape) * 0.02).astype(np.float32)}
    return out


def _one_process(tree, case, toks, extras) -> dict:
    """The port's one-process gradient of ``case`` on the whole batch, by
    leaf, and its train step's metrics."""
    model = convert.lm_params_from_numpy(tree, R.family_train_cfg(*case), device="cpu")
    opt = get_optimizer(model.cfg.optimizer, R.FSDP_LR)
    state = TrainState.create(model, opt)
    batch = {"tokens": torch.from_numpy(toks)}
    batch.update({k: torch.from_numpy(v).to(model.dtype)
                  for k, v in extras.get(case[0], {}).items()})
    grads = make_grad_fn(model)(state, batch)[3]
    names = {id(p): n for n, p in model.named_parameters()}
    out = {names[id(p)]: g.float().numpy()
           for p, g in zip(tree_leaves(state.params), tree_leaves(grads))}
    metrics = make_train_step(model, opt)(state, batch)[1]
    return dict(grads=out, metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each mesh's 4 ranks' results, each mesh's reference arrays by
    key, the port's one-process gradients and metrics of the `_slack`
    cases)."""
    toks = np.random.default_rng(SEED).integers(0, 256, (4, 16)).astype(np.int32)
    extras = _extras()
    path = tmp_path_factory.mktemp("fsdp_families") / "ref.npz"
    flat = {f"{arch}/{k}": v for arch, d in extras.items() for k, v in d.items()}
    kw = {_ckey(c): R.family_train_kw(c[0], *c[3:]) for c in ALL_CASES}
    np.savez(path, toks=toks, cf=R.FAMILY_TRAIN_CF, kw=json.dumps(kw), **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    outs = [path.with_name(f"ref_{a}x{b}.npz") for a, b in CASES_BY_SHAPE]
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path), str(SEED),
                               str(R.FSDP_LR), f"{a}x{b}", str(o),
                               ",".join(_ckey(c) for c in CASES_BY_SHAPE[(a, b)])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for (a, b), o in zip(CASES_BY_SHAPE, outs)]  # one a mesh, side by side
    trees = {case: _tree(case) for case in ALL_CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = {shape: pool.submit(distributed.run_ranks, R.family_train_rank, 4, shape,
                                      cases, {c: trees[c] for c in cases}, toks, extras,
                                      device_type="cpu", timeout=400)
                   for shape, cases in CASES_BY_SHAPE.items()}
        one = {case: _one_process(trees[case], case, toks, extras)
               for case in ALL_CASES if _slack(case)}
        ranks = {shape: f.result() for shape, f in pending.items()}
    ref = {}
    for shape, proc, o in zip(CASES_BY_SHAPE, procs, outs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        ref[shape] = dict(np.load(o))
    return ranks, ref, one


def _block(whole: np.ndarray, index) -> np.ndarray:
    return whole[tuple(slice(lo, hi) for lo, hi in index)]


def _grad_errors(ranks, ref, one, shape, case, got_case=None) -> list:
    """(error, bar, leaf) of every rank's gradient block of ``got_case``
    (by default ``case``) against the reference's ``case``."""
    rtol = BARS[case[1]][1]
    ckey = _ckey(case)
    tree_max = max(float(np.abs(v).max()) for k, v in ref[shape].items()
                   if k.startswith(f"{ckey}/grad/"))
    out = []
    for r in ranks:
        for name, block in r[got_case or case]["grads"].items():
            whole = ref[shape][f"{ckey}/grad/{name}"]
            want = _block(whole, r[got_case or case]["index"][name])
            bar = rtol * max(float(np.abs(whole).max()), NOISE_FLOOR * tree_max)
            if _slack(case):
                bar += float(np.abs(one[case]["grads"][name] - whole).max())
            out.append((float(np.abs(block - want).max()), bar, name))
    return out


@pytest.mark.parametrize(("shape", "case"), PAIRS, ids=PAIR_IDS)
def test_train_step_matches_reference(runs, shape, case):
    """loss, ce, every aux/*, grad_norm and param_norm within BARS,
    step_ok 1, the same bits on every rank (``drop_frac`` equal to the
    reference's in float32); every rank's post-step blocks within the
    train twins' bars of the reference's jitted step. In bfloat16 the
    reference's jit fuses and rounds otherwise than its own op-by-op
    path, which the port follows (0.017 apart on mixtral's loss here):
    the metrics are also held within BARS of the port's one-process step,
    and the reference's bars widen by that step's distance from it."""
    ranks, refs, one = runs
    ref = refs[shape]
    dtype = case[1]
    key = _ckey(case)
    loss_atol, gnorm_rtol, pnorm_rtol = BARS[dtype]
    first = ranks[shape][0][case]["metrics"]
    aux = sorted(k for k in first if k.startswith("aux/"))
    assert aux == sorted(k[len(key) + 8:] for k in ref if k.startswith(f"{key}/metric/aux/"))
    assert bool(aux) == (case[2] is not None)
    want = {k: float(ref[f"{key}/metric/{k}"]) for k in first}
    slack = {k: 0.0 for k in first}
    if dtype == "bfloat16":
        mine = one[case]["metrics"]
        slack = {k: abs(mine[k] - want[k]) for k in first}
        for k in ("loss", "ce", *aux):
            assert abs(first[k] - mine[k]) <= loss_atol, k
        for k, rtol in (("grad_norm", gnorm_rtol), ("param_norm", pnorm_rtol)):
            np.testing.assert_allclose(first[k], mine[k], rtol=rtol)
    clip = min(1.0, 1.0 / want["grad_norm"])
    adamw = R.family_train_cfg(*case).optimizer == "adamw"
    for r in ranks[shape]:
        got = r[case]["metrics"]
        assert got == first  # every rank took the same branch with the same numbers
        assert got["step_ok"] == want["step_ok"] == 1.0
        for k in ("loss", "ce", *aux):
            assert abs(got[k] - want[k]) <= loss_atol + slack[k], k
        if dtype == "float32" and aux:
            assert got["aux/drop_frac"] == want["aux/drop_frac"]
        for k, rtol in (("grad_norm", gnorm_rtol), ("param_norm", pnorm_rtol)):
            assert abs(got[k] - want[k]) <= rtol * abs(want[k]) + slack[k], k
        assert r[case]["loss"] == got["loss"]
        for name, block in r[case]["params"].items():
            index = r[case]["index"][name]
            want_p = _block(ref[f"{key}/param/{name}"], index)
            err = np.abs(block - want_p)
            if dtype == "bfloat16":
                assert err.max() <= 2.0 ** -8 * np.abs(want_p).max() + 2 * R.FSDP_LR, name
                continue
            small = np.zeros(err.shape, bool)
            if adamw:
                small = clip * np.abs(_block(ref[f"{key}/grad/{name}"], index)) < ADAMW_FULL_G
            assert err[~small].max(initial=0.0) <= 0.05 * R.FSDP_LR, name
            assert err[small].max(initial=0.0) <= 2 * R.FSDP_LR, name


@pytest.mark.parametrize(("shape", "case"), PAIRS, ids=PAIR_IDS)
def test_gradient_blocks_match_reference(runs, shape, case):
    """Every rank's block of every leaf's gradient (before clipping)
    within the grad_norm bar of the leaf's largest |grad| (see the module
    docstring); the blocks tile each leaf."""
    ranks, refs, one = runs
    for err, bar, name in _grad_errors(ranks[shape], refs, one, shape, case):
        assert err <= bar, f"{name}: {err:.3g} > {bar:.3g}"
    cover: dict = {}
    for r in ranks[shape]:
        for name, index in r[case]["index"].items():
            cover.setdefault(name, set()).add(tuple(map(tuple, index)))
    for name, blocks in cover.items():
        n = int(np.prod(refs[shape][f"{_ckey(case)}/grad/{name}"].shape))
        assert sum(int(np.prod([hi - lo for lo, hi in b])) for b in blocks) == n, name


@pytest.mark.parametrize("case", MOE_F32, ids=lambda c: f"{c[0]}-{c[2]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_drops_pairs(runs, shape, case):
    """The MoE cases' batch overflows the capacity: the reference drops
    pairs (its drop_frac, summed over the layers, is above 0), and the
    ranks drop as many."""
    ranks, refs, _ = runs
    want = float(refs[shape][f"{_ckey(case)}/metric/aux/drop_frac"])
    assert want > 0
    assert ranks[shape][0][case]["metrics"]["aux/drop_frac"] == want


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_per_shard_slotting_misses_gather(runs, shape):
    """Negative control: the port's per-shard slotting (``moe_impl=
    "local"``, each data replica's own capacity and cumulative sum) run
    on the same weights and batch misses the reference's "gather" step
    (the global batch's slotting) by more than the bars, in the loss and
    in the gradient blocks: the twin tells the two semantics apart."""
    ranks, refs, _ = runs
    gather, local = ("mixtral_8x7b", "float32", "gather"), ("mixtral_8x7b", "float32", "local")
    loss_atol = BARS["float32"][0]
    got = ranks[shape][0][local]["metrics"]["loss"]
    assert abs(got - float(refs[shape][f"{_ckey(gather)}/metric/loss"])) > loss_atol
    errs = _grad_errors(ranks[shape], refs, {}, shape, gather, got_case=local)
    assert max(err / bar for err, bar, _ in errs) > 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scan_step_collectives_equal_unrolled(runs, shape):
    """mixtral-8x7b with its layers stacked issues, on every rank, the
    all-reduce calls and payload bytes of its unrolled step: each
    layer's slice of a data-split leaf gathered as the layer's leaf is,
    each layer's expert counts and aux sums exchanged as before."""
    for r in runs[0][shape]:
        unrolled = r[("mixtral_8x7b", "float32", "gather")]["collectives"]
        assert unrolled["calls"] > 0
        assert r[("mixtral_8x7b", "float32", "gather", "scan")]["collectives"] == unrolled


@pytest.mark.parametrize("shape", list(CASES_BY_SHAPE), ids=lambda s: f"{s[0]}x{s[1]}")
def test_opt_state_blocks_follow_opt_state_pspecs(runs, shape):
    """Each rank's optimizer state leaves have the blocks opt_state_pspecs
    gives (AdamW's moments the parameter's; Adafactor's row and col its
    spec less one dim, the 3-D expert leaves' over their last two dims);
    the d_model-like dims are split over "data" where it has more than
    one rank, and no rank holds the whole model; the layouts are the
    serving ones'."""
    ranks = runs[0]
    desc = dict(zip(("data", "model"), shape))
    for case in CASES_BY_SHAPE[shape]:
        cfg = R.family_train_cfg(*case)
        meta = model_zoo.build(cfg, torch.device("meta"))
        params = param_tree(meta)
        opt = get_optimizer(cfg.optimizer, R.FSDP_LR)
        shapes = opt.init(params)
        specs = opt_state_pspecs(shapes, tsh.param_pspecs(params, desc), desc)
        whole = sum(int(np.prod(p.shape)) for p in meta.parameters())
        for r in ranks[shape]:
            blocks = tsh.param_shardings(shapes, desc, pspecs=specs, coord=r["coord"])
            want = {}

            def walk(s, b, path=()):
                if isinstance(s, dict):
                    for k in s:
                        walk(s[k], b[k], path + (k,))
                elif isinstance(s, list):
                    for i, (x, y) in enumerate(zip(s, b)):
                        walk(x, y, path + (str(i),))
                else:
                    want[".".join(path)] = tuple(s[b.index].shape)

            walk(shapes, blocks)
            got = r[case]
            assert got["opt_shapes"] == want, case
            assert bool(got["fsdp"]) == (shape[0] > 1) and got["held"] < whole, case
            if case[0] == "whisper_medium" and shape[1] > 1:  # 521 does not divide
                assert got["logits"] is None  # the logits stay whole
            if case[0] == "grok_1_314b":
                assert got["fsdp"]["layers.0.moe.w_gate"] == (1, 64)
                assert got["opt_shapes"]["layers.0.moe.w_gate.row"] == (4, 64 // shape[0])
                assert got["opt_shapes"]["layers.0.moe.w_gate.col"] == (4, 192 // shape[1])
            if case[3:] == ("scan",):  # (L, E, D, F): d_model is dim 2 of the stack
                assert got["fsdp"]["layers.moe.w_gate"] == (2, 64)
            if case[0] == "xlstm_125m" and shape[1] > 1:  # each rank's heads, even or not
                assert got["layout"] == {"mlstm": "heads", "slstm": "heads",
                                         "slstm_ffn": "ff" if case[3:] == ("ff",)
                                         else "replicated"}
            if shape[1] > 1 and case[0] == "recurrentgemma_2b":
                # 1 kv head: each rank attends its own q heads, on 2 ranks one
                # each, on 4 unevenly (1, 1, 0, 0; 2, 2, 1, 1 of 6)
                assert got["attn"] == "q_heads" and got["layout"] == {"lru": "channels"}
            if case[3:] == ("seq_shard",):  # flash-decoding's layout: every head on every rank
                assert got["attn"] == "whole"
