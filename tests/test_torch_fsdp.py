"""The FSDP × TP training layout (`shard_model(serving=False)`, the
reference's `param_pspecs`: each leaf's d_model-like dim over "data",
its heads / ff / vocab dim over "model") trained on 4 gloo CPU ranks,
against the JAX reference's jitted `make_train_step` placed by
`param_pspecs` and `opt_state_pspecs` on 4 XLA:CPU host devices (in a
subprocess, as tests/test_torch_pipeline.py runs its host devices).

qwen2.5-3b's smoke config (AdamW) and llama3-405b's (Adafactor), in
float32 and bfloat16, and qwen2.5-3b's in float32 under ``scan_layers``
(each per-layer leaf stacked (L, ...), each layer's slice gathered over
"data" where its block reads it), on the reference's own weights, one step on a
4 x 16 batch (each data replica its rows) on a (2, 2) and a (4, 1)
("data", "model") mesh, one spawn a mesh: the loss, ce, grad_norm and
param_norm within `torch_lm_twins.BARS` (the same bits on every rank,
so every rank takes the guard's branch), every rank's block of every
leaf's gradient within the grad_norm bar of the leaf's largest |grad|
(a gradient summed once too often over an axis fails by the leaf's
whole size; in bfloat16 the bar adds the one-process port's own distance
from the reference on that leaf, 0.028 of the largest |grad| at worst on
these weights, since op-by-op and jit-fused bf16 round the intermediates
apart), its post-step block within the train twins' bars
(`torch_lm_twins.check_train_step`), and each optimizer state leaf the
block `launch.specs.opt_state_pspecs` gives it. Also
`opt_state_pspecs` against the reference's for every configuration and
both optimizers on mesh descriptions, as tests/test_torch_sharding.py
holds `param_pspecs`. The stacked step issues the unrolled step's
all-reduce calls and bytes. And the first case on a 1 x 4 mesh (in the
(2, 2) spawn), where qwen2.5-3b's ranks attend their own q heads
("q_heads"), under the (2, 2) step's bars.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.model_zoo import get_model as jget_model
from repro.optimizer import get_optimizer as jget_optimizer
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import distributed
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.specs import opt_state_pspecs
from repro_torch.models import model_zoo
from repro_torch.optimizer import get_optimizer
from repro_torch.optimizer.base import tree_leaves
from repro_torch.train import TrainState
from repro_torch.train.step import make_grad_fn
from repro_torch.train.train_state import param_tree

import torch_shard_ranks
from torch_lm_twins import BARS
from torch_shard_ranks import FSDP_CASES, FSDP_LR, FSDP_Q_HEADS, FSDP_REMATS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2, 2), (4, 1))
SEED = 3
CASE_IDS = ["-".join(c) for c in FSDP_CASES]

# the reference's gradient and train step, jitted under param_pspecs and
# opt_state_pspecs on 4 host devices shaped as argv[4] ("2x2"), for every
# case; the gradients, post-step parameters (float32) and metrics into
# argv[5]
_REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed import sharding as shr
from repro.launch import specs as S
from repro.models.model_zoo import get_model
from repro.optimizer import get_optimizer
from repro.train import TrainState, make_train_step
from repro.train.step import cross_entropy_loss

path, seed, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
inp = dict(np.load(path))
cases = [tuple(c.split("/")) for c in inp["cases"]]
out = {}

def name(path_):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path_)

for shape in [tuple(int(n) for n in sys.argv[4].split("x"))]:
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    S._MESH[0] = mesh
    toks = jnp.asarray(inp["toks"])
    for case in cases:
        arch, dtype = case[:2]
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                  scan_layers=case[2:] == ("scan",))
        model = get_model(cfg)
        opt = get_optimizer(cfg.optimizer, lr)
        state = TrainState.create(model.init(jax.random.PRNGKey(seed)), opt)
        p_specs = shr.param_pspecs(state.params, mesh)
        o_specs = S.opt_state_pspecs(jax.eval_shape(opt.init, state.params), p_specs)
        place = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t)
        state = jax.device_put(state, TrainState(place(p_specs), place(o_specs),
                                                 NamedSharding(mesh, P())))
        batch = jax.device_put({"tokens": toks},
                               {"tokens": NamedSharding(mesh, shr.batch_pspec(mesh, toks.shape[0]))})

        def loss_fn(params, batch):
            tokens = batch["tokens"]
            logits, _ = model.forward(params, tokens)
            targets = jnp.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
            mask = jnp.ones(tokens.shape, jnp.float32).at[:, -1].set(0.0)
            return cross_entropy_loss(logits, targets, mask, 1e-4)[0]

        def both(state, batch):
            new, metrics = make_train_step(model, opt)(state, batch)
            return jax.grad(loss_fn)(state.params, batch), new.params, metrics

        grads, new, metrics = jax.jit(both)(state, batch)
        key = f"{shape[0]}x{shape[1]}/" + "/".join(case)
        for what, tree in (("grad", grads), ("param", new)):
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
                out[f"{key}/{what}/{name(p)}"] = np.asarray(leaf, np.float32)
        for k, v in metrics.items():
            out[f"{key}/metric/{k}"] = np.asarray(v, np.float32)
np.savez(sys.argv[5], **out)
"""


def _tree(arch: str, dtype: str, variant=None):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype,
                             **torch_shard_ranks.FSDP_VARIANTS.get(variant, {}))
    return jax.tree.map(np.asarray, jget_model(jc).init(jax.random.PRNGKey(SEED)))


def _one_process_grads(tree, case, toks) -> dict:
    """The port's one-process gradient of ``case`` on the whole batch."""
    model = convert.lm_params_from_numpy(tree, torch_shard_ranks.fsdp_cfg(*case), device="cpu")
    state = TrainState.create(model, get_optimizer(model.cfg.optimizer, FSDP_LR))
    grads = make_grad_fn(model)(state, {"tokens": torch.from_numpy(toks)})[3]
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g.float().numpy()
            for p, g in zip(tree_leaves(state.params), tree_leaves(grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each mesh's 4 ranks' results, the reference's by key, the port's
    one-process gradients by case)."""
    toks = np.random.default_rng(SEED).integers(0, 256, (4, 16)).astype(np.int32)
    path = tmp_path_factory.mktemp("fsdp") / "ref.npz"
    np.savez(path, toks=toks, cases=np.array(["/".join(c) for c in FSDP_CASES]))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    outs = [path.with_name(f"ref_{a}x{b}.npz") for a, b in SHAPES]
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path), str(SEED),
                               str(FSDP_LR), f"{a}x{b}", str(o)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for (a, b), o in zip(SHAPES, outs)]  # one a mesh, side by side
    trees = {case: _tree(*case) for case in FSDP_CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = {shape: pool.submit(distributed.run_ranks, torch_shard_ranks.fsdp_rank, 4,
                                      shape, trees, toks, device_type="cpu", timeout=300)
                   for shape in SHAPES}
        one = {case: _one_process_grads(trees[case], case, toks) for case in FSDP_CASES}
        ranks = {shape: f.result() for shape, f in pending.items()}
    ref = {}
    for proc, o in zip(procs, outs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        ref.update(np.load(o))
    return ranks, ref, one


def _key(shape, case) -> str:
    return f"{shape[0]}x{shape[1]}/" + "/".join(case)


def _block(whole: np.ndarray, index) -> np.ndarray:
    return whole[tuple(slice(lo, hi) for lo, hi in index)]


@pytest.mark.parametrize("case", FSDP_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_step_matches_reference(runs, shape, case):
    """loss, ce, grad_norm and param_norm within BARS, step_ok 1, the
    same bits on every rank; every rank's post-step blocks within the
    train twins' bars of the reference's jitted step."""
    ranks, ref, _ = runs
    _check_step([r[case] for r in ranks[shape]], ref, _key(shape, case), case[1])


def _check_step(results, ref, key: str, dtype: str) -> None:
    """`test_train_step_matches_reference`'s checks of the ranks'
    ``results`` of one case against the reference's entries ``key``."""
    loss_atol, gnorm_rtol, pnorm_rtol = BARS[dtype]
    first = results[0]["metrics"]
    for res in results:
        got = res["metrics"]
        assert got == first  # every rank took the same branch with the same numbers
        assert got["step_ok"] == float(ref[f"{key}/metric/step_ok"]) == 1.0
        for k in ("loss", "ce"):
            assert abs(got[k] - float(ref[f"{key}/metric/{k}"])) <= loss_atol, k
        np.testing.assert_allclose(got["grad_norm"], float(ref[f"{key}/metric/grad_norm"]),
                                   rtol=gnorm_rtol)
        np.testing.assert_allclose(got["param_norm"], float(ref[f"{key}/metric/param_norm"]),
                                   rtol=pnorm_rtol)
        assert res["loss"] == got["loss"]
        for name, block in res["params"].items():
            want = _block(ref[f"{key}/param/{name}"], res["index"][name])
            bar = (0.05 * FSDP_LR if dtype == "float32"
                   else 2.0 ** -8 * np.abs(want).max() + 2 * FSDP_LR)
            assert np.abs(block - want).max() <= bar, name


@pytest.mark.parametrize("case", FSDP_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gradient_blocks_match_reference(runs, shape, case):
    """Every rank's block of every leaf's gradient (before clipping), the
    data-split leaves summed over "data" by their gather's backward and
    the replicated ones by the step, within the grad_norm bar of the
    leaf's largest |grad| (in bfloat16 plus the one-process port's own
    distance from the reference on the leaf); the blocks tile each
    leaf."""
    ranks, ref, one = runs
    _check_grads([r[case] for r in ranks[shape]], ref, _key(shape, case), case, one)


def _check_grads(results, ref, key: str, case, one) -> None:
    """`test_gradient_blocks_match_reference`'s checks of the ranks'
    ``results`` of ``case`` against the reference's entries ``key``."""
    rtol = BARS[case[1]][1]
    cover: dict = {}
    for res in results:
        for name, block in res["grads"].items():
            whole = ref[f"{key}/grad/{name}"]
            want = _block(whole, res["index"][name])
            bar = rtol * float(np.abs(whole).max())
            if case[1] == "bfloat16":
                bar += float(np.abs(one[case][name] - whole).max())
            err = float(np.abs(block - want).max())
            assert err <= bar, f"{name}: {err:.3g} > {bar:.3g}"
            cover.setdefault(name, set()).add(tuple(map(tuple, res["index"][name])))
    for name, blocks in cover.items():
        n = int(np.prod(ref[f"{key}/grad/{name}"].shape))
        assert sum(int(np.prod([hi - lo for lo, hi in b])) for b in blocks) == n, name


def test_q_heads_step_matches_reference(runs):
    """The first case on 1 x 4 (run in the (2, 2) spawn): qwen2.5-3b's
    smoke attends each rank's own q head against the assembled kv head it
    reads ("q_heads"); its step's metrics and post-step blocks, and its
    gradient blocks, under the (2, 2) step's bars of the reference's
    (2, 2) step (the same batch and weights)."""
    ranks, ref, one = runs
    case = FSDP_CASES[0]
    results = [r[FSDP_Q_HEADS[1]] for r in ranks[FSDP_Q_HEADS[0]]]
    assert all(res["attn"] == "q_heads" and not res["fsdp"] for res in results)
    _check_step(results, ref, _key(FSDP_Q_HEADS[0], case), case[1])
    _check_grads(results, ref, _key(FSDP_Q_HEADS[0], case), case, one)


@pytest.mark.parametrize("remat", FSDP_REMATS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_remat_gradients_match(runs, shape, remat):
    """Under activation checkpointing each block's gathers and sums run
    again in the backward ("full"; "dots" keeps the weight products, so
    a sum in place of a kept product would count it twice): every
    gradient block within 1e-6 of the leaf's largest |grad| of the
    step without it (float32, the first case)."""
    ranks = runs[0]
    case = FSDP_CASES[0]
    for r in ranks[shape]:
        for name, got in r[("remat", remat)].items():
            want = r[case]["grads"][name]
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_opt_state_blocks_follow_opt_state_pspecs(runs, shape):
    """Each rank's optimizer state leaves have the blocks opt_state_pspecs
    gives (AdamW's moments the parameter's, Adafactor's row and col its
    spec less one dim); the d_model-like dims are split over "data" and
    no rank holds the whole model."""
    ranks = runs[0]
    desc = dict(zip(("data", "model"), shape))
    for case in FSDP_CASES:
        cfg = torch_shard_ranks.fsdp_cfg(*case)
        params = param_tree(model_zoo.build(cfg, torch.device("meta")))
        opt = get_optimizer(cfg.optimizer, FSDP_LR)
        shapes = opt.init(params)
        specs = opt_state_pspecs(shapes, tsh.param_pspecs(params, desc), desc)
        whole = sum(int(np.prod(p.shape)) for p in model_zoo.build(
            cfg, torch.device("meta")).parameters())
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
            assert r[case]["opt_shapes"] == want, case
            wq = "layers.attn.wq" if cfg.scan_layers else "layers.0.attn.wq"
            assert wq in r[case]["fsdp"] and "lm_head.w" in r[case]["fsdp"]
            assert r[case]["held"] < whole
            assert r[case]["attn"] == "heads"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scan_step_collectives_equal_unrolled(runs, shape):
    """The stacked step gathers each layer's slice of a data-split leaf
    where the unrolled step gathers the layer's leaf, and sums the
    replicated gradients in one flattened all-reduce an axis either way
    (AdamW reduces nothing): on every rank the same all-reduce calls and
    payload bytes a step."""
    for r in runs[0][shape]:
        unrolled = r[("qwen2_5_3b", "float32")]["collectives"]
        assert unrolled["calls"] > 0
        assert r[("qwen2_5_3b", "float32", "scan")]["collectives"] == unrolled


class _Mesh:
    """A mesh description the reference's rules read (axis names, shape)."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _flat(tree, path=()) -> dict:
    """{dotted path: spec tuple} of a tree of port PSpecs."""
    if isinstance(tree, tsh.PSpec):
        return {".".join(path): tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (str(key),)).items()}
    return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, path + (str(i),)).items()}


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in leaves}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_opt_state_pspecs_equal(arch):
    """`launch.specs.opt_state_pspecs` equals the reference's for the
    configuration at its smoke size and at its full width, with AdamW
    and with Adafactor, on (2, 2), (4, 1) and (16, 16) ("data", "model")
    meshes, leaf by leaf. The full configurations keep at most 8 layers
    (2 encoder layers): every kind of layer is among them (xlstm-125m's
    sLSTM is its 8th), and deeper layers repeat their shapes."""
    for get in ("get_smoke_config", "get_config"):
        jc, tc = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
        cut = dict(num_layers=min(jc.num_layers, 8), encoder_layers=min(jc.encoder_layers, 2))
        jc, tc = dataclasses.replace(jc, **cut), dataclasses.replace(tc, **cut)
        shapes = jax.eval_shape(jget_model(jc).init, jax.random.PRNGKey(0))
        params = param_tree(model_zoo.build(tc, torch.device("meta")))
        for opt in ("adamw", "adafactor"):
            j_opt = jax.eval_shape(jget_optimizer(opt, 1e-3).init, shapes)
            t_opt = get_optimizer(opt, 1e-3).init(params)
            for sizes in ((2, 2), (4, 1), (16, 16)):
                names = ("data", "model")
                ref_mesh, desc = _Mesh(names, sizes), dict(zip(names, sizes))
                saved, jspecs._MESH[0] = jspecs._MESH[0], ref_mesh
                try:
                    want = _ref_flat(jspecs.opt_state_pspecs(
                        j_opt, jsh.param_pspecs(shapes, ref_mesh)))
                finally:
                    jspecs._MESH[0] = saved
                got = _flat(opt_state_pspecs(t_opt, tsh.param_pspecs(params, desc), desc))
                assert got == want, (get, opt, sizes)
