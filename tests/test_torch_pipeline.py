"""GPipe over "pod" (`distributed.pipeline`) on 4 gloo CPU ranks, a
(4, 1, 1) ("pod", "data", "model") mesh, against the JAX reference.

The reference test's stack (tests/test_distributed.py,
TestPipelineParallel): 4 stages of 2 layers ``tanh(x @ w + b)``, D = 16,
8 rows in 4 microbatches, each stage holding only its block of the
stage-stacked params: within 1e-5 of the reference's sequential result
on every rank. Then `transformer_stage_fn` over a float32 qwen2.5-3b
smoke of 4 layers as 4 stages of 1 (`stage_model`: each rank keeps its
layer and the embedding), 8 x 16 tokens in 4 microbatches: the hidden
states, and the logits through the final norm and unembedding, within
1e-5 of the port's one-process model.

The backward: the gradients of one loss, ``sum(y * c)`` for a seeded
``c`` on the pipeline's output (every rank takes it), on every leaf a
stage holds and on the input, held against ``jax.grad`` of the
reference's `make_pipeline_forward` over 8 host devices (a (4, 2, 1)
mesh, as the reference's test runs it, in a subprocess) and of the
reference's sequential stack, each within 1e-5 of the leaf's largest
|grad|: the tanh stack's, and the qwen smoke's on the reference's own
weights (`stage_model(params=...)`; each stage's layer and the
embedding table, whose cotangent every stage holds). A gradient scaled
by the stage count (a plain all-reduce in the broadcast's backward)
fails by 3 x the largest |grad|. On 8 ranks, a (4, 2, 1) mesh, each
data replica runs half the tanh stack's batch: its stage's gradients,
summed over "data", are jax.grad's of the whole batch. On the same 8
ranks, a (4, 1, 2) mesh, the qwen smoke's stages run tensor-parallel
(each rank holding its "model" block of its stage's layer and of the
table): every block's gradient is its slice of jax.grad's.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import distributed
from repro_torch.models import layers as L
from repro_torch.models import model_zoo
from repro_torch.models.transformer import embed_tokens, unembed

import torch_shard_ranks

D, N_STAGES, PER_STAGE = 16, 4, 2
GRAD_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# jax.grad of the reference's pipeline and of its sequential stack, on the
# inputs the test saves to argv[1]; the gradients back into argv[1]
_REFERENCE = r"""
import sys, dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.distributed.pipeline import make_pipeline_forward, stack_stage_params, transformer_stage_fn
from repro.models import transformer as T
from repro.models.model_zoo import get_model

path = sys.argv[1]
inp = dict(np.load(path))
mesh = Mesh(np.array(jax.devices()).reshape(4, 2, 1), ("pod", "data", "model"))
out = {}

def pipe(layer_fn, per):
    return make_pipeline_forward(transformer_stage_fn(layer_fn, per), mesh, n_stages=4,
                                 n_microbatches=4)

def tanh_layer(lp, x):
    return jnp.tanh(x @ lp["w"] + lp["b"])

stacked = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
cot = jnp.asarray(inp["cot_tanh"])
fwd = pipe(tanh_layer, 2)

def seq_tanh(p, x):
    for s in range(4):
        for l in range(2):
            x = tanh_layer({"w": p["w"][s, l], "b": p["b"][s, l]}, x)
    return x

for name, f in (("pipe", fwd), ("seq", seq_tanh)):
    with mesh:
        g = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) * cot), argnums=(0, 1)))(
            stacked, jnp.asarray(inp["x"]))
    out[f"{name}_tanh_w"], out[f"{name}_tanh_b"] = np.asarray(g[0]["w"]), np.asarray(g[0]["b"])
    out[f"{name}_tanh_x"] = np.asarray(g[1])

cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32", num_layers=4)
params = get_model(cfg).init(jax.random.PRNGKey(0))
toks = jnp.asarray(inp["toks"])
cot = jnp.asarray(inp["cot_qwen"])

def block(lp, h):
    pos = jnp.broadcast_to(jnp.arange(h.shape[1], dtype=jnp.int32), h.shape[:2])
    return T._layer_fn(lp, h, pos, cfg)[0]

fwd = pipe(block, 1)
layers = stack_stage_params([jax.tree.map(lambda a: a[None], lp) for lp in params["layers"]])

def seq_qwen(layers, x):
    for s in range(4):
        x = block(jax.tree.map(lambda a: a[s, 0], layers), x)
    return x

for name, f in (("pipe", fwd), ("seq", seq_qwen)):
    def loss(layers, table):
        x = T.embed_tokens({"embed": {"table": table}}, toks, cfg)
        return jnp.sum(f(layers, x) * cot)
    with mesh:
        g_layers, g_table = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            layers, params["embed"]["table"])
    out[f"{name}_qwen_embed.table"] = np.asarray(g_table)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(g_layers):
        key = ".".join(str(k.key) for k in path_)
        for s in range(4):
            out[f"{name}_qwen_layers.{s}.{key}"] = np.asarray(leaf[s, 0])
np.savez(path, **out)
"""


def _reference_grads(path, stages, x, toks, cot) -> subprocess.Popen:
    np.savez(path, w=np.stack([s["w"] for s in stages]), b=np.stack([s["b"] for s in stages]),
             x=x, toks=toks, cot_tanh=cot["tanh"], cot_qwen=cot["qwen"])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.normal(size=(PER_STAGE, D, D)) * 0.3).astype(np.float32),
               "b": np.zeros((PER_STAGE, D), np.float32)} for _ in range(N_STAGES)]
    x = rng.normal(size=(8, D)).astype(np.float32)
    toks = np.random.default_rng(1).integers(0, 256, (8, 16)).astype(np.int32)
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32", num_layers=4)
    crng = np.random.default_rng(5)
    cot = {"tanh": crng.normal(size=(8, D)).astype(np.float32),
           "qwen": crng.normal(size=(8, 16, cfg.d_model)).astype(np.float32)}
    from repro.configs import base as jbase
    from repro.models.model_zoo import get_model as jget_model
    import jax

    jcfg = dataclasses.replace(jbase.get_smoke_config("qwen2_5_3b"), dtype="float32",
                               num_layers=4)
    tree = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("grads") / "grads.npz"
    proc = _reference_grads(path, stages, x, toks, cot)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(distributed.run_ranks, torch_shard_ranks.pipeline_rank, 4, stages, x,
                          toks, tree, cot, device_type="cpu", timeout=300)
    ref = jnp.asarray(x)
    for s in stages:
        for layer in range(PER_STAGE):
            ref = jnp.tanh(ref @ s["w"][layer] + s["b"][layer])
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32", num_layers=4)
    model = model_zoo.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits, _ = model.forward(t)
        h = embed_tokens(model, t)
        positions = torch.arange(16, dtype=torch.int32).expand(8, 16)
        for lp in model.layers:
            h = model._block(lp, h, positions, cfg.expert_capacity_factor)[0]
    ranks = pending.result()
    pool.shutdown()
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return ranks, dict(tanh=np.asarray(ref), hidden=h.numpy(), logits=logits.numpy(),
                       model=model, params=sum(p.numel() for p in model.parameters()),
                       grads=dict(np.load(path)), tanh_inputs=(stages, x, cot["tanh"]),
                       qwen_inputs=(toks, tree, cot["qwen"]))


@pytest.fixture(scope="module")
def data_runs(runs):
    """The tanh stack's backward on 8 gloo ranks, a (4, 2, 1) mesh, then the
    qwen smoke's tensor-parallel stages on (4, 1, 2)."""
    stages, x, cot = runs[1]["tanh_inputs"]
    return distributed.run_ranks(torch_shard_ranks.pipeline_data_rank, 8, stages, x, cot,
                                 *runs[1]["qwen_inputs"], device_type="cpu", timeout=300)


def test_gpipe_matches_sequential(runs):
    ranks, want = runs
    for r in ranks:
        assert r["stage_rows"] == (1, PER_STAGE, D, D)  # each stage holds its block
        np.testing.assert_allclose(r["tanh"], want["tanh"], atol=1e-5, rtol=0)


def test_transformer_stages_match_one_process(runs):
    ranks, want = runs
    model = want["model"]
    for r in ranks:
        np.testing.assert_allclose(r["hidden"], want["hidden"], atol=1e-5, rtol=0)
        assert r["held"] < want["params"]  # no stage holds every layer
        with torch.no_grad():
            x = L.rms_norm(model.final_norm, torch.from_numpy(r["hidden"]), model.cfg.norm_eps)
            logits = unembed(model, x)
        np.testing.assert_allclose(logits.numpy(), want["logits"], atol=1e-5, rtol=0)


def test_production_mesh_needs_its_world(runs):
    """`launch.mesh.make_production_mesh` refuses a 4-rank world (the
    stage mesh came from `make_mesh_for`)."""
    ranks, _ = runs
    for r in ranks:
        assert r["refused"] == ["need 256 ranks for mesh (16, 16), have 4",
                                "need 512 ranks for mesh (2, 16, 16), have 4"]


def test_pipeline_checks_its_mesh():
    """A stage count other than the pod axis's size is refused."""
    from repro_torch.distributed.pipeline import make_pipeline_forward

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.zeros(2, 1, 1)

    with pytest.raises(ValueError, match="pod axis size 2"):
        make_pipeline_forward(lambda p, x, s: x, _Mesh(), n_stages=4, n_microbatches=4)


def _close(got, want, what):
    """Within GRAD_RTOL of the leaf's largest |grad|."""
    assert got.shape == want.shape, what
    bar = GRAD_RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{what}: {err:.3g} > {bar:.3g}"


@pytest.mark.parametrize("against", ("pipe", "seq"))
def test_tanh_gradients_match_jax_grad(runs, against):
    """Each stage's w and b gradients and the input's, on every rank,
    against jax.grad of the reference's pipeline and of its sequential
    stack."""
    ranks, want = runs
    g = want["grads"]
    for s, r in enumerate(ranks):
        got = r["grad_tanh"]
        _close(got["w"], g[f"{against}_tanh_w"][s], f"stage {s} w")
        _close(got["b"], g[f"{against}_tanh_b"][s], f"stage {s} b")
        _close(got["x"], g[f"{against}_tanh_x"], f"rank {s} x")


@pytest.mark.parametrize("against", ("pipe", "seq"))
def test_transformer_stage_gradients_match_jax_grad(runs, against):
    """The qwen smoke's stages train: every leaf of each stage's layer, and
    the embedding table on every stage, against jax.grad."""
    ranks, want = runs
    g = want["grads"]
    for s, r in enumerate(ranks):
        got = r["grad_qwen"]
        prefix = f"{against}_qwen_"
        mine = {k[len(prefix):] for k in g if k.startswith(f"{prefix}layers.{s}.")}
        assert set(got) == mine | {"embed.table"}  # the stage's layer and the table
        for name, arr in got.items():
            _close(arr, g[f"{against}_qwen_{name}"], name)


@pytest.mark.parametrize("against", ("pipe", "seq"))
def test_data_replica_gradients_match_jax_grad(runs, data_runs, against):
    """On a (4, 2, 1) mesh each data replica runs half the batch; its
    stage's w and b gradients, summed over "data", are jax.grad's of the
    whole batch's loss, and its rows of the input's cotangent are its
    own."""
    g = runs[1]["grads"]
    assert sorted((r["coord"]["pod"], r["coord"]["data"]) for r in data_runs) == [
        (s, d) for s in range(N_STAGES) for d in range(2)]
    for r in data_runs:
        s, (lo, hi) = r["coord"]["pod"], r["rows"]
        _close(r["w"], g[f"{against}_tanh_w"][s], f"stage {s} w")
        _close(r["b"], g[f"{against}_tanh_b"][s], f"stage {s} b")
        _close(r["x"], g[f"{against}_tanh_x"][lo:hi], f"rows {lo}-{hi} x")


@pytest.mark.parametrize("against", ("pipe", "seq"))
def test_tensor_parallel_stage_gradients_match_jax_grad(runs, data_runs, against):
    """On a (4, 1, 2) mesh each stage's layer runs tensor-parallel over
    "model" (the "heads" layout, its MLP ff-split, the table
    vocab-split): every leaf's block gradient on both model ranks of
    every stage, and the table's on every stage, is its slice of
    jax.grad's whole gradient."""
    g = runs[1]["grads"]
    assert sorted((r["tp"]["coord"]["pod"], r["tp"]["coord"]["model"]) for r in data_runs) == [
        (s, m) for s in range(N_STAGES) for m in range(2)]
    for r in data_runs:
        tp = r["tp"]
        s = tp["coord"]["pod"]
        assert tp["attn"] == "heads"
        prefix = f"{against}_qwen_"
        mine = {k[len(prefix):] for k in g if k.startswith(f"{prefix}layers.{s}.")}
        assert set(tp["grads"]) == mine | {"embed.table"}
        split = 0
        for name, (got, index) in tp["grads"].items():
            want = g[f"{prefix}{name}"]
            block = want[tuple(slice(lo, hi) for lo, hi in index)]
            split += block.shape != want.shape
            _close(got, block, f"stage {s} model {tp['coord']['model']} {name}")
        assert split >= 5  # wq, wk, wv, wo, the MLP's three and the table are blocks
