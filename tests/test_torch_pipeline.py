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
"""

import concurrent.futures
import dataclasses

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


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.normal(size=(PER_STAGE, D, D)) * 0.3).astype(np.float32),
               "b": np.zeros((PER_STAGE, D), np.float32)} for _ in range(N_STAGES)]
    x = rng.normal(size=(8, D)).astype(np.float32)
    toks = np.random.default_rng(1).integers(0, 256, (8, 16)).astype(np.int32)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(distributed.run_ranks, torch_shard_ranks.pipeline_rank, 4, stages, x,
                          toks, timeout=300)
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
    return ranks, dict(tanh=np.asarray(ref), hidden=h.numpy(), logits=logits.numpy(),
                       model=model, params=sum(p.numel() for p in model.parameters()))


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
