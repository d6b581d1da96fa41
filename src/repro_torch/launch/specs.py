"""The dry-run's cases: one rank's real step on the meta device, and the
optimizer-state placement of the FSDP × TP training layout.

Port of `repro.launch.specs`. `input_specs` gives a cell's model inputs
as `TensorSpec` s (the reference's ShapeDtypeStructs). `build_case`
builds one (arch × shape) cell on one rank of a mesh, the reference's
production `VirtualMesh` as `repro_torch.launch.dryrun` runs it: the
rank-local model placed by `distributed.shard_model` on the "meta"
device (shapes only, nothing allocated), under `param_pspecs` (the FSDP
× TP layout the reference compiles every cell under) or, at decode
under ``profile="opt"``, `serving_param_pspecs`; the optimizer state on
its blocks, placed by `opt_state_pspecs`; the rank's rows of each input.
The case's ``fn`` is the port's own `make_train_step`, ``prefill`` or
``decode_step``, not a copy, so what it runs is what a rank of the mesh
runs, its collectives recorded by the mesh's groups.

`opt_state_pspecs` shards the optimizer state congruent with its
parameters, so a rank holds the moments of exactly the blocks it holds
of the parameters (`distributed.sharding.param_pspecs`). The mesh is an
argument here, a `DeviceMesh` or any mesh description
`sharding.mesh_spec` takes, where the reference reads a module global
its ``build_case`` sets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, Shape, get_config
from repro_torch.distributed.sharding import (
    PSpec, _axis_size, _names, _shape, batch_pspec, guard_pspec, mesh_spec,
)
from repro_torch.models.base import TensorSpec, extra_input_shapes

__all__ = ["DryRunCase", "build_case", "input_specs", "make_case", "opt_state_pspecs"]


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Model inputs for one (arch × shape) cell, as `TensorSpec` s of the
    global batch: train takes the tokens and the frontend stubs, prefill
    the tokens and whisper's encoder frames, decode one new token a row
    (against a ``seq_len``-deep cache)."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"token": TensorSpec((b,), torch.int32)}
    d = {"tokens": TensorSpec((b, shape.seq_len), torch.int32)}
    extras = extra_input_shapes(cfg, b, shape.seq_len)
    if shape.kind == "prefill":
        extras = {k: v for k, v in extras.items() if k == "encoder_frames"}
    d.update(extras)
    return d


@dataclasses.dataclass
class DryRunCase:
    """One cell on one rank: ``fn(*args)`` runs the rank's step on the
    meta device (``args`` hold the rank's rows of each input, and the
    train state or the decode cache); ``model`` is the rank-local model,
    ``state`` its `TrainState` (train cells; None otherwise) and
    ``model_flops`` the useful FLOPs of the whole step on the global
    batch: 6 N_active tokens to train, 2 N_active tokens to prefill,
    2 N_active a row to decode."""

    name: str
    fn: Callable
    args: tuple
    model: Any
    state: Any = None
    model_flops: float = 0.0


def _rank_rows(spec: TensorSpec, mesh) -> tuple:
    """``spec``'s shape with dim 0 this rank's rows: split over the data
    axes as `batch_pspec` splits the batch (whole where it does not
    divide)."""
    lead = batch_pspec(mesh, spec.shape[0])[0]
    return (spec.shape[0] // _axis_size(mesh_spec(mesh), lead),) + tuple(spec.shape[1:])


def make_case(cfg: ModelConfig, mesh, kind: str, inputs: Mapping, *, max_len: int = 0,
              lr: float = 3e-4, serving: bool = False, name: str = "",
              model_flops: float = 0.0) -> DryRunCase:
    """A `DryRunCase` of ``cfg`` on this rank of ``mesh`` (a `VirtualMesh`:
    the meta device): ``kind`` "train", "prefill" or "decode";
    ``inputs`` the global batch's `TensorSpec` s (`input_specs`, or a
    batch of the caller's); ``max_len`` the cache depth of prefill and
    decode; ``serving`` places the parameters by `serving_param_pspecs`
    (else `param_pspecs`)."""
    from repro_torch.core.distributed import mesh_device
    from repro_torch.distributed import shard_model

    device = mesh_device(mesh)
    model = shard_model(cfg, mesh, serving=serving)
    local = {k: torch.empty(_rank_rows(v, mesh), dtype=v.dtype, device=device)
             for k, v in inputs.items()}
    if kind == "train":
        from repro_torch.optimizer import get_optimizer
        from repro_torch.train import TrainState, make_train_step

        optimizer = get_optimizer(cfg.optimizer, lr)
        state = TrainState.create(model, optimizer)
        return DryRunCase(name=name, fn=make_train_step(model, optimizer), args=(state, local),
                          model=model, state=state, model_flops=model_flops)
    if kind == "prefill":
        extras = {k: v for k, v in local.items() if k != "tokens"}

        def prefill_fn(tokens):
            return model.prefill(tokens, max_len, **extras)

        return DryRunCase(name=name, fn=prefill_fn, args=(local["tokens"],), model=model,
                          model_flops=model_flops)
    if kind != "decode":
        raise ValueError(f"unknown cell kind {kind!r}")
    cache = model.init_cache(local["token"].shape[0], max_len)
    return DryRunCase(name=name, fn=model.decode_step, args=(cache, local["token"]), model=model,
                      model_flops=model_flops)


def build_case(arch: str, shape_name: str, mesh, *, lr: float = 3e-4,
               cfg: ModelConfig = None, profile: str = "baseline") -> DryRunCase:
    """The (arch × shape) cell on this rank of ``mesh`` (the reference's
    ``build_case``). ``profile`` "baseline" places every cell under the
    FSDP × TP layout; "opt" makes the reference's §Perf changes: local
    MoE dispatch at train and decode, flash-decoding where the kv heads
    do not divide over "model", the grouped GQA einsum at decode, bf16
    TP partial reductions, and TP-only weights at decode. The bf16 TP
    reduction dtype is process state (`layers.set_tp_reduce_dtype`),
    set here for the case as the reference sets it."""
    from repro_torch.models import layers as L

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    tp = mesh_spec(mesh).shape.get("model", 1)
    if profile == "opt":
        if cfg.num_experts > 0 and shape.kind != "prefill":
            cfg = dataclasses.replace(cfg, moe_impl="local")
        if shape.kind == "decode" and cfg.num_kv_heads % tp != 0:
            cfg = dataclasses.replace(cfg, decode_seq_shard=True)
        if shape.kind == "decode":
            cfg = dataclasses.replace(cfg, attn_gqa_grouped=True)
        L.set_tp_reduce_dtype(torch.bfloat16)
    else:
        L.set_tp_reduce_dtype(None)
    n_active = float(cfg.active_param_count)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    return make_case(cfg, mesh, shape.kind, input_specs(cfg, shape), max_len=shape.seq_len,
                     lr=lr, serving=profile == "opt" and shape.kind == "decode",
                     name=f"{arch}.{shape_name}", model_flops=flops)


def _spec_index(pspecs) -> dict:
    """{path names: PSpec} of a tree of specs: a nested dict / list tree
    (`param_pspecs` of a parameter tree) or a module's flat ``{dotted
    name: PSpec}`` dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, PSpec):
            out[path] = node
        elif isinstance(node, Mapping):
            for k, v in node.items():
                flat = not path and isinstance(v, PSpec)  # a module's dotted name
                walk(v, tuple(_names(str(k))) if flat else path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (f"[{i}]",))

    walk(pspecs, ())
    return out


def opt_state_pspecs(opt_shapes, params_pspecs, mesh):
    """Specs of the optimizer state tree ``opt_shapes`` (leaves with a
    ``shape``), congruent with ``params_pspecs`` on ``mesh``:

      AdamW, ``state['mu'|'nu'][<param path>]``: the parameter's spec;
      Adafactor, ``state[<param path>]['row'|'col'|'nu']``: ``row`` drops
      the spec's last entry (the mean over the last dim), ``col`` its
      second to last, ``nu`` keeps it.

    Each result is guarded on the state leaf's own shape (`guard_pspec`);
    a leaf that matches no parameter is replicated. The result has the
    structure of ``opt_shapes``."""
    ms = mesh_spec(mesh)
    index = _spec_index(params_pspecs)

    def per_leaf(names: tuple, leaf):
        shape = _shape(leaf)
        if names and names[0] in ("mu", "nu") and names[1:] in index:
            return guard_pspec(shape, index[names[1:]], ms)
        if names and names[-1] in ("row", "col", "nu") and names[:-1] in index:
            entries = list(index[names[:-1]])
            if names[-1] == "row":
                entries = entries[:-1]
            elif names[-1] == "col":
                entries = entries[:-2] + entries[-1:]
            return guard_pspec(shape, PSpec(*entries), ms)
        return PSpec(*([None] * len(shape)))

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(walk(v, path + (f"[{i}]",)) for i, v in enumerate(node))
        return per_leaf(path, node)

    return walk(opt_shapes, ())
