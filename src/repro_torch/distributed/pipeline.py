"""Pipeline parallelism over the "pod" mesh axis (GPipe-style).

Port of `repro.distributed.pipeline`. The layer stack is split into
`n_stages` groups, stage s owned by the ranks at pod coordinate s, and
activations handed on once per microbatch tick. Schedule: GPipe with M
microbatches, M + S - 1 ticks (bubble fraction (S-1)/(M+S-1)): at tick
t stage 0 injects microbatch t, every stage applies its layers to what
it holds, and the last stage collects microbatch t - (S - 1).

Every rank runs the same loop on local tensors. The reference's
``ppermute`` cyclic shift is one all-reduce over the pod group of a
zero-filled (S, ...) buffer: each stage writes its output into its own
slot and reads slot s - 1 (x + 0 = x, so it is exact), the one form
gloo takes on CUDA tensors (it has no CUDA send or recv). The final
broadcast is the reference's ``psum`` of ``outs * is_last``. The
forward only: its backward belongs with sharded training (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

__all__ = ["make_pipeline_forward", "stack_stage_params", "stage_model", "transformer_stage_fn"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _index(tree, i: int):
    """Entry ``i`` of a tree's leading axis: the i-th of a list, or every
    leaf's i-th slice."""
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return tree[i]
    return _tree_map(lambda a: a[i], tree)


def stack_stage_params(per_stage_params: list):
    """Stack a list of per-stage param trees along a new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def make_pipeline_forward(
    stage_fn: Callable,  # (stage_params, x, stage_idx) -> y
    mesh,
    *,
    n_stages: int,
    n_microbatches: int,
    pod_axis: str = "pod",
    data_axes: tuple = ("data",),
    model_axis: str = "model",
):
    """Returns f(stage_params_local, x_local) -> y running the GPipe
    schedule on this rank of ``mesh`` (a `DeviceMesh`).

    ``stage_params_local`` is this rank's block of the stage-stacked
    params (leading dim 1: the stacked tree split over ``pod_axis``, so
    each stage holds only its own weights); ``x_local`` this rank's
    slice of the batch over ``data_axes`` (every stage gets the same
    one); its batch must divide by ``n_microbatches``. Every stage
    returns the last stage's output.
    """
    names = tuple(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.mesh.shape))
    if size.get(pod_axis) != n_stages:
        raise ValueError(f"n_stages={n_stages} != pod axis size {size.get(pod_axis)}")
    stage_idx = dict(zip(names, mesh.get_coordinate()))[pod_axis]
    group = mesh.get_group(pod_axis) if n_stages > 1 else None

    def pipelined(stage_params_local, x_local):
        from repro_torch.core.distributed import all_reduce

        sp = _index(stage_params_local, 0)
        b = x_local.shape[0]
        mb = b // n_microbatches
        micro = x_local.reshape(n_microbatches, mb, *x_local.shape[1:])
        n_ticks = n_microbatches + n_stages - 1
        buf = torch.zeros_like(micro[0])
        outs = None
        for t in range(n_ticks):
            # stage 0 injects microbatch t (when in range)
            x_in = micro[t if t < n_microbatches else 0] if stage_idx == 0 else buf
            y = stage_fn(sp, x_in, stage_idx)
            if outs is None:
                outs = torch.zeros((n_microbatches, *y.shape), dtype=y.dtype, device=y.device)
            # last stage collects its finished microbatch (t - (S-1))
            out_slot = t - (n_stages - 1)
            if stage_idx == n_stages - 1 and out_slot >= 0:
                outs[out_slot] = y
            # hand off to the next stage: slot s - 1 of the reduced ring
            ring = torch.zeros((n_stages, *y.shape), dtype=y.dtype, device=y.device)
            ring[stage_idx] = y
            if group is not None:
                all_reduce(ring, group)
            buf = ring[(stage_idx - 1) % n_stages]
        # every stage gets the last stage's outputs (one sum of activations)
        if stage_idx != n_stages - 1:
            outs.zero_()
        if group is not None:
            all_reduce(outs, group)
        return outs.reshape(b, *outs.shape[2:])

    return pipelined


def transformer_stage_fn(layer_fn: Callable, layers_per_stage: int):
    """Adapter: run `layers_per_stage` layers as one stage.

    stage_params: a tree with leading dim = layers_per_stage (stacked
    leaves), or a list of the stage's layers' params;
    ``layer_fn(layer_params, x) -> x``.
    """

    def fn(stage_params, x, stage_idx):
        for i in range(layers_per_stage):
            x = layer_fn(_index(stage_params, i), x)
        return x

    return fn


def stage_model(cfg, mesh, *, n_stages: int, generator=None, pod_axis: str = "pod"):
    """(the model holding this rank's stage, the stage's layers): the
    transformer's layers split into ``n_stages`` contiguous groups over
    ``pod_axis`` of ``mesh`` (a `DeviceMesh`). Every leaf is drawn whole
    from ``generator`` in the reference's order (so each stage holds the
    one-process model's values) and kept only where this stage needs it:
    its own layers and the embedding table (every stage embeds, stage 0
    injects); every other leaf is an empty tensor."""
    from repro_torch.core.distributed import mesh_device
    from repro_torch.models.transformer import Transformer

    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split into {n_stages} stages")
    names = tuple(mesh.mesh_dim_names or ())
    stage = dict(zip(names, mesh.get_coordinate()))[pod_axis]
    per = cfg.num_layers // n_stages
    mine = range(stage * per, (stage + 1) * per)

    def keep(name, t):
        parts = name.split(".")
        if parts[0] == "embed" or (parts[0] == "layers" and int(parts[1]) in mine):
            return t
        return t.new_empty(0)

    model = Transformer(cfg, device=mesh_device(mesh), generator=generator, place=keep)
    return model, [model.layers[i] for i in mine]
