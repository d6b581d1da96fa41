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
broadcast is the reference's ``psum`` of ``outs * is_last``.

The backward (the reference's ``jax.grad`` through the loop) is one
`torch.autograd.Function` over the whole schedule, so every rank issues
the same collectives in the same order: the forward keeps each tick's
autograd graph where the stage holds a real microbatch, and the
backward runs the ticks in reverse, each one all-reduce of a
zero-filled ring that sends the cotangent of a stage's input back to
the stage before it (the reverse shift, the transpose of ``ppermute``),
then the stage's own VJP. The final broadcast transposes to the last
stage's own cotangent: every rank takes the same loss of the replicated
output, and summing the S copies, as a plain all-reduce would, would
multiply every gradient by S. The input is replicated over the pod
axis, so its cotangent (stage 0's) is summed over the pod group, as the
reference sums a replicated input's; the parameters are replicated over
the data axes, so their gradients (each replica's from its own batch
slice) are summed over the data groups. A stage function may run
tensor-parallel over the model axis (`stage_model` on a mesh whose
"model" axis is over 1 places each stage's layers as `shard_model`
serves them): its collectives carry their own backward
(`repro_torch.models.layers`), so each model rank of a stage gets its
blocks' gradients and the whole cotangent of the stage's input.
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


def _tensors(tree) -> list:
    """The tensors of a stage-params tree: a module's parameters, the
    leaves of a dict / list / tuple."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


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
):
    """Returns f(stage_params_local, x_local) -> y running the GPipe
    schedule on this rank of ``mesh`` (a `DeviceMesh`).

    ``stage_params_local`` is this rank's block of the stage-stacked
    params (leading dim 1: the stacked tree split over ``pod_axis``, so
    each stage holds only its own weights); ``x_local`` this rank's
    slice of the batch over ``data_axes`` (every stage gets the same
    one); its batch must divide by ``n_microbatches``. Every stage
    returns the last stage's output. Under autograd (grad mode on and a
    parameter or ``x_local`` requiring grad) the result is
    differentiable: each stage's parameters get their gradients (summed
    over the data replicas), and ``x_local`` its cotangent on every
    stage (see the module docstring).
    """
    names = tuple(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.mesh.shape))
    if size.get(pod_axis) != n_stages:
        raise ValueError(f"n_stages={n_stages} != pod axis size {size.get(pod_axis)}")
    stage_idx = dict(zip(names, mesh.get_coordinate()))[pod_axis]
    group = mesh.get_group(pod_axis) if n_stages > 1 else None
    data_groups = [mesh.get_group(a) for a in data_axes if size.get(a, 1) > 1]
    n_ticks = n_microbatches + n_stages - 1

    def ring_shift(y, step: int = 1):
        """Every stage's ``y`` in its own slot of one reduced ring; this
        stage reads slot ``stage_idx - step``: the previous stage's tensor
        (the ``ppermute``) at ``step`` 1, the next stage's (its reverse
        shift, the backward) at -1."""
        from repro_torch.core.distributed import all_reduce

        ring = torch.zeros((n_stages, *y.shape), dtype=y.dtype, device=y.device)
        ring[stage_idx] = y
        if group is not None:
            all_reduce(ring, group)
        return ring[(stage_idx - step) % n_stages]

    def schedule(stage_params_local, x_local, ticks=None):
        """The forward loop; with ``ticks`` (a list) it records each real
        microbatch's (input, output) with its autograd graph there."""
        from repro_torch.core.distributed import all_reduce

        with torch.enable_grad() if ticks is not None else torch.no_grad():
            sp = _index(stage_params_local, 0)
        b = x_local.shape[0]
        mb = b // n_microbatches
        micro = x_local.reshape(n_microbatches, mb, *x_local.shape[1:])
        buf = torch.zeros_like(micro[0])
        outs = None
        for t in range(n_ticks):
            # stage 0 injects microbatch t (when in range)
            x_in = micro[t if t < n_microbatches else 0] if stage_idx == 0 else buf
            if ticks is not None and 0 <= t - stage_idx < n_microbatches:
                with torch.enable_grad():
                    x_in = x_in.detach().requires_grad_()
                    y = stage_fn(sp, x_in, stage_idx)
                ticks.append((t, x_in, y))
                y = y.detach()
            else:
                y = stage_fn(sp, x_in, stage_idx)
            if outs is None:
                outs = torch.zeros((n_microbatches, *y.shape), dtype=y.dtype, device=y.device)
            # last stage collects its finished microbatch (t - (S-1))
            out_slot = t - (n_stages - 1)
            if stage_idx == n_stages - 1 and out_slot >= 0:
                outs[out_slot] = y
            # hand off to the next stage: slot s - 1 of the reduced ring
            buf = ring_shift(y)
        # every stage gets the last stage's outputs (one sum of activations)
        if stage_idx != n_stages - 1:
            outs.zero_()
        if group is not None:
            all_reduce(outs, group)
        return outs.reshape(b, *outs.shape[2:])

    class _GPipe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, stage_params_local, x_local, *leaves):
            ctx.ticks = []
            with torch.no_grad():
                y = schedule(stage_params_local, x_local, ctx.ticks)
            ctx.leaves = leaves
            ctx.x_shape = x_local.shape
            return y

        @staticmethod
        def backward(ctx, g):
            from repro_torch.core.distributed import all_reduce

            leaves, ticks = ctx.leaves, ctx.ticks
            mb_shape = ticks[0][2].shape
            # the broadcast's transpose: the last stage's own cotangent
            g = g.reshape(n_microbatches, *mb_shape)
            g_leaves = [None] * len(leaves)
            g_x = torch.zeros((n_microbatches, *ticks[0][1].shape), dtype=ticks[0][1].dtype,
                              device=g.device)
            g_buf = torch.zeros(mb_shape, dtype=ticks[0][2].dtype, device=g.device)
            by_tick = {t: (x_in, y) for t, x_in, y in ticks}
            ticks.clear()
            for t in reversed(range(n_ticks)):
                # the reverse shift: the next stage's input cotangent (tick t + 1)
                # comes back as this stage's output cotangent at tick t
                g_y = ring_shift(g_buf, -1)
                out_slot = t - (n_stages - 1)
                if stage_idx == n_stages - 1 and out_slot >= 0:
                    g_y = g_y + g[out_slot]
                g_buf = torch.zeros_like(g_buf)
                if t not in by_tick:
                    continue
                x_in, y = by_tick.pop(t)
                got = torch.autograd.grad(y, (x_in, *leaves), g_y.to(y.dtype),
                                          retain_graph=bool(by_tick), allow_unused=True)
                for i, gl in enumerate(got[1:]):
                    if gl is not None:
                        g_leaves[i] = gl if g_leaves[i] is None else g_leaves[i] + gl
                if stage_idx == 0:
                    g_x[t] = got[0]
                else:
                    g_buf = got[0].to(g_buf.dtype)
            # the parameters are replicated over the data axes: their gradients summed
            for gl in g_leaves:
                if gl is not None:
                    for dg in data_groups:
                        all_reduce(gl, dg)
            if ctx.needs_input_grad[1]:
                # the input is replicated over the pod axis: its cotangent summed
                if group is not None:
                    all_reduce(g_x, group)
                g_x = g_x.reshape(ctx.x_shape)
            else:
                g_x = None
            return (None, g_x, *g_leaves)

    def pipelined(stage_params_local, x_local):
        leaves = [t for t in _tensors(stage_params_local) if t.requires_grad]
        if torch.is_grad_enabled() and (leaves or x_local.requires_grad):
            return _GPipe.apply(stage_params_local, x_local, *leaves)
        return schedule(stage_params_local, x_local)

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


def stage_model(cfg, mesh, *, n_stages: int, generator=None, params=None,
                pod_axis: str = "pod"):
    """(the model holding this rank's stage, the stage's layers): the
    transformer's layers split into ``n_stages`` contiguous groups over
    ``pod_axis`` of ``mesh`` (a `DeviceMesh`). Every leaf is drawn whole
    from ``generator`` in the reference's order (so each stage holds the
    one-process model's values), or taken from ``params`` (the
    reference's tree with numpy leaves, as `shard_model` takes it), and
    kept only where this stage needs it: its own layers and the
    embedding table (every stage embeds, stage 0 injects); every other
    leaf is an empty tensor. Where ``mesh`` has a "model" axis over 1,
    each kept leaf is this rank's block under
    `sharding.serving_param_pspecs` and the model carries its
    `ShardPlan` in ``tp``, as `shard_model` places it: the stage's
    layers run tensor-parallel."""
    from repro_torch.core.distributed import mesh_axes, mesh_device
    from repro_torch.distributed.sharding import (
        _plan, load_blocks, param_shardings, serving_param_pspecs,
    )
    from repro_torch.models.transformer import Transformer

    if cfg.scan_layers:
        raise ValueError("a stage holds unrolled layers; stacked (scan_layers) ones do not split")
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split into {n_stages} stages")
    names = tuple(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.mesh.shape))
    stage = dict(zip(names, mesh.get_coordinate()))[pod_axis]
    per = cfg.num_layers // n_stages
    mine = range(stage * per, (stage + 1) * per)
    shardings = None
    if size.get("model", 1) > 1:
        skeleton = Transformer(cfg, device=torch.device("meta"))
        shardings = param_shardings(skeleton, mesh,
                                    pspecs=serving_param_pspecs(skeleton, mesh))
        shapes = {name: tuple(p.shape) for name, p in skeleton.named_parameters()}
        del skeleton

    def block(name: str):
        """This rank's index of a leaf, None where the stage drops it."""
        parts = name.split(".")
        if not (parts[0] == "embed" or (parts[0] == "layers" and int(parts[1]) in mine)):
            return None
        return (slice(None),) if shardings is None else shardings[name].index

    device = mesh_device(mesh)
    if params is not None:
        model = load_blocks(Transformer, cfg, device, params, block)
    else:
        def place(name, t):
            index = block(name)
            if index is None:
                return t.new_empty(0)
            return t if shardings is None else t[index].clone()

        model = Transformer(cfg, device=device, generator=generator, place=place)
    if shardings is not None:
        data = ("data",) if "data" in names else ()
        model.tp = _plan(cfg, mesh, mesh_axes(mesh, data, "model"), shardings)
        model.tp.shapes = shapes
    return model, [model.layers[i] for i in mine]
