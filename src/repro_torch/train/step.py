"""Train / eval step factories.

Port of `repro.train.step`. `make_train_step(model, optimizer)` returns
``train_step(state, batch) -> (state, metrics)``. The loss is token-level
softmax cross-entropy with z-loss (MoE aux terms added when the model
reports them); gradients are clipped by global norm; a NaN/Inf guard
SKIPS the update for a bad batch (the step still increments and the
metrics record the skip).

Where the reference's functional step keeps the old and the new
parameters and moments and picks one with ``jnp.where``, this step asks
first: it reads the guard's verdict (a finite loss and a finite
gradient norm) back to the host, one sync a step, and only then updates
each leaf's moments and parameter in place (`Optimizer.update_`). A
skipped step leaves every parameter and moment as it was, bit for bit,
and no step holds a second copy of the model's state: what lets a
3B-parameter model's AdamW step fit on one card. On the "meta" device
(the dry run's shapes-only step, `repro_torch.launch.dryrun`) there is
no verdict to read back: the update runs and ``step_ok`` is the verdict
as a tensor.

On a mesh (a rank-local model from `repro_torch.distributed.shard_model`,
its `ShardPlan` in ``model.tp``; ``serving=False`` places the FSDP × TP
training layout) every rank runs the same step on its own rows of the
batch and its own blocks, and computes what the reference's jitted step
computes over the whole batch:

  * the loss is the global batch's masked mean: each data replica's
    numerator over the denominator summed over the data axes, so the
    replicas' gradients sum to the global one; the MoE aux terms are the
    global batch's on every rank (`models.moe.moe_ffn_mesh`: their sums
    over data pass the cotangent through), so each rank differentiates
    its share of the loss plus the whole aux term, and the reported loss
    is the shares' sum plus the aux term once; the logits are split over
    the vocabulary on the model axis, and the cross-entropy is taken
    vocab-parallel (the max, then the sum of the exps and the target's
    logit, reduced over "model"), so no rank gathers (B, S, V) logits;
  * a leaf split over "data" has its gradient summed over the data
    group where it was gathered (`ShardPlan.whole`); every other leaf's
    gradient is summed over each data axis it is replicated on, in one
    all-reduce of the flattened leaves an axis. Over "model" the layers'
    collectives already give each rank its blocks' gradients and the
    whole gradient of a leaf it reads whole (`models.layers`: a leaf a
    rank reads only in part, such as `norm_split`'s scale, enters
    through `layers.enter`, whose backward sums the parts); nothing more
    is summed there, or a replicated leaf's gradient would count each
    model rank's copy;
  * `global_norm` counts every parameter element once: each rank adds a
    leaf's sum of squares only where its coordinate is 0 on every axis
    the leaf is replicated over, and one all-reduce over the mesh sums
    them, so ``grad_norm``, ``param_norm`` and the guard's verdict are
    the same bits on every rank, and every rank takes the same branch;
  * the optimizer's means over a split dim reduce over the group that
    splits it (``splits``: Adafactor's; AdamW is elementwise).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.optimizer.base import (
    Optimizer, clip_by_global_norm_, global_norm, tree_leaves, tree_map,
)
from repro_torch.train.train_state import TrainState

__all__ = [
    "cross_entropy_loss", "make_eval_step", "make_grad_fn", "make_loss_fn", "make_train_step",
]


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 1e-4,
) -> tuple:
    """Next-token CE. logits (B,S,V) f32, targets (B,S) int. Returns
    (loss with z-loss, ce), each the masked mean over tokens."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = logz - tgt_logit
    zl = z_loss * torch.square(logz)
    if mask is None:
        mask = torch.ones_like(ce)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum((ce + zl) * mask) / denom
    return loss, torch.sum(ce * mask) / denom


def _sharded_cross_entropy(logits, targets, mask, z_loss: float, plan, data_groups) -> tuple:
    """`cross_entropy_loss` on a mesh: ``logits`` this rank's rows and
    vocabulary columns (``plan.logits``; None: every column), the
    denominator summed over ``data_groups``. Returns this data replica's
    share of the global (loss, ce): its numerators over the global
    denominator."""
    from repro_torch.core.distributed import all_reduce

    logits = logits.to(torch.float32)
    if plan.logits is None:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        lo, hi = plan.logits
        with torch.no_grad():  # the shift only: its gradient cancels
            m = L.all_reduce(torch.amax(logits, dim=-1, keepdim=True), plan.tp, op="max")
        logz = torch.log(L.sum_replicated(torch.sum(torch.exp(logits - m), dim=-1), plan.tp))
        logz = logz + m[..., 0]
        local = targets.long() - lo
        ok = (local >= 0) & (local < hi - lo)
        tgt = torch.gather(logits, -1, torch.where(ok, local, 0)[..., None])[..., 0]
        tgt = L.sum_replicated(torch.where(ok, tgt, 0.0), plan.tp)
    ce = logz - tgt
    zl = z_loss * torch.square(logz)
    denom = torch.sum(mask)
    for group in data_groups:
        all_reduce(denom, group)
    denom = torch.clamp_min(denom, 1.0)
    return torch.sum((ce + zl) * mask) / denom, torch.sum(ce * mask) / denom


def _targets_and_mask(tokens: torch.Tensor, mask, vision_tokens: int) -> tuple:
    """Tokens shifted left (the first wraps to the end), and the loss mask
    with the last position (no target) and the vision prefix zeroed."""
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask = mask.to(torch.float32).clone()
    mask[:, -1] = 0.0
    if vision_tokens:
        mask[:, :vision_tokens] = 0.0
    return targets, mask


def _extras(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k not in ("tokens", "loss_mask")}


def make_loss_fn(model, *, aux_weight: float = 1e-2, z_loss: float = 1e-4) -> Callable:
    """The train step's ``loss_fn(batch) -> (loss, ce, aux)`` over the
    model's own parameters (the reference's inner ``loss_fn``). On a
    mesh ``batch`` is this data replica's rows, ce its share of the
    global mean and loss the objective the rank differentiates: its share
    of the global loss plus the whole aux term (see the module
    docstring)."""
    parts = _loss_parts(model, aux_weight=aux_weight, z_loss=z_loss)

    def loss_fn(batch):
        share, ce, aux, aux_term = parts(batch)
        return share + aux_term, ce, aux

    return loss_fn


def _loss_parts(model, *, aux_weight: float, z_loss: float) -> Callable:
    """``parts(batch) -> (loss, ce, aux, aux_term)``: the CE loss with
    z-loss and the ce (the replica's shares of the global means on a
    mesh), the aux terms and their weighted sum (0.0 without them)."""
    cfg = model.cfg
    plan = getattr(model, "tp", None)
    data_groups = list(_data_groups(plan.mesh).values()) if plan is not None else []

    def parts(batch):
        tokens = batch["tokens"]
        logits, aux = model(tokens, **_extras(batch))
        targets, mask = _targets_and_mask(tokens, batch.get("loss_mask"), cfg.vision_tokens)
        if plan is None:
            loss, ce = cross_entropy_loss(logits, targets, mask, z_loss)
        else:
            loss, ce = _sharded_cross_entropy(logits, targets, mask, z_loss, plan, data_groups)
        aux_term = 0.0
        if aux:
            aux_term = aux_weight * (
                aux.get("load_balance_loss", 0.0) + cfg.router_z_loss * aux.get("router_z_loss", 0.0)
            )
        return loss, ce, aux, aux_term

    return parts


def make_grad_fn(model, *, aux_weight: float = 1e-2, z_loss: float = 1e-4) -> Callable:
    """Returns grad_fn(state, batch) -> (loss, ce, aux, grads), the first
    half of the train step: the loss and ce (the global batch's on a
    mesh), the aux terms, and every leaf's gradient before clipping (the
    parameters' ``.grad`` tensors; on a mesh each rank's blocks of the
    global gradient, see the module docstring)."""
    mesh = _MeshStep(model) if getattr(model, "tp", None) is not None else None
    parts = _loss_parts(model, aux_weight=aux_weight, z_loss=z_loss)

    def grad_fn(state: TrainState, batch) -> tuple:
        for p in tree_leaves(state.params):
            p.grad = None
        with torch.enable_grad():
            loss, ce, aux, aux_term = parts(batch)
            (loss + aux_term).backward()
        loss, ce = loss.detach(), ce.detach()
        aux_term = aux_term.detach() if torch.is_tensor(aux_term) else aux_term
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         state.params)
        if mesh is not None:
            loss, ce = mesh.sum_data(loss, ce)
            mesh.reduce_grads(state.params, grads)
        return loss + aux_term, ce, aux, grads

    grad_fn.mesh = mesh
    return grad_fn


def make_train_step(
    model,
    optimizer: Optimizer,
    *,
    clip_norm: float = 1.0,
    aux_weight: float = 1e-2,
    z_loss: float = 1e-4,
    skip_nonfinite: bool = True,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``state`` is a `TrainState` over ``model``'s own parameters; ``batch``
    = {"tokens": (B,S) int tensor, "loss_mask": optional (B,S), + modality
    extras (vision_embeds)}; on a mesh, this data replica's rows.
    Targets are tokens shifted left. Metrics are () f32 tensors: loss,
    ce, grad_norm, step_ok, param_norm (and ``aux/<name>`` for each aux
    term), on a mesh the same on every rank.
    """
    grad_fn = make_grad_fn(model, aux_weight=aux_weight, z_loss=z_loss)
    mesh = grad_fn.mesh

    def train_step(state: TrainState, batch) -> tuple:
        loss, ce, aux, grads = grad_fn(state, batch)
        norm, update = global_norm, optimizer.update_
        if mesh is not None:
            norm = functools.partial(mesh.norm, params=state.params)
            update = functools.partial(optimizer.update_, splits=mesh.splits(state.params))
        gnorm = clip_by_global_norm_(grads, clip_norm, norm=norm(grads))
        verdict = torch.isfinite(loss) & torch.isfinite(gnorm) if skip_nonfinite else None
        if verdict is not None and verdict.is_meta:
            # shapes only (a dry run): nothing to read back, so the update runs
            # and the verdict stays a tensor
            update(grads, state.opt_state, state.params, state.step)
            step_ok = verdict.to(torch.float32)
        else:
            ok = True if verdict is None else bool(verdict)  # the step's one sync
            if ok:
                update(grads, state.opt_state, state.params, state.step)
            step_ok = torch.tensor(float(ok), dtype=torch.float32, device=loss.device)
        for p in tree_leaves(state.params):
            p.grad = None
        metrics = {
            "loss": loss,
            "ce": ce,
            "grad_norm": gnorm,
            "step_ok": step_ok,
            "param_norm": norm(state.params),
        }
        for k, v in (aux or {}).items():
            metrics[f"aux/{k}"] = v.detach()
        return state._replace(step=state.step + 1), metrics

    return train_step


def _data_groups(mesh) -> dict:
    """{axis: process group} of ``mesh``'s data axes of more than one rank."""
    from repro_torch.distributed.sharding import data_axes

    size = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    return {a: mesh.get_group(a) for a in data_axes(mesh) if size[a] > 1}


class _MeshStep:
    """What a train step does beyond one device's on a rank-local model:
    each leaf's spec (``model.tp.specs``) says which mesh axes split it
    and which replicate it (see the module docstring)."""

    def __init__(self, model):
        plan = model.tp
        mesh = plan.mesh
        names = tuple(mesh.mesh_dim_names)
        size = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
        coord = dict(zip(names, mesh.get_coordinate()))
        live = [a for a in names if size[a] > 1]
        self.data_groups = _data_groups(mesh)
        # every rank of the mesh: the default group (a virtual mesh's own)
        self.world = getattr(mesh, "world_group", None)
        tps = {a: L.TP(mesh.get_group(a), coord[a], size[a]) for a in live}
        self._split, self._owned, self._replicated = {}, {}, {}
        for name, p in model.named_parameters():
            split = {}
            for dim, ax in enumerate(plan.specs[name]):
                if isinstance(ax, tuple):
                    raise NotImplementedError(f"{name}: dim {dim} is split over several axes {ax}")
                if ax in tps:
                    split[dim] = ax
            key = id(p)
            self._split[key] = {dim: tps[ax] for dim, ax in split.items()}
            # counted once a mesh: by the rank at 0 on every axis that replicates it
            self._owned[key] = all(coord[a] == 0 for a in live if a not in split.values())
            self._replicated[key] = [a for a in self.data_groups if a not in split.values()]

    def splits(self, params):
        """The optimizer's ``splits`` tree: each leaf's {dim: TP}."""
        return tree_map(lambda p: self._split[id(p)], params)

    def sum_data(self, *scalars) -> tuple:
        """() tensors summed over the data axes, one all-reduce an axis."""
        from repro_torch.core.distributed import all_reduce

        buf = torch.stack(scalars)
        for group in self.data_groups.values():
            all_reduce(buf, group)
        return tuple(buf.unbind())

    @torch.no_grad()
    def reduce_grads(self, params, grads) -> None:
        """Each gradient summed over every data axis its leaf is
        replicated on: one all-reduce of the flattened leaves an axis and
        dtype."""
        from repro_torch.core.distributed import all_reduce

        pairs = list(zip(tree_leaves(params), tree_leaves(grads)))
        for axis, group in self.data_groups.items():
            by_dtype: dict = {}
            for p, g in pairs:
                if axis in self._replicated[id(p)]:
                    by_dtype.setdefault(g.dtype, []).append(g)
            for gs in by_dtype.values():
                flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), group)
                off = 0
                for g in gs:
                    g.copy_(flat[off : off + g.numel()].view_as(g))
                    off += g.numel()

    @torch.no_grad()
    def norm(self, tree, params) -> torch.Tensor:
        """() f32: the global norm of ``tree`` (the parameters, or their
        gradients after `reduce_grads`; ``params`` gives each leaf's
        parameter), every element counted once over the mesh."""
        from repro_torch.core.distributed import all_reduce

        leaves = tree_leaves(tree)
        sums = [torch.sum(torch.square(x.detach().to(torch.float32)))
                for x, p in zip(leaves, tree_leaves(params)) if self._owned[id(p)]]
        total = (torch.sum(torch.stack(sums)) if sums
                 else torch.zeros((), dtype=torch.float32, device=leaves[0].device))
        return torch.sqrt(all_reduce(total, self.world))


def make_eval_step(model) -> Callable:
    """Returns eval_step(batch) -> {"ce", "ppl"} (the reference's
    ``eval_step(params, batch)``; the model holds its parameters)."""

    @torch.no_grad()
    def eval_step(batch):
        tokens = batch["tokens"]
        logits, _ = model(tokens, **_extras(batch))
        targets, mask = _targets_and_mask(tokens, None, 0)
        _, ce = cross_entropy_loss(logits, targets, mask, z_loss=0.0)
        return {"ce": ce, "ppl": torch.exp(ce)}

    return eval_step
