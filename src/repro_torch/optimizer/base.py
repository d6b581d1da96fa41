"""Optimizer interface (init / update plain functions over trees).

Port of `repro.optimizer.base`. A tree is a nest of dicts, lists and
tuples with tensor leaves (the reference's pytree); dict keys are walked
in sorted order, as ``jax.tree_util`` walks them.

An `Optimizer` has the reference's two functions and one more:

  init(params) -> opt_state
  update(grads, opt_state, params, step, splits=None) -> (updates, new_opt_state)
  update_(grads, opt_state, params, step, splits=None) -> None

``update`` is the reference's functional form: new tensors, inputs
untouched. ``update_`` computes the same values leaf by leaf and writes
them into ``opt_state`` and ``params`` in place (``p += u`` in the
parameter's dtype), so a step holds one leaf's temporaries at a time
instead of a second copy of the moments and the updates: what lets a
3B-parameter model's AdamW step fit beside its weights on one card.
Fed the same inputs, both forms give the same bits.

On a mesh each leaf is this rank's block of a parameter (and its state
the block of the state: `repro_torch.launch.specs.opt_state_pspecs`):
``splits``, a tree of the params' structure, gives each leaf's split
dims as ``{dim: TP}`` (the group, this rank's place in it, its size),
and an optimizer that reduces over a dim reduces over that group too
(Adafactor's means; AdamW is elementwise and reads none).

Scalar math that the reference does on f32 arrays (``b1 ** step``, the
learning rate) is done on f32 tensors here too; `global_norm` and
`clip_by_global_norm` run in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch

__all__ = [
    "Optimizer", "clip_by_global_norm", "clip_by_global_norm_", "global_norm", "tree_leaves",
    "tree_map", "tree_map_", "tree_unzip",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]  # params -> opt_state
    update: Callable[..., tuple]  # (grads, state, params, step) -> (updates, state)
    update_: Callable[..., None]  # (grads, state, params, step) -> None, in place


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the subtrees of ``rest`` at
    the same positions (a subtree of ``rest`` may be a dict where ``tree``
    has a leaf: Adafactor's per-parameter state)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest))) for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unzip(tree, n: int) -> tuple:
    """``n`` trees from a tree whose leaves are ``n``-tuples."""
    def pick(sub, i):
        if isinstance(sub, dict):
            return type(sub)((k, pick(v, i)) for k, v in sub.items())
        if isinstance(sub, list):
            return [pick(v, i) for v in sub]
        return sub[i]

    return tuple(pick(tree, i) for i in range(n))


def tree_map_(fn: Callable, tree, *rest) -> None:
    """`tree_map` for its effect: ``fn`` runs on each leaf in turn, in the
    reference's leaf order, and nothing is collected."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            tree_map_(fn, tree[k], *(r[k] for r in rest))
    elif isinstance(tree, (list, tuple)):
        for subs in zip(tree, *rest):
            tree_map_(fn, *subs)
    else:
        fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """() f32: sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(x.detach().to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    return torch.minimum(one, max_norm / torch.clamp_min(norm, 1e-9))


def clip_by_global_norm(grads, max_norm: float) -> tuple:
    """(grads scaled to a global norm of at most ``max_norm``, in their
    dtype, and the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, *, norm=None) -> torch.Tensor:
    """`clip_by_global_norm` written into ``grads`` leaf by leaf; returns
    the norm before clipping (``norm``, where the caller has it: a
    sharded tree's norm over the whole mesh)."""
    if norm is None:
        norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    tree_map_(lambda g: g.copy_((g.to(torch.float32) * scale).to(g.dtype)), grads)
    return norm


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's). The card's ``sqrtf``
    is; PyTorch's vectorised CPU ``sqrt`` is not on every build (an
    AVX-512 build misses by an ulp on ~0.6 % of inputs), so on the CPU it
    is taken in f64 and rounded once, which is exact for f32."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def f32(value, device) -> torch.Tensor:
    """A () f32 tensor: where the reference meets a Python float with an
    f32 array, the arithmetic is f32."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def lr_schedule(lr) -> Callable:
    """The reference's ``lr_fn``: a callable of the step as it is, or a
    constant as a () f32 tensor on the step's device."""
    if callable(lr):
        return lr
    return lambda step: f32(lr, step.device)
