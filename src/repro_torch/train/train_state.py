"""Training state: params + optimizer state + step.

Port of `repro.train.train_state`. ``params`` is the model's parameter
tree under the reference's names (nested dicts and lists, leaves the
model's own `nn.Parameter`s, not copies: `param_tree`), ``opt_state``
the optimizer's tree and ``step`` a () int64 tensor (the reference's is
int32; counters widen to int64 in the port). A train step updates
``params`` and ``opt_state`` in place and returns a state with the next
step.

On disk (`repro_torch.checkpoint.CheckpointManager`) the state has the
reference's leaf names (``.params/...``, ``.opt_state/...``, ``.step``)
and dtypes: `to_disk` writes the step as int32, bf16 leaves go as their
bits, so either package restores the other's snapshot; `load_` copies
a restored snapshot into a live state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optimizer.base import tree_leaves, tree_map, tree_map_

__all__ = ["TrainState", "param_tree"]


def param_tree(model) -> dict:
    """The model's parameters as the reference's tree: dotted names split
    into nested dicts, with the per-layer groups (``layers``, whisper's
    ``enc_layers`` and ``dec_layers``) lists; under ``scan_layers`` the
    stacked leaves stay a dict under ``layers``, as the reference's."""
    return _nest(model.named_parameters())


def _check_blocks(plan, optimizer, opt_state) -> None:
    """On a rank-local model the optimizer's state is built on the
    parameters' blocks: each state leaf must be the block
    `launch.specs.opt_state_pspecs` gives it on the plan's mesh (the
    state of the whole parameters, as ``plan.shapes`` and ``plan.specs``
    describe them)."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.specs import opt_state_pspecs

    whole = _nest((n, torch.empty(s, device="meta")) for n, s in plan.shapes.items())
    shapes = optimizer.init(whole)
    specs = opt_state_pspecs(shapes, _nest(plan.specs.items()), plan.mesh)
    blocks = param_shardings(shapes, plan.mesh, pspecs=specs)
    for leaf, full, block in zip(tree_leaves(opt_state), tree_leaves(shapes),
                                 tree_leaves(blocks)):
        want = tuple(full[block.index].shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"an optimizer state block {tuple(leaf.shape)} is not the "
                             f"{want} block opt_state_pspecs places")


def _nest(items) -> dict:
    """(dotted name, value) pairs as the reference's nested tree."""
    tree: dict = {}
    for name, param in items:
        *groups, leaf = name.split(".")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = param
    for key, sub in tree.items():
        if isinstance(sub, dict) and sub and all(k.isdigit() for k in sub):
            tree[key] = [sub[str(i)] for i in range(len(sub))]
    return tree


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # () int64

    @classmethod
    def create(cls, model, optimizer) -> "TrainState":
        """The state of a model about to train: its parameter tree (with
        gradients turned on), the optimizer's initial state, step 0.

        Under ``scan_layers`` the leaves are the stacked (L, ...) ones,
        as the reference's: the optimizer sees a stacked norm scale or
        bias as a matrix (AdamW decays it, Adafactor factors it over the
        stack) and reduces Adafactor's means over the whole stack."""
        params = param_tree(model)
        tree_map_(lambda p: p.requires_grad_(True), params)
        step = torch.zeros((), dtype=torch.int64, device=model.device)
        opt_state = optimizer.init(params)
        if getattr(model, "tp", None) is not None:
            _check_blocks(model.tp, optimizer, opt_state)
        return cls(params=params, opt_state=opt_state, step=step)

    def to_disk(self) -> "TrainState":
        """The state as a snapshot holds it: the step as int32 (the
        reference's); raises past 2^31 - 1 rather than wrap."""
        step = int(self.step)
        if step > torch.iinfo(torch.int32).max:
            raise OverflowError(f"step {step} does not fit a snapshot's int32 counter")
        return self._replace(step=torch.tensor(step, dtype=torch.int32))

    def skeleton(self) -> "TrainState":
        """The state's structure with no tensors: restoring into it keeps
        the snapshot's leaves on the CPU (`load_` then moves them)."""
        return TrainState(tree_map(lambda _: None, self.params),
                          tree_map(lambda _: None, self.opt_state), None)

    @torch.no_grad()
    def load_(self, restored: "TrainState") -> "TrainState":
        """Copy a restored snapshot into this state's tensors in place
        (shapes and dtypes must match); returns the state at its step."""
        for live, saved in zip(tree_leaves((self.params, self.opt_state)),
                               tree_leaves((restored.params, restored.opt_state))):
            if live.shape != saved.shape or live.dtype != saved.dtype:
                raise ValueError(
                    f"snapshot leaf {tuple(saved.shape)} {saved.dtype} does not fit "
                    f"{tuple(live.shape)} {live.dtype}"
                )
            live.copy_(saved)
        step = torch.as_tensor(int(restored.step), dtype=torch.int64, device=self.step.device)
        return self._replace(step=step)
