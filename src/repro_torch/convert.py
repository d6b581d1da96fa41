"""Carry data and state over from the reference package.

The matching engine has no weights; what it carries is its data and its
state. These functions take plain numpy arrays (what ``jax.device_get``
of the reference's structures gives, or the reference's `BlockedDataset`
fields) and build the port's counterparts, so both packages can start
from the same dataset or the same mid-run state, or run the same kernel
plans. Packed uint32 words
are reinterpreted as int32 with the same bits; counters widen to int64.
`lm_params_from_numpy` loads an LM's parameter tree into the port's
model: bf16 leaves move bit for bit through uint16, without importing
``ml_dtypes``; `train_state_from_numpy` adds the optimizer's state and
the step. Nothing here imports the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.multiquery import (
    QTYPE_CLOSENESS,
    QTYPE_TOPK,
    MultiQueryState,
    SampleCursor,
)
from repro_torch.data.layout import BlockedDataset
from repro_torch.kernels.autotune import IngestPlan, PlanPair, TauPlan

__all__ = [
    "dataset_from_numpy", "multi_state_from_numpy", "cursor_from_numpy", "plan_pair_from_fields",
    "lm_params_from_numpy", "train_state_from_numpy",
]

_INT64_LEAVES = (
    "k", "qtype", "round_idx", "blocks_read", "blocks_considered", "tuples_read", "rounds",
)


def dataset_from_numpy(z_blocks, x_blocks, bitmap, v_z: int, v_x: int) -> BlockedDataset:
    """The port's `BlockedDataset` from the reference's blocked arrays."""
    z_blocks = np.ascontiguousarray(z_blocks, np.int32)
    x_blocks = np.ascontiguousarray(x_blocks, np.int32)
    bitmap = np.asarray(bitmap)
    if bitmap.dtype != np.uint32:
        raise TypeError(f"bitmap must be uint32, got {bitmap.dtype}")
    if z_blocks.shape != x_blocks.shape or bitmap.shape[0] != z_blocks.shape[0]:
        raise ValueError(
            f"shape mismatch: z {z_blocks.shape}, x {x_blocks.shape}, bitmap {bitmap.shape}"
        )
    if bitmap.shape[1] != -(-v_z // 32):
        raise ValueError(f"bitmap has {bitmap.shape[1]} words, V_Z={v_z} needs {-(-v_z // 32)}")
    return BlockedDataset(
        z_blocks=z_blocks, x_blocks=x_blocks, bitmap=np.ascontiguousarray(bitmap),
        v_z=int(v_z), v_x=int(v_x),
    )


def _leaf(name: str, value, device: torch.device) -> torch.Tensor:
    a = np.array(value, order="C")  # a writable copy; keeps 0-d leaves 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif name in _INT64_LEAVES:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def multi_state_from_numpy(leaves: Mapping, *, device=None) -> MultiQueryState:
    """The port's `MultiQueryState` from the reference's leaves by name
    (e.g. ``jax.device_get(state)._asdict()``), closeness slots and
    pruned candidates included. Raises on a query type the port does
    not know."""
    device = resolve_device(device)
    qtype = np.asarray(leaves["qtype"])
    if not np.isin(qtype, (QTYPE_TOPK, QTYPE_CLOSENESS)).all():
        raise ValueError(f"state leaf 'qtype' holds unknown query types {qtype.tolist()}")
    return MultiQueryState(
        **{name: _leaf(name, leaves[name], device) for name in MultiQueryState._fields}
    )


def cursor_from_numpy(leaves: Mapping, *, device=None) -> SampleCursor:
    """The port's `SampleCursor` from the reference's leaves by name."""
    device = resolve_device(device)
    return SampleCursor(
        **{name: _leaf(name, leaves[name], device) for name in SampleCursor._fields}
    )


def plan_pair_from_fields(fields: Mapping) -> PlanPair:
    """The port's `autotune.PlanPair` from the reference's as plain
    fields (``dataclasses.asdict(pair)``: ``{"tau": {...}, "ingest":
    {...}}``). The field names and meanings are the reference's; an
    unknown field or a value a plan rejects raises."""
    tau = TauPlan(**fields["tau"])
    ingest = IngestPlan(**fields["ingest"])
    tau.validate()
    ingest.validate()
    return PlanPair(tau=tau, ingest=ingest)


def _flatten(tree, prefix: str = "") -> dict:
    """Dotted names -> leaves of a nested dict/list tree (a list's items
    by index: ``layers.<i>.attn.wq``; the stacked layers of a
    ``scan_layers`` tree are a dict: ``layers.attn.wq``, as the port's
    stacked model names them)."""
    if isinstance(tree, Mapping):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, f"{prefix}{key}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_flatten(sub, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _tensor(arr) -> torch.Tensor:
    """A numpy leaf as a tensor with the same bits (bf16 via uint16)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def lm_params_from_numpy(tree: Mapping, cfg, *, device=None):
    """The port's model for ``cfg`` on ``device`` holding the reference's
    parameters: ``tree`` is the reference's parameter tree with numpy
    leaves (``jax.tree.map(np.asarray, params)``), its layers a list or,
    under ``scan_layers``, a dict of stacked leaves, which load as the
    stacked model's own. Every leaf must match a parameter by name,
    shape and dtype."""
    from repro_torch.models import model_zoo

    device = resolve_device(device)
    model = model_zoo.build(cfg, torch.device("meta"))
    leaves = _flatten(tree)
    names = dict(model.named_parameters())
    if set(leaves) != set(names):
        raise ValueError(
            f"parameter trees differ: missing {sorted(set(names) - set(leaves))}, "
            f"unexpected {sorted(set(leaves) - set(names))}"
        )
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            t = _tensor(leaves[name])
            if t.shape != param.shape or t.dtype != param.dtype:
                raise ValueError(
                    f"{name}: got {tuple(t.shape)} {t.dtype}, "
                    f"the model holds {tuple(param.shape)} {param.dtype}"
                )
            param.copy_(t)
    return model


def _tree_to_torch(tree, device: torch.device):
    """A tree of dicts and lists with numpy leaves as the same tree of
    tensors on ``device`` (bf16 through uint16)."""
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return _tensor(tree).to(device)


def train_state_from_numpy(params_tree: Mapping, opt_state_tree: Mapping, step, cfg, *,
                           device=None) -> tuple:
    """(model, `TrainState`) holding the reference's training state: its
    parameter tree (as `lm_params_from_numpy` takes it), its optimizer
    state (AdamW's ``{"mu", "nu"}`` trees, or Adafactor's per-parameter
    ``{"row", "col"}`` / ``{"nu"}``) with numpy leaves, and its step.
    The state's tree must have the structure the port's optimizer for
    ``cfg.optimizer`` builds."""
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train.train_state import TrainState

    device = resolve_device(device)
    model = lm_params_from_numpy(params_tree, cfg, device=device)
    state = TrainState.create(model, get_optimizer(cfg.optimizer, 0.0))
    opt_state = _tree_to_torch(opt_state_tree, device)
    if _signature(opt_state) != _signature(state.opt_state):
        raise ValueError(f"the optimizer state does not fit {cfg.optimizer}'s for this model")
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int64, device=device)
    return model, state._replace(opt_state=opt_state, step=step)


def _signature(tree, prefix: str = "") -> list:
    """(path, shape, dtype) of every leaf of a tree of tensors."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _signature(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _signature(v, f"{prefix}{i}/")]
    return [(prefix, tuple(tree.shape), tree.dtype)]
