"""What the model families share: the `Model` interface, parameter groups
and the stub-input shapes.

Every family (`transformer.Transformer`, `rglru.HybridLM`, `xlstm.XLSTM`,
`whisper.Whisper`) is a `Model`: an `nn.Module` that owns its weights on
one device, under the reference's parameter tree names, with the
reference's entry points less their ``params`` argument:

    logits, aux = model.forward(tokens, **extras)        # teacher-forced
    logits, cache = model.prefill(tokens, max_len, **extras)
    logits, cache = model.decode_step(cache, token)
    cache = model.init_cache(batch, max_len)
    shapes = model.extra_input_shapes(batch, seq)       # frontend stubs
    ids = model.greedy_pick(logits)                     # (B,) int32 numpy

``cfg.remat`` maps to activation checkpointing of each block of
`forward` while autograd records (`Model.remat`), in every family:
``"full"`` keeps only each block's inputs and recomputes the block in
the backward pass (``jax.checkpoint``), ``"dots"`` also keeps the
block's weight products (``aten.mm`` / ``aten.addmm``) and recomputes
the rest (``checkpoint_dots_with_no_batch_dims``: the attention products
carry batch dimensions and are recomputed). The reference checkpoints
the transformer's blocks only; the recurrent and audio families ignore
``cfg.remat`` there (ROADMAP Queue C, C7). Recomputation reruns the same
operations on the same inputs, so the gradients are the same, bit for
bit (`tests/test_torch_family_remat.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig

__all__ = ["Group", "LayerView", "Model", "TensorSpec", "Whole", "extra_input_shapes",
           "layer_views", "model_dtype"]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


class Group(nn.Module):
    """A group of the reference's parameter tree: its tensors become
    parameters (gradients off until a train state turns them on), its
    nested dicts child groups. Indexed by name, as the reference's dicts
    are (``g["wq"]``, ``"bq" in g``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Group(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class LayerView:
    """Layer ``index`` of a group of stacked parameters (``scan_layers``:
    each leaf one (L, ...) parameter): each leaf comes out as the view
    ``p[index]``, a child group as a `LayerView` of it. Indexed as a
    `Group` is. `layer_views` makes the L views of a group."""

    __slots__ = ("_group", "_index", "_views")

    def __init__(self, group: nn.Module, index: int, views: dict):
        self._group, self._index, self._views = group, index, views

    def __getitem__(self, name: str):
        value = self._group[name]
        if isinstance(value, nn.Module):
            return LayerView(value, self._index, self._views)
        return self._views[id(value)][self._index]

    def __getattr__(self, name: str):
        return self[name]

    def __contains__(self, name: str) -> bool:
        return name in self._group

    def stacked(self, name: str) -> torch.Tensor:
        """The (L, ...) parameter whose view leaf ``name`` is."""
        return self._group[name]


def layer_views(group: nn.Module, layers: int) -> list:
    """The ``layers`` `LayerView` s of ``group``, a group of stacked
    parameters: each parameter split by one ``unbind`` into its layers'
    views, so the backward pass stacks the layers' gradients into the
    parameter's once (reading ``p[i]`` layer by layer would give each
    layer's gradient the whole stack's size)."""
    views = {id(p): p.unbind(0) for p in group.parameters()}
    return [LayerView(group, i, views) for i in range(layers)]


class Whole:
    """A parameter group (a `Group` or a `LayerView`) read through a
    `ShardPlan`: each leaf the plan splits over "data" (the FSDP
    training layout) comes out gathered whole over the data group
    (`ShardPlan.whole`; a layer's view of a stacked leaf gathers only
    that layer), every other leaf as it is, a child group as a `Whole`
    of it. Indexed as a `Group` is."""

    __slots__ = ("_group", "_plan")

    def __init__(self, group, plan):
        self._group, self._plan = group, plan

    def __getitem__(self, name: str):
        value = self._group[name]
        if isinstance(value, (nn.Module, LayerView)):
            return Whole(value, self._plan)
        if isinstance(self._group, LayerView):
            return self._plan.whole(value, stack=self._group.stacked(name))
        return self._plan.whole(value)

    def __getattr__(self, name: str):
        return self[name]

    def __contains__(self, name: str) -> bool:
        return name in self._group


class TensorSpec(NamedTuple):
    """Shape and dtype of a stub input (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


# the products "dots" remat keeps: the weight products, which have no batch
# dimensions (attention's products run as bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


class Model(nn.Module):
    """The interface of every family (see the module docstring). A
    subclass sets ``cfg`` and an ``embed`` group holding ``table``."""

    cfg: ModelConfig

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["table"].dtype

    def weights(self, group: nn.Module):
        """``group`` as the layers read it: a `Whole` view where this
        rank-local model holds leaves split over "data", else itself."""
        plan = getattr(self, "tp", None)
        return Whole(group, plan) if plan is not None and plan.fsdp else group

    def remat(self, fn, *args):
        """``fn(*args)``, one block of `forward`, checkpointed as
        ``cfg.remat`` says while autograd records (the module docstring);
        called plainly under "none" or without autograd."""
        remat = self.cfg.remat
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {remat!r}")
        if remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        kw = {} if remat == "full" else {"context_fn": _dots_context}
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    def greedy_pick(self, logits: torch.Tensor) -> np.ndarray:
        """The first index of the largest logit a row (``argmax``'s rule in
        both frameworks), as int32 numpy. A rank-local model's logits may
        be vocab-sharded (its `ShardPlan`'s ``logits``, this rank's
        columns): the rank's own first maximum, the MAX of the values over
        the model group, then the MIN of the global indices holding it."""
        plan = getattr(self, "tp", None)
        if plan is None or plan.logits is None:
            return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        from repro_torch.models.layers import all_reduce

        idx = torch.argmax(logits, dim=-1, keepdim=True)
        val = torch.gather(logits, -1, idx)[..., 0].to(torch.float32)
        best = val.clone()
        all_reduce(best, plan.tp, op="max")
        cand = torch.where(val == best, idx[..., 0] + plan.logits[0], self.cfg.vocab_size)
        all_reduce(cand, plan.tp, op="min")
        return cand.cpu().numpy().astype(np.int32)

    def extra_input_shapes(self, batch: int, seq: int) -> dict:
        """The modality-frontend stub inputs `forward` takes (vlm, audio)."""
        return extra_input_shapes(self.cfg, batch, seq)


def extra_input_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """`Model.extra_input_shapes` of ``cfg``'s model, with no model built
    (the stubs are in the model's dtype)."""
    if cfg.frontend == "vision_stub" and cfg.vision_tokens:
        shape = (batch, cfg.vision_tokens, cfg.d_model)
        return {"vision_embeds": TensorSpec(shape, model_dtype(cfg))}
    if cfg.frontend == "audio_stub":
        shape = (batch, cfg.encoder_seq, cfg.d_model)
        return {"encoder_frames": TensorSpec(shape, model_dtype(cfg))}
    return {}
