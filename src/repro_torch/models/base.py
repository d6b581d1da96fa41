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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

__all__ = ["Group", "Model", "TensorSpec", "Whole", "model_dtype"]


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


class Whole:
    """A parameter group read through a `ShardPlan`: each leaf the plan
    splits over "data" (the FSDP training layout) comes out gathered
    whole over the data group (`ShardPlan.whole`), every other leaf as
    it is, a child group as a `Whole` of it. Indexed as a `Group` is."""

    __slots__ = ("_group", "_plan")

    def __init__(self, group: nn.Module, plan):
        self._group, self._plan = group, plan

    def __getitem__(self, name: str):
        value = self._group[name]
        if isinstance(value, nn.Module):
            return Whole(value, self._plan)
        return self._plan.whole(value)

    def __getattr__(self, name: str):
        return self[name]

    def __contains__(self, name: str) -> bool:
        return name in self._group


class TensorSpec(NamedTuple):
    """Shape and dtype of a stub input (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


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
        cfg = self.cfg
        if cfg.frontend == "vision_stub" and cfg.vision_tokens:
            shape = (batch, cfg.vision_tokens, cfg.d_model)
            return {"vision_embeds": TensorSpec(shape, self.dtype)}
        if cfg.frontend == "audio_stub":
            shape = (batch, cfg.encoder_seq, cfg.d_model)
            return {"encoder_frames": TensorSpec(shape, self.dtype)}
        return {}
