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
3B-parameter model's AdamW step fit on one card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.optimizer.base import (
    Optimizer, clip_by_global_norm_, global_norm, tree_leaves, tree_map,
)
from repro_torch.train.train_state import TrainState

__all__ = ["cross_entropy_loss", "make_eval_step", "make_loss_fn", "make_train_step"]


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
    model's own parameters (the reference's inner ``loss_fn``)."""
    cfg = model.cfg

    def loss_fn(batch):
        tokens = batch["tokens"]
        logits, aux = model(tokens, **_extras(batch))
        targets, mask = _targets_and_mask(tokens, batch.get("loss_mask"), cfg.vision_tokens)
        loss, ce = cross_entropy_loss(logits, targets, mask, z_loss)
        if aux:
            loss = loss + aux_weight * (
                aux.get("load_balance_loss", 0.0) + cfg.router_z_loss * aux.get("router_z_loss", 0.0)
            )
        return loss, ce, aux

    return loss_fn


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
    extras (vision_embeds)}. Targets are tokens shifted left. Metrics are
    () f32 tensors: loss, ce, grad_norm, step_ok, param_norm (and
    ``aux/<name>`` for each aux term).
    """
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, z_loss=z_loss)

    def train_step(state: TrainState, batch) -> tuple:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        with torch.enable_grad():
            loss, ce, aux = loss_fn(batch)
            loss.backward()
        loss = loss.detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         state.params)
        gnorm = clip_by_global_norm_(grads, clip_norm)
        if skip_nonfinite:
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))  # the step's one sync
        else:
            ok = True
        if ok:
            optimizer.update_(grads, state.opt_state, state.params, state.step)
        for p in leaves:
            p.grad = None
        metrics = {
            "loss": loss,
            "ce": ce.detach(),
            "grad_norm": gnorm,
            "step_ok": torch.tensor(float(ok), dtype=torch.float32, device=loss.device),
            "param_norm": global_norm(state.params),
        }
        for k, v in (aux or {}).items():
            metrics[f"aux/{k}"] = v.detach()
        return state._replace(step=state.step + 1), metrics

    return train_step


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
