"""Top-k token-choice Mixture-of-Experts FFN (Mixtral / Grok-1 style).

Port of `repro.models.moe` with its exact semantics: an f32 router,
the top-k experts of each token in descending order of probability
(the lower expert first on a tie, as ``lax.top_k``: a stable sort here),
their weights renormalised; tokens slotted into per-expert buffers of a
fixed capacity by an exclusive cumulative sum over the (token, k) pairs
in token-major order, the pairs past the capacity dropped; the experts
as one batched product over the expert dimension; the outputs combined
with the routing weights in f32. Dropped pairs add nothing (the
residual stream carries the token). Aux terms: the Switch load-balance
loss, the router z-loss and the share of pairs dropped.

The combine is a (T, K, D) product summed over K in k order, not an
atomic scatter-add, so it is deterministic on the card for any top-k.
`moe_ffn_local` without a mesh is `moe_ffn`, as in the reference; on a
mesh it is the shard-local dispatch (each data shard slots its own
tokens, the experts' ff dim split over "model", one all-reduce).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["combine", "init_moe", "moe_ffn", "moe_ffn_local", "route"]


def init_moe(d_model: int, d_ff: int, num_experts: int, dtype, *, generator=None,
             device=None) -> dict:
    e = num_experts
    kw = dict(generator=generator, device=device)
    return {
        "router": L.dense_init((d_model, e), torch.float32, **kw),
        "w_gate": L.dense_init((e, d_model, d_ff), dtype, **kw),
        "w_up": L.dense_init((e, d_model, d_ff), dtype, **kw),
        "w_down": L.dense_init((e, d_ff, d_model), dtype, **kw),
    }


def route(router: torch.Tensor, xt: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float) -> dict:
    """The router and the capacity slotting of ``xt`` (T, D): every
    tensor the dispatch and the aux terms need, by the reference's names
    (``experts`` (T, K), ``weights`` (T, K), ``keep`` / ``slot`` (T*K,),
    ``slot_token`` / ``slot_used`` (E*C + 1,), ``capacity``, ``probs``,
    ``logits``)."""
    t = xt.shape[0]
    e = num_experts
    logits = torch.matmul(xt.to(torch.float32), router.to(torch.float32))  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    weights = weights / torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), 1e-9)

    # Python's round (halves to even), as the reference computes it
    capacity = int(max(1, round(t * top_k / e * capacity_factor)))
    flat_expert = experts.reshape(-1)  # (T*K,)
    onehot = F.one_hot(flat_expert, e).to(torch.int32)  # (T*K, E)
    pos_in_expert = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive
    pos = torch.sum(pos_in_expert * onehot, dim=1)  # (T*K,)
    keep = pos < capacity
    slot = flat_expert * capacity + pos
    slot = torch.where(keep, slot, e * capacity)  # the overflow slot, dropped below

    token_of_pair = torch.arange(t, device=xt.device).repeat_interleave(top_k)
    # kept slots are unique; the overflow slot's token is masked by slot_used
    slot_token = torch.zeros((e * capacity + 1,), dtype=torch.int64, device=xt.device)
    slot_token.index_put_((slot,), token_of_pair)
    slot_used = torch.zeros((e * capacity + 1,), dtype=torch.bool, device=xt.device)
    slot_used.index_put_((slot,), keep)
    slot_token = torch.where(slot_used, slot_token, 0)
    return dict(logits=logits, probs=probs, weights=weights, experts=experts,
                capacity=capacity, keep=keep, slot=slot, slot_token=slot_token,
                slot_used=slot_used)


def moe_ffn(params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B,S,D), aux {load_balance_loss, router_z_loss, drop_frac})."""
    out, aux = _moe_core(params, x, num_experts=num_experts, top_k=top_k,
                         capacity_factor=capacity_factor)
    return out.to(x.dtype), aux


def _moe_core(params, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, dict]:
    """`moe_ffn` before its final cast: the combined output in f32."""
    b, s, d = x.shape
    t = b * s
    e = num_experts
    xt = x.reshape(t, d)
    r = route(params["router"], xt, num_experts=e, top_k=top_k,
              capacity_factor=capacity_factor)
    capacity, keep, slot = r["capacity"], r["keep"], r["slot"]

    # --- aux losses ---
    # load balance (Switch): E * sum_e f_e * p_e
    me = torch.mean(r["probs"], dim=0)
    fe = torch.mean(F.one_hot(r["experts"][:, 0], e).to(torch.float32), dim=0)
    load_balance = e * torch.sum(fe * me)
    z = torch.logsumexp(r["logits"], dim=-1)
    z_loss = torch.mean(z * z)

    # --- dispatch: gather each slot's token ---
    slot_used = r["slot_used"][:-1]
    xe = xt[r["slot_token"][:-1]] * slot_used[:, None].to(x.dtype)
    xe = xe.reshape(e, capacity, d)

    # --- expert FFN (batched over E) ---
    g = L.boundary_cast(L._einsum("ecd,edf->ecf", xe, params["w_gate"]), x.dtype)
    u = L.boundary_cast(L._einsum("ecd,edf->ecf", xe, params["w_up"]), x.dtype)
    h = (F.silu(g) * u).to(x.dtype)
    out_dt = L._out_proj_dtype()
    ye = torch.einsum("ecf,efd->ecd", h.to(out_dt), params["w_down"].to(out_dt))
    ye = ye.reshape(e * capacity, d)

    out = combine(ye, slot, keep, r["weights"])

    drop_frac = 1.0 - torch.mean(keep.to(torch.float32))
    aux = {"load_balance_loss": load_balance, "router_z_loss": z_loss, "drop_frac": drop_frac}
    return out.reshape(b, s, d), aux


def combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """(T, D) f32: each token's kept pairs' expert outputs (``ye`` (E*C,
    D) at ``slot``) times their routing ``weights`` (T, K), summed in k
    order (the reference's f32 scatter-add onto tokens)."""
    t, top_k = weights.shape
    pair_w = torch.where(keep, weights.reshape(-1), 0.0)  # (T*K,)
    safe_slot = torch.clamp_max(slot, ye.shape[0] - 1)
    y_pair = (ye[safe_slot] * keep[:, None]) * pair_w[:, None]
    y_pair = y_pair.to(torch.float32).reshape(t, top_k, -1)
    out = y_pair[:, 0]
    for k in range(1, top_k):
        out = out + y_pair[:, k]
    return out


_AUX = ("load_balance_loss", "router_z_loss", "drop_frac")


def moe_ffn_local(params, x: torch.Tensor, *, num_experts: int, top_k: int,
                  capacity_factor: float, mesh=None) -> Tuple[torch.Tensor, dict]:
    """Shard-local MoE dispatch (the reference's ``moe_impl="local"``).

    ``mesh`` (a `DeviceMesh`; by default the one `L.set_sharding_rules`
    installed): ``x`` is this rank's data shard of the tokens, routed and
    slotted on the shard alone, so capacity is enforced per shard (drops
    depend on the shard's own token mix) and no token crosses ranks. The
    experts arrive with their ff dim this rank's block over "model"
    (``w_gate`` / ``w_up`` (E, D, F/m), ``w_down`` (E, F/m, D)) and the
    router whole; the dispatch, expert products and combine on them leave
    the output partial over ff, and one all-reduce over the model group
    completes it, in ``_out_proj_dtype()`` as the dense row-parallel
    products reduce (f32, or bf16 under ``set_tp_reduce_dtype(bf16)``,
    the reference's ``psum`` of the bf16 output), before the cast to
    ``x``'s dtype. The aux terms
    are averaged over the data axes (a SUM, then a divide: the
    reference's ``pmean``). Without a mesh: `moe_ffn` (one shard).
    """
    mesh = mesh if mesh is not None else L._ACTIVE_MESH
    kw = dict(num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor)
    if mesh is None:  # no mesh -> identical math, one shard
        return moe_ffn(params, x, **kw)
    from repro_torch.core.distributed import all_reduce, mesh_axes
    from repro_torch.distributed.sharding import data_axes

    axes = mesh_axes(mesh, data_axes(mesh), "model")
    with L.manual_mode():
        out, aux = _moe_core(params, x, **kw)
    out = out.to(L._out_proj_dtype())
    if axes.model_group is not None:
        all_reduce(out, axes.model_group)  # complete the ff contraction
    out = out.to(x.dtype)
    if axes.data_groups:
        buf = torch.stack([aux[k].to(torch.float32) for k in _AUX])
        for group in axes.data_groups:
            all_reduce(buf, group)
        buf = buf / axes.num_workers
        aux = dict(zip(_AUX, buf.unbind()))
    return out, aux
