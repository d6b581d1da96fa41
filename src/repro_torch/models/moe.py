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
`moe_ffn_local` without a mesh is `moe_ffn`, as in the reference. On a
mesh, `moe_ffn_mesh` runs a rank's rows against its ff blocks of the
experts with either slotting: the global batch's (``moe_impl="gather"``,
what the reference's jitted `moe_ffn` computes, by one small exchange of
the workers' expert counts) or each data shard's own
(``moe_impl="local"``, `moe_ffn_local`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = [
    "batched_buffer", "combine", "init_moe", "moe_ffn", "moe_ffn_local", "moe_ffn_mesh", "route",
]


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
    r = _router(router, xt, top_k)
    # Python's round (halves to even), as the reference computes it
    capacity = int(max(1, round(xt.shape[0] * top_k / num_experts * capacity_factor)))
    r.update(_slots(r["experts"], num_experts, capacity))
    return r


def _router(router: torch.Tensor, xt: torch.Tensor, top_k: int) -> dict:
    """The f32 router on ``xt`` (T, D): logits and probabilities (T, E),
    each token's top-k experts in descending order of probability (the
    lower expert first on a tie) and their renormalised weights."""
    logits = torch.matmul(xt.to(torch.float32), router.to(torch.float32))  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    weights = weights / torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), 1e-9)
    return dict(logits=logits, probs=probs, weights=weights, experts=experts)


def _slots(experts: torch.Tensor, e: int, capacity: int, *, offset=None, rows=None) -> dict:
    """The capacity slotting of the (T, K) ``experts``: each (token, k)
    pair's position among its expert's pairs by an exclusive cumulative
    sum in token-major order, plus ``offset`` (E,) (the pairs routed to
    that expert ahead of these tokens, on a mesh), kept below
    ``capacity``; a kept pair takes slot ``expert * rows + position``
    (its position among these tokens' pairs) of an (E * rows + 1,) table,
    ``rows`` (by default ``capacity``) the buffer's depth an expert. The
    last slot swallows the drops."""
    t, top_k = experts.shape
    rows = capacity if rows is None else rows
    flat_expert = experts.reshape(-1)  # (T*K,)
    onehot = F.one_hot(flat_expert, e).to(torch.int32)  # (T*K, E)
    pos_in_expert = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive
    pos = torch.sum(pos_in_expert * onehot, dim=1)  # (T*K,)
    keep = (pos if offset is None else pos + offset[flat_expert]) < capacity
    slot = flat_expert * rows + pos
    slot = torch.where(keep, slot, e * rows)  # the overflow slot, dropped below

    token_of_pair = torch.arange(t, device=experts.device).repeat_interleave(top_k)
    # kept slots are unique; the overflow slot's token is masked by slot_used
    slot_token = torch.zeros((e * rows + 1,), dtype=torch.int64, device=experts.device)
    slot_token.index_put_((slot,), token_of_pair)
    slot_used = torch.zeros((e * rows + 1,), dtype=torch.bool, device=experts.device)
    slot_used.index_put_((slot,), keep)
    slot_token = torch.where(slot_used, slot_token, 0)
    return dict(capacity=rows, keep=keep, slot=slot, slot_token=slot_token,
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

    out = combine(_expert_ffn(params, xt, r, e, x.dtype), r["slot"], r["keep"], r["weights"])
    return out.reshape(b, s, d), _aux(r, e)


def _aux(r: dict, e: int) -> dict:
    """The aux terms of one shard's routing ``r``: the Switch load-balance
    loss E * sum_e f_e * p_e, the router z-loss, the share of pairs
    dropped."""
    me = torch.mean(r["probs"], dim=0)
    fe = torch.mean(F.one_hot(r["experts"][:, 0], e).to(torch.float32), dim=0)
    z = torch.logsumexp(r["logits"], dim=-1)
    return {"load_balance_loss": e * torch.sum(fe * me), "router_z_loss": torch.mean(z * z),
            "drop_frac": 1.0 - torch.mean(r["keep"].to(torch.float32))}


def _expert_ffn(params, xt: torch.Tensor, r: dict, e: int, dtype) -> torch.Tensor:
    """(E*C, D) in ``_out_proj_dtype()``: each slot's token (``r``'s
    ``slot_token`` where ``slot_used``, else zeros) through its expert's
    SwiGLU, batched over the expert dim (``params``' ff blocks, when
    split, give the partial product over ff)."""
    d = xt.shape[-1]
    capacity = r["capacity"]
    # --- dispatch: gather each slot's token ---
    slot_used = r["slot_used"][:-1]
    xe = xt[r["slot_token"][:-1]] * slot_used[:, None].to(dtype)
    xe = xe.reshape(e, capacity, d)

    # --- expert FFN (batched over E) ---
    g = L.boundary_cast(L._einsum("ecd,edf->ecf", xe, params["w_gate"]), dtype)
    u = L.boundary_cast(L._einsum("ecd,edf->ecf", xe, params["w_up"]), dtype)
    h = (F.silu(g) * u).to(dtype)
    out_dt = L._out_proj_dtype()
    ye = torch.einsum("ecf,efd->ecd", h.to(out_dt), params["w_down"].to(out_dt))
    return ye.reshape(e * capacity, d)


def _pair_ffn(params, xt: torch.Tensor, r: dict, sizes: list, dtype) -> torch.Tensor:
    """(T*K, D) in ``_out_proj_dtype()``: each (token, k) pair's token
    through its expert's SwiGLU, the rows of dropped pairs zero (as
    ``slot_used`` zeroes a slot). The pairs are sorted by expert (token
    order within one) into one (T*K, D) buffer and each expert runs its
    contiguous segment, ``sizes[e]`` rows (its pair count; a split of the
    same rows on the meta device), so the products run T*K rows whatever
    the routing."""
    top_k = r["experts"].shape[1]
    flat = r["experts"].reshape(-1)
    order = torch.sort(flat, stable=True)[1]
    xs = xt[order // top_k] * r["keep"][order][:, None].to(dtype)
    out_dt = L._out_proj_dtype()
    ys = []
    for xe, wg, wu, wd in zip(torch.split(xs, sizes), params["w_gate"].unbind(0),
                              params["w_up"].unbind(0), params["w_down"].unbind(0)):
        g = L.boundary_cast(L._dot(xe, wg), dtype)
        u = L.boundary_cast(L._dot(xe, wu), dtype)
        ys.append(L._dot((F.silu(g) * u).to(dtype), wd, out_dt))
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return torch.cat(ys)[inverse]


def combine(ye: torch.Tensor, slot: Optional[torch.Tensor], keep: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """(T, D) f32: each token's kept pairs' expert outputs (``ye`` (E*C,
    D) at ``slot``, or (T*K, D) a pair where ``slot`` is None) times their
    routing ``weights`` (T, K), summed in k order (the reference's f32
    scatter-add onto tokens)."""
    t, top_k = weights.shape
    pair_w = torch.where(keep, weights.reshape(-1), 0.0)  # (T*K,)
    if slot is not None:
        ye = ye[torch.clamp_max(slot, ye.shape[0] - 1)]
    y_pair = (ye * keep[:, None]) * pair_w[:, None]
    y_pair = y_pair.to(torch.float32).reshape(t, top_k, -1)
    out = y_pair[:, 0]
    for k in range(1, top_k):
        out = out + y_pair[:, k]
    return out


_AUX = ("load_balance_loss", "router_z_loss", "drop_frac")
# The most rows the batched (E, min(C, T)) buffer may run beyond the rank's
# T*K pairs: below it the batched products beat the pairs sorted by expert,
# whose segments cost one host read of the (E,) pair counts and three
# products an expert. tools/torch_moe_buffers.py, mixtral-8x7b's widths in
# bfloat16 on an H100 80GB HBM3 at 700 W: the batched buffer won at up to
# 192 extra rows with the whole ff and 384 with half of it, the sorted
# pairs from 576 on with either (at 3,072, 512 tokens: 2.3x and 2.1x faster).
BATCHED_EXTRA_ROWS = 384


def batched_buffer(num_experts: int, capacity: int, tokens: int, top_k: int) -> bool:
    """Whether `moe_ffn_mesh` runs a rank's expert products in the
    batched (E, min(C, T)) buffer rather than on its T*K pairs sorted by
    expert: where the batched rows exceed the pairs by at most
    `BATCHED_EXTRA_ROWS` (a few tokens, a decode tick's). Top-k picks
    distinct experts, so an expert holds at most one pair a token."""
    return num_experts * min(capacity, tokens) - tokens * top_k <= BATCHED_EXTRA_ROWS


def _segments(counts: torch.Tensor, rows: int) -> list:
    """Each expert's segment of the sorted pairs: its pair count, read
    to the host (one read a call), or on the meta device, where nothing
    can be read, an even split of the same ``rows``."""
    if counts.device.type == "meta":
        e = counts.shape[0]
        return [rows // e + (i < rows % e) for i in range(e)]
    return counts.tolist()


def moe_ffn_local(params, x: torch.Tensor, *, num_experts: int, top_k: int,
                  capacity_factor: float, mesh=None) -> Tuple[torch.Tensor, dict]:
    """Shard-local MoE dispatch (the reference's ``moe_impl="local"``).

    ``mesh`` (a `DeviceMesh`; by default the one `L.set_sharding_rules`
    installed): ``x`` is this rank's data shard of the tokens, routed and
    slotted on the shard alone, so capacity is enforced per shard (drops
    depend on the shard's own token mix) and no token crosses ranks; the
    aux terms are averaged over the data axes (the reference's ``pmean``).
    The experts arrive with their ff dim this rank's block over "model"
    (`moe_ffn_mesh`). Without a mesh: `moe_ffn` (one shard).
    """
    mesh = mesh if mesh is not None else L._ACTIVE_MESH
    kw = dict(num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor)
    if mesh is None:  # no mesh -> identical math, one shard
        return moe_ffn(params, x, **kw)
    from repro_torch.core.distributed import mesh_axes
    from repro_torch.distributed.sharding import data_axes

    axes = mesh_axes(mesh, data_axes(mesh), "model")
    tp = L.TP(axes.model_group, axes.model_rank, axes.model_size)
    return moe_ffn_mesh(params, x, axes=axes, tp=tp, global_slots=False, **kw)


def moe_ffn_mesh(params, x: torch.Tensor, *, num_experts: int, top_k: int,
                 capacity_factor: float, axes, tp, global_slots: bool = True
                 ) -> Tuple[torch.Tensor, dict]:
    """The MoE FFN on a rank of a mesh: ``x`` (B, S, D) this data
    replica's rows (whole over "model"), ``params``' router whole and its
    experts' ff dim this rank's block over ``tp`` (the model group:
    ``w_gate`` / ``w_up`` (E, D, F/m), ``w_down`` (E, F/m, D)); ``axes``
    the rank's `MeshAxes` (its data groups and its worker index over the
    data axes, the order `sharding.batch_pspec` splits rows in).

    ``global_slots`` (``moe_impl="gather"``) computes what the reference's
    jitted `moe_ffn` computes over the global batch: the capacity is
    ``round(T K / E cf)`` of the global T, and a pair's position is its
    exclusive position among its expert's pairs in the global token
    order. A replica's rows are a contiguous block of that order, so the
    position is the pair's local position plus the pairs routed to its
    expert on the workers before this one: each worker's (E,) top-k
    counts are exchanged by one all-reduce of a zero-filled (workers, E)
    buffer over the data axes (none where the capacity holds every pair
    of the global batch). An expert's output for a token does not depend
    on its slot, so each rank runs its own kept pairs and no token
    crosses ranks. The aux terms are the global batch's: the sums
    over data of the routing probabilities, the top-1 counts and the
    squared router log-normalisers, over the global T (the load-balance
    loss a product of global means), ``drop_frac`` from the global kept
    count, the same bits on every rank. With ``global_slots`` False
    (``moe_impl="local"``) each replica slots its own rows at its own
    capacity and the aux terms are the mean over the data axes of each
    replica's.

    The expert products run on the rank's own pairs, in a buffer chosen
    from the shapes alone (`batched_buffer`), and change no routing
    decision: the rank's T*K pairs sorted by expert into one (T*K, D)
    buffer, the dropped pairs' rows zero, each expert on its contiguous
    segment (`_pair_ffn`: T*K rows whatever the routing, one host read of
    the (E,) pair counts a call); or, for a few tokens, the kept pairs
    slotted into an (E, min(C, T), D) buffer batched over the experts,
    with no host read.

    The expert products on the rank's ff block leave the output partial
    over ff: it is summed over ``tp`` in ``_out_proj_dtype()``, as the
    dense row-parallel products reduce, before the cast to ``x``'s dtype.
    Under autograd the tokens and the routing weights enter the ff-split
    experts (`layers.enter`: their cotangents summed over the model
    group), the output's sum passes its cotangent through
    (`layers.sum_replicated`), and the aux sums over data pass theirs
    through: every rank holds the whole aux terms with their whole
    cotangent, so each replica's router gradient is its share of the
    global one (the train step sums them over data and counts the aux
    terms once in the reported loss)."""
    b, s, d = x.shape
    t = b * s
    e = num_experts
    xt = x.reshape(t, d)
    n = axes.num_workers if axes.data_groups else 1
    data = [L.TP(group, 0, 0) for group in axes.data_groups]  # the sums read only the group
    r = _router(params["router"], xt, top_k)
    if global_slots:
        capacity = int(max(1, round(t * n * top_k / e * capacity_factor)))
        # every pair kept where the capacity is at least the global pair count
        dropping = capacity < t * n * top_k
    else:
        capacity = int(max(1, round(t * top_k / e * capacity_factor)))
        dropping = False
    batched = batched_buffer(e, capacity, t, top_k)
    mine = None
    if dropping or not batched:
        flat = r["experts"].reshape(-1)
        # each expert's pair count (a scatter of ones, which the meta
        # device also propagates; bincount has no meta kernel)
        mine = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat))
    counts, offset = None, None
    if dropping:
        counts = mine.to(torch.float32)
        if n > 1:
            buf = torch.zeros((n, e), dtype=torch.float32, device=x.device)
            buf[axes.worker] = counts
            for tp_d in data:
                L.all_reduce(buf, tp_d)
            offset = torch.sum(buf[: axes.worker], dim=0).to(torch.int32)
            counts = torch.sum(buf, dim=0)
    r.update(_slots(r["experts"], e, capacity, offset=offset, rows=min(capacity, t)))

    xd = L.enter(xt, tp)  # the tokens meet the ff-split experts
    if batched:
        ye, slot = _expert_ffn(params, xd, r, e, x.dtype), r["slot"]
    else:
        ye, slot = _pair_ffn(params, xd, r, _segments(mine, t * top_k), x.dtype), None
    out = combine(ye, slot, r["keep"], L.enter(r["weights"], tp))
    out = L.sum_replicated(out.to(L._out_proj_dtype()), tp)  # complete the ff contraction
    out = out.to(x.dtype).reshape(b, s, d)

    if not global_slots:
        local = torch.stack([v.to(torch.float32) for v in _aux(r, e).values()])
        for tp_d in data:
            local = L.sum_replicated(local, tp_d)
        aux = local / n if n > 1 else local
        return out, dict(zip(_AUX, aux.unbind()))
    # (E,) probability sums, the squared log-normalisers' sum, (E,) top-1 counts
    z = torch.logsumexp(r["logits"], dim=-1)
    top1 = torch.sum(F.one_hot(r["experts"][:, 0], e).to(torch.float32), dim=0)
    sums = torch.cat([torch.sum(r["probs"], dim=0), torch.sum(z * z)[None], top1])
    for tp_d in data:
        sums = L.sum_replicated(sums, tp_d)
    t_all = t * n
    kept = (float(t_all * top_k) if counts is None
            else torch.sum(torch.clamp_max(counts, float(capacity))))
    load_balance = e * torch.sum((sums[e + 1 :] / t_all) * (sums[:e] / t_all))
    z_loss = sums[e] / t_all
    drop_frac = 1.0 - torch.as_tensor(kept, dtype=torch.float32, device=x.device) / (t_all * top_k)
    return out, {"load_balance_loss": load_balance, "router_z_loss": z_loss,
                 "drop_frac": drop_frac}
