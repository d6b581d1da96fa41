"""Decoder-only transformer LM: the dense GQA, MoE and vlm paths.

Port of `repro.models.transformer` for qwen2.5-3b, granite-8b,
llama3-405b, codeqwen1.5-7b, internvl2-76b (text backbone +
vision-stub prefix), mixtral-8x7b and grok-1-314b (MoE FFNs,
`repro_torch.models.moe`).

`Transformer` is a `base.Model` that owns its weights, with the
reference's parameter tree names (``embed.table``, ``layers.<i>.attn.wq``,
``layers.<i>.moe.w_gate``, ...; stacked under ``scan_layers``, below) and
its ``(d_in, d_out)`` layout, so the
reference's parameters load by name with no transposes
(`repro_torch.convert.lm_params_from_numpy`). Three entry points, as in
the reference, without the ``params`` argument:

  forward(tokens[, vision_embeds]) -> (logits, aux)   (teacher-forced)
  prefill(tokens, max_len) -> (logits, cache)         (serving)
  decode_step(cache, token) -> (logits, cache)        (serving)

``aux`` holds the MoE terms summed over the layers (empty for a dense
model). `forward` routes at ``cfg.expert_capacity_factor``; `prefill`
and `decode_step` at the dropless capacity ``num_experts``, as the
reference serves, so at full width `forward` can drop tokens that
serving keeps.

Layers always run as a loop. Unrolled, each layer is a group of a
`ModuleList` (``layers.<i>.attn.wq``); under ``scan_layers`` each
per-layer leaf is one ``(L, ...)`` parameter under the reference's
stacked name (``layers.attn.wq``, ``layers.attn_norm.scale``,
``layers.moe.w_gate`` (L, E, D, F)), drawn layer by layer in the
reference's order (so from one seed the stacked model holds exactly the
unrolled one's values), and block i reads the views ``p[i]``
(`base.layer_views`: one ``unbind`` a leaf a pass) where the reference
scans (`forward`) or slices (`prefill`, `decode_step`) the stack. The
forward and the gradients are the unrolled model's; what changes is what
the optimizer sees: a stacked 1-D scale or bias is a matrix, which AdamW
decays and Adafactor factors over the stack, as the reference's stacked
leaves are. ``remat`` checkpoints each block in `forward` while
autograd records (`base.Model.remat`). Parameters start without
gradients (serving); `repro_torch.train.TrainState.create` turns them
on. `prefill` and `decode_step` run without autograd; `decode_step`
writes the new keys and values into the cache's tensors in place.

A rank-local model (`repro_torch.distributed.shard_model`) holds its
blocks of each parameter and a `ShardPlan` in ``tp`` (None on one
device), and issues the collectives the reference's layout implies, all
over the model group:

  * vocab-parallel embedding: ids outside the rank's rows give zero rows,
    then one all-reduce (adding exact zeros keeps the sum exact);
  * attention, "heads": local q/k/v heads from the column blocks, the
    cache head-sharded, one all-reduce after ``wo``; "q_heads" (Hkv not
    divisible by |model|): the rank's q heads (`rank_heads`: a contiguous
    range, H / |model| of them where that divides, else ceil or floor of
    it, some ranks none where H < |model|), k and v assembled whole after
    their column products (one all-reduce of a zero-filled buffer) and
    only the kv heads its q heads read kept (`q_heads_kv`), which the
    cache holds; its q heads attended. Where H divides, q is the rank's
    own ``wq`` columns and its ``wo`` rows take one all-reduce; where it
    does not, a column block ends inside a head, so q is assembled with
    k and v and cut to the rank's heads, and the output meets ``wo``'s
    even row block through one collective more
    (`layers.row_parallel_span`); "whole" (``decode_seq_shard``, or some
    attention leaves whole): q, k and v assembled
    whole, every head attended, the rank's columns into ``wo`` and one
    all-reduce; under ``decode_seq_shard`` the cache's sequence dim is
    split (flash-decoding: a MAX all-reduce of the scores' maxima, a SUM
    of the exp sums, the probabilities cast as the one-device softmax
    casts them, a SUM of the p.V partials; the new key written by the
    rank whose range holds the position);
  * MLP: one all-reduce after ``w_down``; MoE: `moe.moe_ffn_mesh`, the
    global batch's slotting (``moe_impl="gather"``) or each data shard's
    (``"local"``), the experts' ff blocks on the rank's own pairs (sorted
    by expert, or batched over the experts for a few tokens) and one
    all-reduce;
  * column-parallel unembedding: the logits stay vocab-sharded (no
    gather of (B, S, V)); `greedy_pick` reduces the argmax over the group
    (MAX of the values, then MIN of the indices holding it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import Group, Model, TensorSpec, layer_views, model_dtype
from repro_torch.models.layers import AttnSpec
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_local, moe_ffn_mesh

__all__ = [
    "KVCache", "TensorSpec", "Transformer", "attn_output", "attn_project", "embed_tokens",
    "heads_spec", "init_cache", "init_layer", "project_heads", "q_heads_kv",
    "init_params", "rank_heads", "unembed",
]


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        causal=True,
        sliding_window=cfg.sliding_window,
        chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
        decode_seq_shard=cfg.decode_seq_shard,
        gqa_grouped=cfg.attn_gqa_grouped,
    )


def init_layer(cfg: ModelConfig, *, generator=None, device=None) -> dict:
    """One block's parameters: attn_norm, attn, mlp_norm, and mlp or moe."""
    dt = model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
        "attn": L.init_attention(cfg.d_model, _attn_spec(cfg), dt, cfg.qkv_bias, **kw),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if cfg.num_experts > 0:
        p["moe"] = init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts, dt, **kw)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, dt, **kw)
    return p


class KVCache(NamedTuple):
    k: list  # per layer (B, S_max, Hkv, hd)
    v: list
    length: int  # tokens already written
    # a sequence-sharded cache's (first position, S_max); None when whole
    seq: Optional[tuple] = None


def embed_tokens(model: Model, tokens: torch.Tensor, *, scale: bool = True) -> torch.Tensor:
    """The embedding rows of ``tokens``, times sqrt(d_model) unless
    ``scale`` is False (xLSTM and whisper look rows up unscaled). On a
    vocab-sharded table each rank looks up its own rows, zeros elsewhere,
    and one all-reduce sums them."""
    plan = getattr(model, "tp", None)
    table = model.weights(model.embed)["table"]
    if plan is None or plan.vocab is None:
        x = table[tokens]
    else:
        lo, hi = plan.vocab
        local = tokens.to(torch.int64) - lo
        ok = (local >= 0) & (local < hi - lo)
        x = torch.where(ok[..., None], table[torch.where(ok, local, 0)], 0)
    if scale:
        # the scale is cast to the dtype first, as in the reference
        x = x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if plan is not None and plan.vocab is not None:
        x = L.sum_replicated(x, plan.tp)
    return x


def unembed(model: Model, x: torch.Tensor, *, tied: Optional[bool] = None) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits; this rank's vocabulary columns
    (`ShardPlan.logits`) where the unembedding is split. ``tied`` (by
    default the config's ``tie_embeddings``; the RG-LRU hybrid ties its
    table although its config leaves that False): the embedding table's
    transpose, else ``lm_head.w``."""
    if model.cfg.tie_embeddings if tied is None else tied:
        w = model.weights(model.embed)["table"].T
    else:
        w = model.weights(model.lm_head)["w"]
    plan = getattr(model, "tp", None)
    if plan is not None and plan.logits is not None:
        x = L.enter(x, plan.tp)  # the whole activation meets the vocab-split columns
    return L._dot(x, w)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> KVCache:
    dt = model_dtype(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        length=0,
    )


def _placed(place, prefix: str, tree: dict) -> dict:
    """``place(name, leaf)`` over a nested parameter dict, by dotted name."""
    return {k: _placed(place, f"{prefix}.{k}", v) if isinstance(v, dict)
            else place(f"{prefix}.{k}", v) for k, v in tree.items()}


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def _stacked_layers(cfg: ModelConfig, place, **kw) -> dict:
    """The layers' parameters under ``scan_layers``: each leaf stacked on a
    new first dim, drawn layer by layer in the reference's order, each
    layer's leaf placed (``place(stacked name, leaf)``) as it is drawn,
    so one layer is whole at a time."""
    stacks: dict = {}

    def stack(name: str, t: torch.Tensor) -> torch.Tensor:
        t = place(name, t)
        if name not in stacks:
            stacks[name] = t.new_empty((cfg.num_layers,) + tuple(t.shape))
        stacks[name][layer].copy_(t)
        return stacks[name]

    for layer in range(cfg.num_layers):
        tree = _placed(stack, "layers", init_layer(cfg, **kw))
    return tree


_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv"}


def project_heads(p, x: torch.Tensor, spec: AttnSpec, names=("wq", "wk", "wv"), tp=None, *,
                  whole: tuple = ()) -> list:
    """``x @ p[w]`` (plus its bias) for each ``w`` of ``names``, cast to
    ``x``'s dtype and split into heads: (B,S,H,hd) for ``wq``,
    (B,S,Hkv,hd) for ``wk`` / ``wv``, the head counts ``spec``'s. The
    products named in ``whole`` are the rank's column blocks, assembled
    whole by one all-reduce (`layers.gather_columns`); ``spec`` gives the
    heads the others hold. ``tp`` is the group whose column blocks ``p``
    holds (None: whole columns): ``x``, whole on every rank, enters them
    (`layers.enter`)."""
    b, s, _ = x.shape
    x = L.enter(x, tp)
    heads = {"wq": spec.num_heads, "wk": spec.num_kv_heads, "wv": spec.num_kv_heads}
    parts = []
    for w in names:
        c = L._dot(x, p[w])
        if _BIAS[w] in p:
            c = c + p[_BIAS[w]].to(c.dtype)
        parts.append(c.to(x.dtype))
    if whole:
        parts = L.gather_columns(parts, [heads[w] * spec.head_dim if w in whole else c.shape[-1]
                                         for c, w in zip(parts, names)], tp)
    return [c.reshape(b, s, heads[w], spec.head_dim) for c, w in zip(parts, names)]


def rank_heads(num_heads: int, tp) -> tuple:
    """(lo, hi): the contiguous heads model rank ``tp.rank`` of
    ``tp.size`` holds, every head on exactly one rank: ceil(H / m) on
    each of the first H mod m ranks, floor(H / m) (none where H < m) on
    the rest, so rank 0 is a busiest. Where m divides H, rank r's
    heads are its even column block's."""
    share, extra = divmod(num_heads, tp.size)
    lo = tp.rank * share + min(tp.rank, extra)
    return lo, lo + share + (tp.rank < extra)


def q_heads_kv(spec: AttnSpec, tp) -> list:
    """The whole kv heads rank ``tp.rank`` attends with under "q_heads",
    one a local kv head: q head h reads kv head h // (H / Hkv), and the
    rank's q heads are `rank_heads`'. Each kv head they read appears once
    where they read each equally often (a share of one group, or whole
    groups: its q heads then group over them as one device's do), else
    one a q head (a split whose blocks span groups unequally); none for a
    rank without q heads."""
    lo, hi = rank_heads(spec.num_heads, tp)
    group = spec.num_heads // spec.num_kv_heads
    reads = [h // group for h in range(lo, hi)]
    held = sorted(set(reads))
    if all(reads.count(g) * len(held) == hi - lo for g in held):
        return held
    return reads


def _kv_of(t: torch.Tensor, heads: list) -> torch.Tensor:
    """``t``'s (B,S,Hkv,hd) kv heads ``heads``: a slice where they run
    consecutively (none for no heads), else a gather."""
    if not heads or heads == list(range(heads[0], heads[0] + len(heads))):
        first = heads[0] if heads else 0
        return t[:, :, first : first + len(heads)]
    return t.index_select(2, torch.tensor(heads, dtype=torch.int64, device=t.device))


def heads_spec(spec: AttnSpec, plan) -> AttnSpec:
    """``spec`` with this rank's heads under the "heads" and "q_heads"
    layouts (under "q_heads" its `rank_heads` and the kv heads
    `q_heads_kv` keeps)."""
    if plan is None or plan.attn not in ("heads", "q_heads"):
        return spec
    m = plan.model_size
    if plan.attn == "heads":
        return dataclasses.replace(spec, num_heads=spec.num_heads // m,
                                   num_kv_heads=spec.num_kv_heads // m)
    lo, hi = rank_heads(spec.num_heads, plan.tp)
    return dataclasses.replace(spec, num_heads=hi - lo,
                               num_kv_heads=len(q_heads_kv(spec, plan.tp)))


def _reduce_tp(plan) -> Optional[L.TP]:
    """The model group ``wo``'s row blocks reduce over where the rank
    attends its own q heads ("heads", "q_heads"), else None."""
    return plan.tp if plan is not None and plan.attn in ("heads", "q_heads") else None


def attn_project(p, x: torch.Tensor, spec: AttnSpec, plan, names=("wq", "wk", "wv")) -> list:
    """`project_heads` under ``plan``'s attention layout (None: one
    device): assembled whole for "whole"; for "q_heads" q the rank's own
    heads (its columns, or assembled and cut where the heads do not
    divide) and k / v assembled, then cut to the kv heads those q heads
    read (`q_heads_kv`); this rank's heads otherwise."""
    if plan is not None and plan.attn == "q_heads":
        lo, hi = rank_heads(spec.num_heads, plan.tp)
        kv = q_heads_kv(spec, plan.tp)
        even = spec.num_heads % plan.model_size == 0
        parts = project_heads(p, x, dataclasses.replace(spec, num_heads=hi - lo) if even
                              else spec, names, plan.tp,
                              whole=tuple(w for w in names if w != "wq" or not even))
        return [_kv_of(c, kv) if w != "wq" else c if even else c[:, :, lo:hi]
                for c, w in zip(parts, names)]
    whole = names if plan is not None and plan.attn == "whole" else ()
    tp = plan.tp if plan is not None and plan.attn != "replicated" else None
    return project_heads(p, x, spec if whole else heads_spec(spec, plan), names, tp,
                         whole=whole)


def attn_output(p, attn: torch.Tensor, plan) -> torch.Tensor:
    """The attention output (local heads, or every head under "whole")
    through ``wo`` under ``plan``'s layout, reduced over the model group
    where ``wo`` is split; under "q_heads" with heads that do not divide,
    the rank's heads against ``wo``'s even row block through
    `layers.row_parallel_span`."""
    if plan is not None and plan.attn == "whole":
        return _out_whole(p, attn, plan.tp)
    if plan is not None and plan.attn == "q_heads":
        b, s, n, hd = attn.shape
        wo = p["wo"]  # read once: a leaf split over "data" is gathered where read
        width = wo.shape[0] * plan.model_size
        if (width // hd) % plan.model_size:
            lo = rank_heads(width // hd, plan.tp)[0]
            return L.row_parallel_span(attn.reshape(b, s, n * hd), lo * hd, width, wo,
                                       plan.tp).to(attn.dtype)
        return L.attention_out({"wo": wo}, attn, plan.tp)  # not p: a second read gathers again
    return L.attention_out(p, attn, _reduce_tp(plan))


def _out_whole(p, attn: torch.Tensor, tp) -> torch.Tensor:
    """Whole attention output (B,S,H,hd) into ``wo``: the rank's columns
    against its row block and one all-reduce, or the whole product."""
    b, s, h, hd = attn.shape
    flat = attn.reshape(b, s, h * hd)
    wo = p["wo"]  # read once: a leaf split over "data" is gathered where read
    rows = wo.shape[0]
    if rows == h * hd:
        return L.row_parallel(flat, wo).to(attn.dtype)
    flat = flat[..., tp.rank * rows : (tp.rank + 1) * rows]
    return L.row_parallel(flat, wo, tp).to(attn.dtype)


def _decode_assembled(p, x, cache_k, cache_v, position: int, seq, spec: AttnSpec,
                     rope_theta: float, plan) -> torch.Tensor:
    """One decode step of the "whole" and "q_heads" layouts (see the
    module docstring): the rank's heads (`heads_spec`: every head under
    "whole") against this rank's range of cache positions, the softmax's
    max, its sum and the p.V product reduced over the group when the
    cache's sequence dim is split. Writes the new key and value in place
    into the rank whose range holds the position (clamped to S_max - 1,
    as the one-device write is)."""
    b = x.shape[0]
    q, k, v = attn_project(p, x, spec, plan)
    local = heads_spec(spec, plan)
    tp = plan.tp
    pos = torch.full((b,), position, dtype=torch.int32, device=x.device)
    if rope_theta:
        q = L.apply_rope(q, pos[:, None], rope_theta)
        k = L.apply_rope(k, pos[:, None], rope_theta)
    s_loc = cache_k.shape[1]
    lo, smax = seq if seq is not None else (0, s_loc)
    idx = min(max(position, 0), smax - 1)
    if lo <= idx < lo + s_loc:
        at = torch.tensor([idx - lo], dtype=torch.int64, device=x.device)
        cache_k.index_copy_(1, at, k)
        cache_v.index_copy_(1, at, v)
    groups = local.num_heads // max(local.num_kv_heads, 1)  # 0 on a rank without heads
    k_pos = lo + torch.arange(s_loc, dtype=torch.int32, device=x.device)
    valid = k_pos[None, :] <= pos[:, None]
    if spec.sliding_window > 0:
        valid &= k_pos[None, :] > (pos[:, None] - spec.sliding_window)
    q5 = q.reshape(b, 1, local.num_kv_heads, groups, spec.head_dim)
    sc = L._einsum("bqhgd,bkhd->bhgqk", q5, cache_k) * spec.head_dim ** -0.5
    sc = torch.where(valid[:, None, None, None, :], sc, -math.inf)
    m = torch.amax(sc, dim=-1, keepdim=True)
    if seq is not None:
        L.all_reduce(m, tp, op="max")
    e = torch.exp(sc - torch.where(torch.isneginf(m), 0.0, m))
    denom = torch.sum(e, dim=-1, keepdim=True)
    if seq is not None:
        L.all_reduce(denom, tp)
    # the probabilities in the activations' dtype, as the one-device softmax
    probs = (e / denom).to(x.dtype)
    o = L._einsum("bhgqk,bkhd->bqhgd", probs, cache_v)  # (B,1,Hkv,G,hd), partial over S
    if seq is not None:
        L.all_reduce(o, tp)
    out = o.to(x.dtype).reshape(b, 1, local.num_heads, spec.head_dim)
    return attn_output(p, out, plan)


def _sum_aux(auxes: list) -> dict:
    """The layers' aux terms summed leaf by leaf ({} for a dense model)."""
    if not auxes:
        return {}
    return {k: torch.sum(torch.stack([a[k] for a in auxes])) for k in auxes[0]}


class Transformer(Model):
    """The dense / MoE / vlm decoder LM with its weights, on one device.

    Weights are drawn as the reference draws them (normal f32, scaled,
    cast to ``cfg.dtype``; the router in f32; norms at one, biases at
    zero) from ``generator``, a `torch.Generator` on ``device``; the
    reference's own values load through `convert.lm_params_from_numpy`.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator=None, place=None):
        super().__init__()
        self.cfg = cfg
        dt = model_dtype(cfg)
        kw = dict(generator=generator, device=device)
        # ``place(name, leaf)`` keeps a rank's block of each leaf as it is
        # drawn (`distributed.shard_model`); one layer is whole at a time
        place = place or _whole
        self.embed = Group(
            {"table": place("embed.table", L.embed_init((cfg.vocab_size, cfg.d_model), dt, **kw))}
        )
        self.final_norm = Group(_placed(place, "final_norm",
                                        L.init_rmsnorm(cfg.d_model, dt, device=device)))
        if cfg.scan_layers:
            self.layers = Group(_stacked_layers(cfg, place, **kw))
        else:
            self.layers = nn.ModuleList(
                [Group(_placed(place, f"layers.{i}", init_layer(cfg, **kw)))
                 for i in range(cfg.num_layers)]
            )
        if not cfg.tie_embeddings:
            self.lm_head = Group(
                {"w": place("lm_head.w", L.dense_init((cfg.d_model, cfg.vocab_size), dt, **kw))}
            )
        self.tp = None  # a ShardPlan on a rank-local model

    def _layers(self) -> list:
        """Each block's parameter group: the `ModuleList`'s, or under
        ``scan_layers`` layer i's views of the stacked leaves."""
        if self.cfg.scan_layers:
            return layer_views(self.layers, self.cfg.num_layers)
        return list(self.layers)

    def _ffn(self, lp: Group, h: torch.Tensor, capacity_factor: float) -> tuple:
        """The block's FFN: (y, aux), aux empty for a dense layer."""
        cfg, plan = self.cfg, self.tp
        if cfg.num_experts == 0:
            return L.mlp_swiglu(lp.mlp, h, plan.tp if plan is not None and plan.mlp else None), {}
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                  capacity_factor=capacity_factor)
        if plan is not None:
            if cfg.moe_impl not in ("gather", "local"):
                raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
            return moe_ffn_mesh(lp.moe, h, axes=plan.axes, tp=plan.tp,
                                global_slots=cfg.moe_impl == "gather", **kw)
        ffn = moe_ffn_local if cfg.moe_impl == "local" else moe_ffn
        return ffn(lp.moe, h, **kw)

    def _local_spec(self) -> AttnSpec:
        """The attention spec of this rank's heads."""
        return heads_spec(_attn_spec(self.cfg), self.tp)

    def _block(self, lp: Group, x: torch.Tensor, positions: torch.Tensor,
               capacity_factor: float) -> tuple:
        """One block over a whole sequence; returns (x, k, v, aux), k and v
        as this rank's cache holds their heads."""
        cfg, plan = self.cfg, self.tp
        lp = self.weights(lp)
        h = L.rms_norm(lp.attn_norm, x, cfg.norm_eps)
        q, k, v = attn_project(lp.attn, h, _attn_spec(cfg), plan)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        attn = L.attention(q, k, v, self._local_spec(), positions[0], positions[0])
        x = x + attn_output(lp.attn, attn, plan)
        h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
        y, aux = self._ffn(lp, h, capacity_factor)
        return x + y, k, v, aux

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)

    def forward(self, tokens: torch.Tensor, *, vision_embeds: Optional[torch.Tensor] = None
                ) -> tuple:
        """(B, S) tokens -> ((B, S, V) f32 logits, aux dict).

        For VLM configs, `vision_embeds` (B, vision_tokens, D) replaces the
        embeddings of the first `vision_tokens` positions (the stub frontend).
        """
        cfg = self.cfg
        b, s = tokens.shape
        x = embed_tokens(self, tokens)
        if cfg.vision_tokens and vision_embeds is not None:
            nv = cfg.vision_tokens
            x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
        positions = self._positions(b, s)
        auxes = []
        for lp in self._layers():
            x, aux = self.remat(functools.partial(self._block_x, lp, positions=positions), x)
            if aux:
                auxes.append(aux)
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        return unembed(self, x), _sum_aux(auxes)

    def _block_x(self, lp: Group, x: torch.Tensor, *, positions: torch.Tensor) -> tuple:
        """One block of `forward` -> (x, aux), at the training capacity."""
        x, _, _, aux = self._block(lp, x, positions, self.cfg.expert_capacity_factor)
        return x, aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        """Run the prompt through the model, returning logits + filled cache.
        MoE layers route at the dropless capacity ``num_experts``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed_tokens(self, tokens)
        positions = self._positions(b, s)
        pad = max_len - s
        if pad < 0:
            raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
        seq = self._cache_seq(max_len)
        lo, s_loc = (seq[0], max_len // self.tp.model_size) if seq else (0, max_len)
        ks, vs = [], []
        for lp in self._layers():
            x, k, v, _ = self._block(lp, x, positions, float(cfg.num_experts))
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))[:, lo : lo + s_loc]
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))[:, lo : lo + s_loc]
            ks.append(k.contiguous())
            vs.append(v.contiguous())
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        return unembed(self, x), KVCache(k=ks, v=vs, length=s, seq=seq)

    def _cache_seq(self, max_len: int) -> Optional[tuple]:
        """(first position, S_max) of this rank's sequence range when the
        cache's sequence dim is split over "model" (flash-decoding, where
        S_max divides; `sharding.cache_pspecs`), else None."""
        plan = self.tp
        if (plan is None or plan.attn != "whole" or not self.cfg.decode_seq_shard
                or plan.model_size == 1 or max_len % plan.model_size):
            return None
        return (plan.tp.rank * (max_len // plan.model_size), max_len)

    @torch.no_grad()
    def decode_step(self, cache: KVCache, token: torch.Tensor) -> tuple:
        """One decode step. token: (B,) int. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        b = token.shape[0]
        x = embed_tokens(self, token[:, None])
        pos = torch.full((b,), cache.length, dtype=torch.int32, device=self.device)
        plan = self.tp
        spec = self._local_spec()
        for li, lp in enumerate(self._layers()):
            lp = self.weights(lp)
            h = L.rms_norm(lp.attn_norm, x, cfg.norm_eps)
            if plan is not None and plan.attn in ("whole", "q_heads"):
                attn_out = _decode_assembled(lp.attn, h, cache.k[li], cache.v[li], cache.length,
                                            cache.seq, _attn_spec(cfg), cfg.rope_theta, plan)
            else:
                attn_out, _, _ = L.decode_attention(
                    lp.attn, h, cache.k[li], cache.v[li], pos, spec, cfg.rope_theta,
                    _reduce_tp(plan),
                )
            x = x + attn_out
            h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + self._ffn(lp, h, float(cfg.num_experts))[0]  # dropless at decode
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = unembed(self, x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        if self.tp is None:
            return init_cache(self.cfg, batch, max_len, device=self.device)
        seq = self._cache_seq(max_len)
        s_loc = max_len // self.tp.model_size if seq else max_len
        spec = self._local_spec()
        shape = (batch, s_loc, spec.num_kv_heads, self.cfg.head_dim)
        dt = model_dtype(self.cfg)
        return KVCache(
            k=[torch.zeros(shape, dtype=dt, device=self.device)
               for _ in range(self.cfg.num_layers)],
            v=[torch.zeros(shape, dtype=dt, device=self.device)
               for _ in range(self.cfg.num_layers)],
            length=0, seq=seq,
        )


def init_params(cfg: ModelConfig, *, device, generator=None) -> Transformer:
    """The model with freshly drawn weights (the reference's
    ``init_params``; here the module owns them)."""
    return Transformer(cfg, device=device, generator=generator)
