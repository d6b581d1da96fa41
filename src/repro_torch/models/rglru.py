"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks + local attention.

Port of `repro.models.rglru`. Block pattern (``cfg.block_pattern``,
default "rra"): two RG-LRU recurrence blocks followed by one local
(sliding-window) MQA attention block, cycled over layers.

RG-LRU (Real-Gated Linear Recurrent Unit, De et al. 2024):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))   per-channel decay in (0,1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference evaluates the recurrence with ``lax.associative_scan``
outside any Pallas kernel; here it is a log-depth (Hillis-Steele) scan
of vectorised operations over the sequence, equal in exact arithmetic
(its rounding differs: the twins hold it to their bars), and a single
step at decode. A short depthwise causal conv (width 4) precedes it.

Attention layers cache only the trailing window (O(window) memory).
`prefill` writes the prompt's last ``min(window, s)`` keys into slots
``[:tail]`` in time order and `decode_step` reads the cache as a ring,
``slot = pos % window``, as the reference does; the two agree when the
prompt is at most the window or a multiple of it (the reference's
behaviour past that is kept; ROADMAP Queue C).

A rank-local model (`repro_torch.distributed.shard_model`) holds its
blocks of each parameter and a `ShardPlan` in ``tp``:

  * recurrent blocks ("lru" layout "channels"): ``w_in``,
    ``w_gate_branch``, the conv and the LRU's biases and ``lam`` are the
    rank's channel block, so the branch, its conv, the gate and the scan
    run on the rank's channels; ``w_a`` and ``w_x`` are column blocks
    reading every channel of the conv output ``u``, which is assembled
    whole first (one all-reduce); ``w_out`` is row-parallel (one
    all-reduce). The cache holds the rank's channels of the LRU state
    and the conv tail;
  * attention blocks: the one kv head does not split over the group, so
    each rank attends its own q heads (`transformer.rank_heads`) against
    the assembled kv head (the "q_heads" layout of `transformer`): its
    ``wq`` columns and ``wo`` rows with one all-reduce where the heads
    divide (the smoke config's 2 heads on 2 ranks); where they do not
    (the full config's 10 heads: 3, 3, 2, 2 on 4 ranks, one each on 10
    of 16), q is assembled with k and v and cut to the rank's heads,
    and its output meets ``wo``'s even row block through one collective
    more (`layers.row_parallel_span`); a rank without heads attends
    nothing. The ring cache holds the kv head on every rank that has q
    heads (none on the others);
  * GeGLU MLP: ff-split, one all-reduce after ``w_down``;
  * vocab-parallel embedding and tied logits (`transformer.embed_tokens`,
    `Model.greedy_pick`).

Under the training layout (``shard_model(serving=False)``) every layer's
leaves are read through `Model.weights`, so a block split over "data"
is gathered whole where it is read; under autograd the whole activation
enters the channel blocks (`layers.enter`) and the assembled ``u``, read
only through the rank's gate columns, sums its cotangent.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import Group, Model, model_dtype
from repro_torch.models.layers import AttnSpec
from repro_torch.models.transformer import (
    _placed, _whole, attn_output, attn_project, embed_tokens, heads_spec, unembed,
)

__all__ = [
    "HybridCache", "HybridLM", "block_kind", "init_cache", "init_params", "rg_lru_block",
]

_C = 8.0  # RG-LRU decay sharpness constant (Griffin)


def block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    pattern = cfg.block_pattern or "a"
    return {"r": "recurrent", "a": "attention"}[pattern[layer_idx % len(pattern)]]


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        causal=True,
        sliding_window=cfg.local_window,
        chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_recurrent_block(cfg: ModelConfig, dt, *, generator=None, device=None) -> dict:
    d, w = cfg.d_model, _lru_width(cfg)
    kw = dict(generator=generator, device=device)
    conv = torch.randn((cfg.conv_width, w), generator=generator, device=device,
                       dtype=torch.float32)
    return {
        "w_in": L.dense_init((d, w), dt, **kw),  # branch input proj
        "w_gate_branch": L.dense_init((d, w), dt, **kw),  # GeLU gating branch
        "conv_w": (conv * 0.02).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "w_a": L.dense_init((w, w), dt, **kw),  # recurrence gate
        "b_a": torch.zeros((w,), dtype=dt, device=device),
        "w_x": L.dense_init((w, w), dt, **kw),  # input gate
        "b_x": torch.zeros((w,), dtype=dt, device=device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
        "w_out": L.dense_init((w, d), dt, **kw),
    }


def init_layer(cfg: ModelConfig, layer_idx: int, *, generator=None, device=None) -> dict:
    dt = model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {
        "temporal_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dt, **kw),  # GeGLU applied below
    }
    if block_kind(cfg, layer_idx) == "attention":
        p["attn"] = L.init_attention(cfg.d_model, _attn_spec(cfg), dt, False, **kw)
    else:
        p["rglru"] = init_recurrent_block(cfg, dt, **kw)
    return p


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal temporal conv. x: (B,S,W); w: (K,W).

    With `state` (B, K-1, W) this is the streaming form (decode): returns
    (y, new_state). Without, the full-sequence form with left padding.
    """
    k = w.shape[0]
    if state is None:
        s = x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        y = sum(xp[:, i : i + s, :] * w[i][None, None, :].to(x.dtype) for i in range(k))
        return y + b.to(x.dtype), None
    xs = torch.cat([state, x], dim=1)  # (B, K-1+1, W)
    y = sum(xs[:, i : i + 1, :] * w[i][None, None, :].to(x.dtype) for i in range(k))
    return y + b.to(x.dtype), xs[:, 1:, :]


def _rg_lru_scan(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t (h_{-1} = 0) over dim 1. (B,S,W) f32.

    Hillis-Steele: after the pass at ``shift``, position t holds the
    composition of the pairs (a, x) at t - 2*shift + 1 .. t, combined
    as the reference's ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 +
    b2)``."""
    s = x.shape[1]
    shift = 1
    while shift < s:
        x = torch.cat([x[:, :shift], a[:, shift:] * x[:, :-shift] + x[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return x


def rg_lru_block(p, x: torch.Tensor, *, decode_state=None, tp=None) -> tuple:
    """The full recurrent temporal-mixing block.

    train/prefill: decode_state=None -> returns (y, (h_last, conv_state)).
    decode: decode_state=(h, conv_state), x is (B,1,D) -> (y, new_state).
    With ``tp`` the block's leaves are this rank's channel blocks (see
    the module docstring) and the state its channels.
    """
    dt = x.dtype
    x = L.enter(x, tp)  # the whole activation meets the channel blocks
    branch = L._dot(x, p["w_in"]).to(dt)
    gate = F.gelu(L._dot(x, p["w_gate_branch"]), approximate="tanh").to(dt)

    if decode_state is None:
        u, _ = _causal_conv(branch, p["conv_w"], p["conv_b"])
        conv_tail = branch[:, -(p["conv_w"].shape[0] - 1) :, :]
        h_prev = None
    else:
        h_prev, conv_state = decode_state
        u, conv_tail = _causal_conv(branch, p["conv_w"], p["conv_b"], conv_state)

    # the gates' columns read every channel of u
    ga, gx = L.column_parallel(u, p["w_a"].shape[0], (p["w_a"], p["w_x"]), tp)
    r = torch.sigmoid(ga + p["b_a"].to(torch.float32))
    i = torch.sigmoid(gx + p["b_x"].to(torch.float32))
    lam = p["lam"]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -_C * softplus * r  # (B,S,W) f32, <= 0
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u.to(torch.float32))

    if decode_state is None:
        h = _rg_lru_scan(gated_in, a)
    else:
        h = a * h_prev[:, None, :] + gated_in  # single step, (B,1,W)
    new_state = (h[:, -1, :], conv_tail)

    y = h.to(dt) * gate
    if tp is not None:  # w_out row-parallel
        return L.row_parallel(y, p["w_out"], tp).to(dt), new_state
    return L._dot(y, p["w_out"]).to(dt), new_state


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class HybridCache(NamedTuple):
    """Per-layer state: KV cache for attention layers, (h, conv) for LRU."""

    attn_k: list  # (B, window, Hkv, hd) per attention layer; (B, 0, ...) elsewhere
    attn_v: list
    lru_h: list  # (B, W) f32 per recurrent layer; (B, 0) elsewhere
    conv: list  # (B, K-1, W); (B, 0, W) elsewhere
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None, lru_width=None,
               kv_heads=None) -> HybridCache:
    """Zero state; ``lru_width`` and ``kv_heads`` are a rank-local
    model's (its LRU channels, its cached kv heads), the config's by
    default."""
    dt = model_dtype(cfg)
    w = lru_width or _lru_width(cfg)
    # attention layers only cache the local window (sub-quadratic memory)
    window = min(cfg.local_window, max_len)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (cfg.num_kv_heads if kv_heads is None else kv_heads, cfg.head_dim)
    attn_k, attn_v, lru_h, conv = [], [], [], []
    for li in range(cfg.num_layers):
        attn = block_kind(cfg, li) == "attention"
        attn_k.append(zeros((batch, window if attn else 0, *kv)))
        attn_v.append(zeros((batch, window if attn else 0, *kv)))
        lru_h.append(zeros((batch, 0 if attn else w), torch.float32))
        conv.append(zeros((batch, 0 if attn else cfg.conv_width - 1, w)))
    return HybridCache(attn_k, attn_v, lru_h, conv, 0)


def _first_attn_idx(cfg: ModelConfig) -> int:
    for li in range(cfg.num_layers):
        if block_kind(cfg, li) == "attention":
            return li
    return -1


class HybridLM(Model):
    """The recurrentgemma hybrid with its weights, on one device (tied
    embeddings; weights drawn as the reference draws them, from
    ``generator``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, place=None):
        super().__init__()
        self.cfg = cfg
        dt = model_dtype(cfg)
        kw = dict(generator=generator, device=device)
        # ``place(name, leaf)`` keeps a rank's block of each leaf as it is
        # drawn (`distributed.shard_model`)
        place = place or _whole
        self.embed = Group(
            {"table": place("embed.table", L.embed_init((cfg.vocab_size, cfg.d_model), dt, **kw))}
        )
        self.final_norm = Group(_placed(place, "final_norm",
                                        L.init_rmsnorm(cfg.d_model, dt, device=device)))
        self.layers = nn.ModuleList(
            [Group(_placed(place, f"layers.{i}", init_layer(cfg, i, **kw)))
             for i in range(cfg.num_layers)]
        )
        self.tp = None  # a ShardPlan on a rank-local model

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(self.weights(self.final_norm), x, self.cfg.norm_eps)
        return unembed(self, x, tied=True)  # tied embeddings (vocab-sharded on a rank)

    def _tp(self, part: str):
        """The model group ``part`` ("lru" or "mlp") reduces over, None
        where it is whole."""
        plan = self.tp
        if plan is None:
            return None
        split = plan.layout["lru"] == "channels" if part == "lru" else plan.mlp
        return plan.tp if split else None

    def _mlp(self, lp, h: torch.Tensor) -> torch.Tensor:
        return L.mlp_geglu(lp.mlp, h, self._tp("mlp"))

    def _attend(self, lp, h: torch.Tensor, positions: torch.Tensor) -> tuple:
        cfg = self.cfg
        spec = _attn_spec(cfg)
        q, k, v = attn_project(lp.attn, h, spec, self.tp)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        local = heads_spec(spec, self.tp)
        y = attn_output(lp.attn, L.attention(q, k, v, local, positions[0], positions[0]),
                        self.tp)
        return y, k, v

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)

    def forward(self, tokens: torch.Tensor, **_) -> tuple:
        b, s = tokens.shape
        x = embed_tokens(self, tokens)
        positions = self._positions(b, s)
        for li, lp in enumerate(self.layers):
            x = self.remat(self._block, li, lp, x, positions)
        return self._logits(x), {}

    def _block(self, li: int, lp, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Block ``li`` of `forward`: its temporal mix (RG-LRU or local
        attention) and MLP, each behind an RMSNorm and a residual."""
        cfg = self.cfg
        lp = self.weights(lp)
        h = L.rms_norm(lp.temporal_norm, x, cfg.norm_eps)
        if block_kind(cfg, li) == "attention":
            y = self._attend(lp, h, positions)[0]
        else:
            y, _ = rg_lru_block(lp.rglru, h, tp=self._tp("lru"))
        x = x + y
        h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
        return x + self._mlp(lp, h)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        """Prefill: full forward, capturing terminal recurrent/conv/KV state."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed_tokens(self, tokens)
        positions = self._positions(b, s)
        window = min(cfg.local_window, max_len)
        cache = self.init_cache(b, max_len)
        attn_k, attn_v = list(cache.attn_k), list(cache.attn_v)
        lru_h, conv = list(cache.lru_h), list(cache.conv)
        for li, lp in enumerate(self.layers):
            lp = self.weights(lp)
            h = L.rms_norm(lp.temporal_norm, x, cfg.norm_eps)
            if block_kind(cfg, li) == "attention":
                y, k, v = self._attend(lp, h, positions)
                # keep only the trailing window, in slots [:tail]
                tail = min(window, s)
                attn_k[li][:, :tail] = k[:, -tail:]
                attn_v[li][:, :tail] = v[:, -tail:]
            else:
                y, (h_last, conv_tail) = rg_lru_block(lp.rglru, h, tp=self._tp("lru"))
                lru_h[li] = h_last
                kw = cfg.conv_width - 1
                conv[li] = conv_tail[:, -kw:, :] if s >= kw else F.pad(
                    conv_tail, (0, 0, kw - s, 0))
            x = x + y
            h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + self._mlp(lp, h)
        return self._logits(x), HybridCache(attn_k, attn_v, lru_h, conv, s)

    @torch.no_grad()
    def decode_step(self, cache: HybridCache, token: torch.Tensor) -> tuple:
        cfg = self.cfg
        b = token.shape[0]
        dt = self.dtype
        x = embed_tokens(self, token[:, None])
        pos = torch.full((b,), cache.length, dtype=torch.int32, device=self.device)
        spec = _attn_spec(cfg)
        local = heads_spec(spec, self.tp)
        first = _first_attn_idx(cfg)
        window = cache.attn_k[first].shape[1] if first >= 0 else 0

        attn_k, attn_v = list(cache.attn_k), list(cache.attn_v)
        lru_h, conv = list(cache.lru_h), list(cache.conv)
        for li, lp in enumerate(self.layers):
            lp = self.weights(lp)
            h = L.rms_norm(lp.temporal_norm, x, cfg.norm_eps)
            if block_kind(cfg, li) == "attention":
                # ring-buffer local window: slot = pos % window, written in place
                q, k, v = attn_project(lp.attn, h, spec, self.tp)
                q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
                k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
                slot = (pos[:1] % window).to(torch.int64)
                attn_k[li].index_copy_(1, slot, k)
                attn_v[li].index_copy_(1, slot, v)
                groups = local.num_heads // max(local.num_kv_heads, 1)  # 0: no heads
                kk = torch.repeat_interleave(attn_k[li], groups, dim=2)
                vv = torch.repeat_interleave(attn_v[li], groups, dim=2)
                s = L._einsum("bqhd,bkhd->bhqk", q, kk) * (spec.head_dim ** -0.5)
                ring_pos = torch.arange(window, dtype=torch.int32, device=self.device)
                # a ring slot holds position p iff p <= pos and p > pos - window;
                # recover the stored position from the slot index
                stored = pos[:, None] - ((pos[:, None] - ring_pos[None, :]) % window)
                valid = (stored >= 0) & (stored <= pos[:, None])
                s = torch.where(valid[:, None, None, :], s, -math.inf)
                p_ = torch.softmax(s, dim=-1).to(dt)
                o = L._einsum("bhqk,bkhd->bqhd", p_, vv)
                y = attn_output(lp.attn, o.to(dt), self.tp)
            else:
                y, (h_new, conv_new) = rg_lru_block(
                    lp.rglru, h, decode_state=(lru_h[li], conv[li]), tp=self._tp("lru"))
                lru_h[li], conv[li] = h_new, conv_new
            x = x + y
            h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + self._mlp(lp, h)
        logits = self._logits(x)[:, 0]
        return logits, HybridCache(attn_k, attn_v, lru_h, conv, cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> HybridCache:
        if self.tp is None:
            return init_cache(self.cfg, batch, max_len, device=self.device)
        rec = [lp.rglru for lp in self.layers if "rglru" in lp]
        return init_cache(self.cfg, batch, max_len, device=self.device,
                          lru_width=rec[0]["lam"].shape[0] if rec else None,
                          kv_heads=heads_spec(_attn_spec(self.cfg), self.tp).num_kv_heads)


def init_params(cfg: ModelConfig, *, device, generator=None) -> HybridLM:
    return HybridLM(cfg, device=device, generator=generator)

