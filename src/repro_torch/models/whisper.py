"""Whisper-style encoder-decoder transformer (audio backbone).

Port of `repro.models.whisper`. Only the transformer backbone is
modelled: the conv mel-spectrogram frontend is a stub, and the encoder
takes precomputed frame embeddings (B, encoder_seq, D) (1500 frames for
30 s of audio). Without ``encoder_frames`` the frames are zeros, as in
the reference (its `ServeEngine` passes no extras, nor does the port's).

Structure (Radford et al. 2022): pre-LN transformer, sinusoidal encoder
positions and a learned 448-entry decoder table (wrapped past 448),
bidirectional encoder self-attention, decoder causal self-attention +
cross-attention, GELU MLPs, LayerNorm, tied unembedding.

A rank-local model (`repro_torch.distributed.shard_model`) holds its
blocks of each parameter and a `ShardPlan` in ``tp``: every attention
(encoder, decoder self and cross) runs on the rank's heads ("heads",
``bq`` / ``bk`` / ``bv`` its blocks, one all-reduce after ``wo``; the
self and cross K/V cached per local head, the cross K/V computed once
at prefill), on the rank's q heads against the kv heads they read where
the kv heads do not split ("q_heads", `transformer.q_heads_kv`;
whisper's heads are all kv heads, so only where its heads do not divide:
each rank its `transformer.rank_heads`, which its configs never give),
or on every head from assembled q / k / v where some attention leaves
stay whole ("whole"); the GELU MLPs are ff-split with
``b_down`` added once after the all-reduce; the embedding and the tied
logits are vocab-sharded where the vocabulary divides (51,865 does not,
so at full size they stay whole); ``dec_pos`` is replicated.

Under the training layout (``shard_model(serving=False)``) every
layer's leaves are read through `Model.weights`, so a block split over
"data" is gathered whole where it is read; ``encoder_frames`` are the
data replica's rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import Group, Model, model_dtype
from repro_torch.models.layers import AttnSpec
from repro_torch.models.transformer import (
    _decode_assembled, _placed, _reduce_tp, _whole, attn_output, attn_project, embed_tokens,
    heads_spec, unembed,
)

__all__ = ["Whisper", "WhisperCache", "init_cache", "init_params"]

DEC_POS = 448  # whisper's maximum target positions


def _spec(cfg: ModelConfig, causal: bool) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        causal=causal,
        chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
    )


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    half = channels // 2
    log_timescale = torch.log(torch.tensor(10_000.0, device=device)) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def init_enc_layer(cfg: ModelConfig, dt, *, generator=None, device=None) -> dict:
    kw = dict(generator=generator, device=device)
    return {
        "attn_norm": L.init_layernorm(cfg.d_model, dt, device=device),
        "attn": L.init_attention(cfg.d_model, _spec(cfg, False), dt, True, **kw),
        "mlp_norm": L.init_layernorm(cfg.d_model, dt, device=device),
        "mlp": L.init_mlp_gelu(cfg.d_model, cfg.d_ff, dt, **kw),
    }


def init_dec_layer(cfg: ModelConfig, dt, *, generator=None, device=None) -> dict:
    kw = dict(generator=generator, device=device)
    return {
        "self_norm": L.init_layernorm(cfg.d_model, dt, device=device),
        "self_attn": L.init_attention(cfg.d_model, _spec(cfg, True), dt, True, **kw),
        "cross_norm": L.init_layernorm(cfg.d_model, dt, device=device),
        "cross_attn": L.init_attention(cfg.d_model, _spec(cfg, False), dt, True, **kw),
        "mlp_norm": L.init_layernorm(cfg.d_model, dt, device=device),
        "mlp": L.init_mlp_gelu(cfg.d_model, cfg.d_ff, dt, **kw),
    }


class WhisperCache(NamedTuple):
    self_k: list  # (B, S_max, Hkv, hd) per decoder layer
    self_v: list
    cross_k: list  # (B, S_enc, Hkv, hd), computed once at prefill
    cross_v: list
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               kv_heads=None) -> WhisperCache:
    """Zero caches; ``kv_heads`` a rank-local model's (its heads), the
    config's by default."""
    dt = model_dtype(cfg)
    kv_heads = cfg.num_kv_heads if kv_heads is None else kv_heads
    kshape = (batch, max_len, kv_heads, cfg.head_dim)
    xshape = (batch, cfg.encoder_seq, kv_heads, cfg.head_dim)
    n = cfg.num_layers

    def zeros(shape):
        return [torch.zeros(shape, dtype=dt, device=device) for _ in range(n)]

    return WhisperCache(zeros(kshape), zeros(kshape), zeros(xshape), zeros(xshape), 0)


class Whisper(Model):
    """The encoder-decoder with its weights, on one device (weights drawn
    as the reference draws them, from ``generator``)."""

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
        self.enc_layers = nn.ModuleList(
            [Group(_placed(place, f"enc_layers.{i}", init_enc_layer(cfg, dt, **kw)))
             for i in range(cfg.encoder_layers)])
        self.enc_norm = Group(_placed(place, "enc_norm",
                                      L.init_layernorm(cfg.d_model, dt, device=device)))
        self.dec_layers = nn.ModuleList(
            [Group(_placed(place, f"dec_layers.{i}", init_dec_layer(cfg, dt, **kw)))
             for i in range(cfg.num_layers)])
        self.dec_norm = Group(_placed(place, "dec_norm",
                                      L.init_layernorm(cfg.d_model, dt, device=device)))
        self.dec_pos = nn.Parameter(
            place("dec_pos", L.embed_init((DEC_POS, cfg.d_model), dt, **kw)), requires_grad=False)
        self.tp = None  # a ShardPlan on a rank-local model

    def _mlp(self, lp, h: torch.Tensor) -> torch.Tensor:
        plan = self.tp
        return L.mlp_gelu(lp.mlp, h, plan.tp if plan is not None and plan.mlp else None)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, D) stub conv-frontend output -> encoder states."""
        cfg = self.cfg
        b, s, d = frames.shape
        x = frames + _sinusoids(s, d, frames.device).to(frames.dtype)[None]
        spec = _spec(cfg, causal=False)
        pos = torch.arange(s, dtype=torch.int32, device=frames.device)
        local = heads_spec(spec, self.tp)
        for lp in self.enc_layers:
            x = self.remat(self._enc_block, lp, x, spec, local, pos)
        return L.layer_norm(self.weights(self.enc_norm), x, cfg.norm_eps)

    def _enc_block(self, lp, x: torch.Tensor, spec, local, pos: torch.Tensor) -> torch.Tensor:
        """One encoder block (bidirectional self-attention, GELU MLP)."""
        cfg = self.cfg
        lp = self.weights(lp)
        h = L.layer_norm(lp.attn_norm, x, cfg.norm_eps)
        q, k, v = attn_project(lp.attn, h, spec, self.tp)
        x = x + attn_output(lp.attn, L.attention(q, k, v, local, pos, pos), self.tp)
        h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
        return x + self._mlp(lp, h)

    def _encoded(self, b: int, encoder_frames: Optional[torch.Tensor]) -> torch.Tensor:
        if encoder_frames is None:
            encoder_frames = torch.zeros((b, self.cfg.encoder_seq, self.cfg.d_model),
                                         dtype=self.dtype, device=self.device)
        return self.encode(encoder_frames)

    def _dec_pos_embed(self, pos: torch.Tensor) -> torch.Tensor:
        return self.dec_pos[pos % self.dec_pos.shape[0]]  # wrap beyond 448

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self, tokens, scale=False) + self._dec_pos_embed(pos)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.layer_norm(self.weights(self.dec_norm), x, self.cfg.norm_eps)
        return unembed(self, x)  # tied; vocab-sharded on a rank where it divides

    def _decoder(self, tokens: torch.Tensor, enc: torch.Tensor, max_len: int = 0) -> tuple:
        """The teacher-forced decoder from position 0; with ``max_len``
        also each layer's self K/V padded to it and the cross K/V."""
        cfg = self.cfg
        s = tokens.shape[1]
        enc_pos = torch.arange(enc.shape[1], dtype=torch.int32, device=enc.device)
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = self._embed(tokens, pos[None])
        self_spec, cross_spec = _spec(cfg, causal=True), _spec(cfg, causal=False)
        self_local, cross_local = heads_spec(self_spec, self.tp), heads_spec(cross_spec, self.tp)
        specs = (self_spec, cross_spec, self_local, cross_local)
        sk, sv, xk, xv = [], [], [], []
        for lp in self.dec_layers:
            x, k, v, ck, cv = self.remat(self._dec_block, lp, x, enc, specs, pos, enc_pos)
            if max_len:
                pad = (0, 0, 0, 0, 0, max_len - s)
                sk.append(torch.nn.functional.pad(k, pad))
                sv.append(torch.nn.functional.pad(v, pad))
                xk.append(ck)
                xv.append(cv)
        return self._logits(x), (sk, sv, xk, xv)

    def _dec_block(self, lp, x: torch.Tensor, enc: torch.Tensor, specs: tuple,
                   pos: torch.Tensor, enc_pos: torch.Tensor) -> tuple:
        """One decoder block over the whole sequence -> (x, self k, self v,
        cross k, cross v)."""
        cfg = self.cfg
        self_spec, cross_spec, self_local, cross_local = specs
        lp = self.weights(lp)
        h = L.layer_norm(lp.self_norm, x, cfg.norm_eps)
        q, k, v = attn_project(lp.self_attn, h, self_spec, self.tp)
        x = x + attn_output(lp.self_attn, L.attention(q, k, v, self_local, pos, pos), self.tp)
        h = L.layer_norm(lp.cross_norm, x, cfg.norm_eps)
        (q,) = attn_project(lp.cross_attn, h, cross_spec, self.tp, ("wq",))
        ck, cv = attn_project(lp.cross_attn, enc, cross_spec, self.tp, ("wk", "wv"))
        x = x + attn_output(lp.cross_attn, L.attention(q, ck, cv, cross_local, pos, enc_pos),
                            self.tp)
        h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
        return x + self._mlp(lp, h), k, v, ck, cv

    def forward(self, tokens: torch.Tensor, *, encoder_frames: Optional[torch.Tensor] = None,
                **_) -> tuple:
        """Teacher-forced decoder over stub-encoded audio."""
        enc = self._encoded(tokens.shape[0], encoder_frames)
        return self._decoder(tokens, enc)[0], {}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, *,
                encoder_frames: Optional[torch.Tensor] = None) -> tuple:
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
        enc = self._encoded(b, encoder_frames)
        logits, kv = self._decoder(tokens, enc, max_len)
        return logits, WhisperCache(*kv, s)

    @torch.no_grad()
    def decode_step(self, cache: WhisperCache, token: torch.Tensor) -> tuple:
        cfg, plan = self.cfg, self.tp
        b = token.shape[0]
        pos = torch.full((b,), cache.length, dtype=torch.int32, device=self.device)
        x = self._embed(token[:, None], pos[:, None])
        self_spec, cross_spec = _spec(cfg, causal=True), _spec(cfg, causal=False)
        self_local, cross_local = heads_spec(self_spec, plan), heads_spec(cross_spec, plan)
        assembled = plan is not None and plan.attn in ("whole", "q_heads")
        groups = cross_local.num_heads // max(cross_local.num_kv_heads, 1)  # 0: no heads
        for li, lp in enumerate(self.dec_layers):
            lp = self.weights(lp)
            h = L.layer_norm(lp.self_norm, x, cfg.norm_eps)
            if assembled:
                attn_out = _decode_assembled(lp.self_attn, h, cache.self_k[li],
                                             cache.self_v[li], cache.length, None, self_spec,
                                             0.0, plan)
            else:
                attn_out, _, _ = L.decode_attention(
                    lp.self_attn, h, cache.self_k[li], cache.self_v[li], pos, self_local,
                    rope_theta=0.0, tp=_reduce_tp(plan))
            x = x + attn_out

            h = L.layer_norm(lp.cross_norm, x, cfg.norm_eps)
            (q,) = attn_project(lp.cross_attn, h, cross_spec, plan, ("wq",))
            kk = torch.repeat_interleave(cache.cross_k[li], groups, dim=2)
            vv = torch.repeat_interleave(cache.cross_v[li], groups, dim=2)
            s = L._einsum("bqhd,bkhd->bhqk", q, kk) * (cross_spec.head_dim ** -0.5)
            p = torch.softmax(s, dim=-1).to(x.dtype)
            o = L._einsum("bhqk,bkhd->bqhd", p, vv)
            x = x + attn_output(lp.cross_attn, o.to(x.dtype), plan)

            h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + self._mlp(lp, h)
        logits = self._logits(x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> WhisperCache:
        return init_cache(self.cfg, batch, max_len, device=self.device,
                          kv_heads=heads_spec(_spec(self.cfg, True), self.tp).num_kv_heads)


def init_params(cfg: ModelConfig, *, device, generator=None) -> Whisper:
    return Whisper(cfg, device=device, generator=generator)
