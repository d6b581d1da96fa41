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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import Group, Model, model_dtype
from repro_torch.models.layers import AttnSpec

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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> WhisperCache:
    dt = model_dtype(cfg)
    kshape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    xshape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    n = cfg.num_layers

    def zeros(shape):
        return [torch.zeros(shape, dtype=dt, device=device) for _ in range(n)]

    return WhisperCache(zeros(kshape), zeros(kshape), zeros(xshape), zeros(xshape), 0)


class Whisper(Model):
    """The encoder-decoder with its weights, on one device (weights drawn
    as the reference draws them, from ``generator``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = model_dtype(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = Group({"table": L.embed_init((cfg.vocab_size, cfg.d_model), dt, **kw)})
        self.enc_layers = nn.ModuleList(
            [Group(init_enc_layer(cfg, dt, **kw)) for _ in range(cfg.encoder_layers)])
        self.enc_norm = Group(L.init_layernorm(cfg.d_model, dt, device=device))
        self.dec_layers = nn.ModuleList(
            [Group(init_dec_layer(cfg, dt, **kw)) for _ in range(cfg.num_layers)])
        self.dec_norm = Group(L.init_layernorm(cfg.d_model, dt, device=device))
        self.dec_pos = nn.Parameter(L.embed_init((DEC_POS, cfg.d_model), dt, **kw),
                                    requires_grad=False)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, D) stub conv-frontend output -> encoder states."""
        cfg = self.cfg
        b, s, d = frames.shape
        x = frames + _sinusoids(s, d, frames.device).to(frames.dtype)[None]
        spec = _spec(cfg, causal=False)
        pos = torch.arange(s, dtype=torch.int32, device=frames.device)
        for lp in self.enc_layers:
            h = L.layer_norm(lp.attn_norm, x, cfg.norm_eps)
            q, k, v = L.qkv_proj(lp.attn, h, spec)
            x = x + L.attention_out(lp.attn, L.attention(q, k, v, spec, pos, pos))
            h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + L.mlp_gelu(lp.mlp, h)
        return L.layer_norm(self.enc_norm, x, cfg.norm_eps)

    def _encoded(self, b: int, encoder_frames: Optional[torch.Tensor]) -> torch.Tensor:
        if encoder_frames is None:
            encoder_frames = torch.zeros((b, self.cfg.encoder_seq, self.cfg.d_model),
                                         dtype=self.dtype, device=self.device)
        return self.encode(encoder_frames)

    def _dec_pos_embed(self, pos: torch.Tensor) -> torch.Tensor:
        return self.dec_pos[pos % self.dec_pos.shape[0]]  # wrap beyond 448

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.layer_norm(self.dec_norm, x, self.cfg.norm_eps)
        return L._dot(x, self.embed["table"].T)  # tied

    def _decoder(self, tokens: torch.Tensor, enc: torch.Tensor, max_len: int = 0) -> tuple:
        """The teacher-forced decoder from position 0; with ``max_len``
        also each layer's self K/V padded to it and the cross K/V."""
        cfg = self.cfg
        s = tokens.shape[1]
        enc_pos = torch.arange(enc.shape[1], dtype=torch.int32, device=enc.device)
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = self.embed["table"][tokens] + self._dec_pos_embed(pos)[None]
        self_spec, cross_spec = _spec(cfg, causal=True), _spec(cfg, causal=False)
        sk, sv, xk, xv = [], [], [], []
        for lp in self.dec_layers:
            h = L.layer_norm(lp.self_norm, x, cfg.norm_eps)
            q, k, v = L.qkv_proj(lp.self_attn, h, self_spec)
            x = x + L.attention_out(lp.self_attn, L.attention(q, k, v, self_spec, pos, pos))
            h = L.layer_norm(lp.cross_norm, x, cfg.norm_eps)
            q, _, _ = L.qkv_proj(lp.cross_attn, h, cross_spec)
            _, ck, cv = L.qkv_proj(lp.cross_attn, enc, cross_spec)
            x = x + L.attention_out(lp.cross_attn,
                                    L.attention(q, ck, cv, cross_spec, pos, enc_pos))
            h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + L.mlp_gelu(lp.mlp, h)
            if max_len:
                pad = (0, 0, 0, 0, 0, max_len - s)
                sk.append(torch.nn.functional.pad(k, pad))
                sv.append(torch.nn.functional.pad(v, pad))
                xk.append(ck)
                xv.append(cv)
        return self._logits(x), (sk, sv, xk, xv)

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
        cfg = self.cfg
        b = token.shape[0]
        pos = torch.full((b,), cache.length, dtype=torch.int32, device=self.device)
        x = self.embed["table"][token[:, None]] + self._dec_pos_embed(pos[:, None])
        self_spec, cross_spec = _spec(cfg, causal=True), _spec(cfg, causal=False)
        groups = cross_spec.num_heads // cross_spec.num_kv_heads
        for li, lp in enumerate(self.dec_layers):
            h = L.layer_norm(lp.self_norm, x, cfg.norm_eps)
            attn_out, _, _ = L.decode_attention(
                lp.self_attn, h, cache.self_k[li], cache.self_v[li], pos, self_spec,
                rope_theta=0.0)
            x = x + attn_out

            h = L.layer_norm(lp.cross_norm, x, cfg.norm_eps)
            q, _, _ = L.qkv_proj(lp.cross_attn, h, cross_spec)
            kk = torch.repeat_interleave(cache.cross_k[li], groups, dim=2)
            vv = torch.repeat_interleave(cache.cross_v[li], groups, dim=2)
            s = L._einsum("bqhd,bkhd->bhqk", q, kk) * (cross_spec.head_dim ** -0.5)
            p = torch.softmax(s, dim=-1).to(x.dtype)
            o = L._einsum("bhqk,bkhd->bqhd", p, vv)
            x = x + L.attention_out(lp.cross_attn, o.to(x.dtype))

            h = L.layer_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + L.mlp_gelu(lp.mlp, h)
        logits = self._logits(x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> WhisperCache:
        return init_cache(self.cfg, batch, max_len, device=self.device)


def init_params(cfg: ModelConfig, *, device, generator=None) -> Whisper:
    return Whisper(cfg, device=device, generator=generator)
