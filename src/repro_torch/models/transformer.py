"""Decoder-only transformer LM: the dense GQA and vlm paths.

Port of `repro.models.transformer` for qwen2.5-3b, granite-8b,
llama3-405b, codeqwen1.5-7b and internvl2-76b (text backbone +
vision-stub prefix). The MoE variant (mixtral-8x7b, grok-1-314b) is
ROADMAP A12c and raises.

`Transformer` is an `nn.Module` that owns its weights, with the
reference's parameter tree names (``embed.table``, ``layers.<i>.attn.wq``,
...) and its ``(d_in, d_out)`` layout, so the reference's parameters
load by name with no transposes (`repro_torch.convert.lm_params_from_numpy`).
Three entry points, as in the reference, without the ``params``
argument:

  forward(tokens[, vision_embeds]) -> (logits, aux)   (teacher-forced)
  prefill(tokens, max_len) -> (logits, cache)         (serving)
  decode_step(cache, token) -> (logits, cache)        (serving)

Layers always run as a loop over a `ModuleList`: ``scan_layers`` (the
reference's stacked parameters under ``lax.scan``) runs the same layers,
and the converter unstacks its parameters. ``remat`` maps to activation
checkpointing of each block in `forward` while autograd records:
``"full"`` keeps only each block's input and recomputes the block in the
backward pass (``jax.checkpoint``), ``"dots"`` also keeps the block's
weight products (``aten.mm`` / ``aten.addmm``) and recomputes the rest
(``checkpoint_dots_with_no_batch_dims``: the attention products carry
batch dimensions and are recomputed). Parameters start without
gradients (serving); `repro_torch.train.TrainState.create` turns them
on. `prefill` and `decode_step` run without autograd; `decode_step`
writes the new keys and values into the cache's tensors in place.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnSpec

__all__ = [
    "KVCache", "TensorSpec", "Transformer", "embed_tokens", "init_cache", "init_params", "unembed",
]

MOE_ITEM = "ROADMAP A12c (models/moe.py)"


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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


def _group(tensors: dict) -> nn.ParameterDict:
    """A parameter group, gradients off until a train state turns them on."""
    return nn.ParameterDict(
        {name: nn.Parameter(t, requires_grad=False) for name, t in tensors.items()}
    )


# the products "dots" remat keeps: the weight products, which have no batch
# dimensions (attention's products run as bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


class Layer(nn.Module):
    """One transformer block's parameters: attn_norm, attn, mlp_norm, mlp."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        dt = _dtype(cfg)
        kw = dict(generator=generator, device=device)
        self.attn_norm = _group(L.init_rmsnorm(cfg.d_model, dt, device=device))
        self.attn = _group(L.init_attention(cfg.d_model, _attn_spec(cfg), dt, cfg.qkv_bias, **kw))
        self.mlp_norm = _group(L.init_rmsnorm(cfg.d_model, dt, device=device))
        self.mlp = _group(L.init_mlp(cfg.d_model, cfg.d_ff, dt, **kw))


class TensorSpec(NamedTuple):
    """Shape and dtype of a stub input (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


class KVCache(NamedTuple):
    k: list  # per layer (B, S_max, Hkv, hd)
    v: list
    length: int  # tokens already written


def embed_tokens(model: "Transformer", tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed["table"][tokens]
    # the scale is cast to the dtype first, as in the reference
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def unembed(model: "Transformer", x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits."""
    if model.cfg.tie_embeddings:
        w = model.embed["table"].T
    else:
        w = model.lm_head["w"]
    return L._dot(x, w)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> KVCache:
    dt = _dtype(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        length=0,
    )


class Transformer(nn.Module):
    """The dense / vlm decoder LM with its weights, on one device.

    Weights are drawn as the reference draws them (normal f32, scaled,
    cast to ``cfg.dtype``; norms at one, biases at zero) from
    ``generator``, a `torch.Generator` on ``device``; the reference's
    own values load through `convert.lm_params_from_numpy`.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(f"MoE layers are not ported yet: {MOE_ITEM}")
        self.cfg = cfg
        dt = _dtype(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = _group({"table": L.embed_init((cfg.vocab_size, cfg.d_model), dt, **kw)})
        self.final_norm = _group(L.init_rmsnorm(cfg.d_model, dt, device=device))
        self.layers = nn.ModuleList(
            [Layer(cfg, generator=generator, device=device) for _ in range(cfg.num_layers)]
        )
        if not cfg.tie_embeddings:
            self.lm_head = _group({"w": L.dense_init((cfg.d_model, cfg.vocab_size), dt, **kw)})

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["table"].dtype

    def _block(self, lp: Layer, x: torch.Tensor, positions: torch.Tensor) -> tuple:
        """One block over a whole sequence; returns (x, k, v)."""
        cfg = self.cfg
        spec = _attn_spec(cfg)
        h = L.rms_norm(lp.attn_norm, x, cfg.norm_eps)
        q, k, v = L.qkv_proj(lp.attn, h, spec)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        attn = L.attention(q, k, v, spec, positions[0], positions[0])
        x = x + L.attention_out(lp.attn, attn)
        h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
        return x + L.mlp_swiglu(lp.mlp, h), k, v

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
        for lp in self.layers:
            x = self._remat_block(lp, x, positions)
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        return unembed(self, x), {}

    def _remat_block(self, lp: Layer, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One block of `forward`, checkpointed as ``cfg.remat`` says when
        autograd records it."""
        remat = self.cfg.remat
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {remat!r}")
        fn = functools.partial(self._block_x, lp, positions=positions)
        if remat == "none" or not torch.is_grad_enabled():
            return fn(x)
        if remat == "full":
            return ckpt.checkpoint(fn, x, use_reentrant=False)
        return ckpt.checkpoint(fn, x, use_reentrant=False, context_fn=_dots_context)

    def _block_x(self, lp: Layer, x: torch.Tensor, *, positions: torch.Tensor) -> torch.Tensor:
        return self._block(lp, x, positions)[0]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        """Run the prompt through the model, returning logits + filled cache."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed_tokens(self, tokens)
        positions = self._positions(b, s)
        pad = max_len - s
        if pad < 0:
            raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
        ks, vs = [], []
        for lp in self.layers:
            x, k, v = self._block(lp, x, positions)
            ks.append(torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)))
            vs.append(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)))
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        return unembed(self, x), KVCache(k=ks, v=vs, length=s)

    @torch.no_grad()
    def decode_step(self, cache: KVCache, token: torch.Tensor) -> tuple:
        """One decode step. token: (B,) int. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        b = token.shape[0]
        x = embed_tokens(self, token[:, None])
        pos = torch.full((b,), cache.length, dtype=torch.int32, device=self.device)
        spec = _attn_spec(cfg)
        for li, lp in enumerate(self.layers):
            h = L.rms_norm(lp.attn_norm, x, cfg.norm_eps)
            attn_out, _, _ = L.decode_attention(
                lp.attn, h, cache.k[li], cache.v[li], pos, spec, cfg.rope_theta
            )
            x = x + attn_out
            h = L.rms_norm(lp.mlp_norm, x, cfg.norm_eps)
            x = x + L.mlp_swiglu(lp.mlp, h)
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = unembed(self, x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        return init_cache(self.cfg, batch, max_len, device=self.device)

    def extra_input_shapes(self, batch: int, seq: int) -> dict:
        """The modality-frontend stub inputs `forward` takes (vlm)."""
        cfg = self.cfg
        if cfg.frontend == "vision_stub" and cfg.vision_tokens:
            shape = (batch, cfg.vision_tokens, cfg.d_model)
            return {"vision_embeds": TensorSpec(shape, self.dtype)}
        return {}


def init_params(cfg: ModelConfig, *, device, generator=None) -> Transformer:
    """The model with freshly drawn weights (the reference's
    ``init_params``; here the module owns them)."""
    return Transformer(cfg, device=device, generator=generator)
