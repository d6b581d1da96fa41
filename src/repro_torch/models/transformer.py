"""Decoder-only transformer LM: the dense GQA, MoE and vlm paths.

Port of `repro.models.transformer` for qwen2.5-3b, granite-8b,
llama3-405b, codeqwen1.5-7b, internvl2-76b (text backbone +
vision-stub prefix), mixtral-8x7b and grok-1-314b (MoE FFNs,
`repro_torch.models.moe`).

`Transformer` is a `base.Model` that owns its weights, with the
reference's parameter tree names (``embed.table``, ``layers.<i>.attn.wq``,
``layers.<i>.moe.w_gate``, ...) and its ``(d_in, d_out)`` layout, so the
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
from repro_torch.models.base import Group, Model, TensorSpec, model_dtype
from repro_torch.models.layers import AttnSpec
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_local

__all__ = [
    "KVCache", "TensorSpec", "Transformer", "embed_tokens", "init_cache", "init_layer",
    "init_params", "unembed",
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


# the products "dots" remat keeps: the weight products, which have no batch
# dimensions (attention's products run as bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


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


def embed_tokens(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed["table"][tokens]
    # the scale is cast to the dtype first, as in the reference
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def unembed(model: Model, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits."""
    if model.cfg.tie_embeddings:
        w = model.embed["table"].T
    else:
        w = model.lm_head["w"]
    return L._dot(x, w)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> KVCache:
    dt = model_dtype(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)],
        length=0,
    )


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

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = model_dtype(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = Group({"table": L.embed_init((cfg.vocab_size, cfg.d_model), dt, **kw)})
        self.final_norm = Group(L.init_rmsnorm(cfg.d_model, dt, device=device))
        self.layers = nn.ModuleList(
            [Group(init_layer(cfg, **kw)) for _ in range(cfg.num_layers)]
        )
        if not cfg.tie_embeddings:
            self.lm_head = Group({"w": L.dense_init((cfg.d_model, cfg.vocab_size), dt, **kw)})

    def _ffn(self, lp: Group, h: torch.Tensor, capacity_factor: float) -> tuple:
        """The block's FFN: (y, aux), aux empty for a dense layer."""
        cfg = self.cfg
        if cfg.num_experts == 0:
            return L.mlp_swiglu(lp.mlp, h), {}
        ffn = moe_ffn_local if cfg.moe_impl == "local" else moe_ffn
        return ffn(lp.moe, h, num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                   capacity_factor=capacity_factor)

    def _block(self, lp: Group, x: torch.Tensor, positions: torch.Tensor,
               capacity_factor: float) -> tuple:
        """One block over a whole sequence; returns (x, k, v, aux)."""
        cfg = self.cfg
        spec = _attn_spec(cfg)
        h = L.rms_norm(lp.attn_norm, x, cfg.norm_eps)
        q, k, v = L.qkv_proj(lp.attn, h, spec)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        attn = L.attention(q, k, v, spec, positions[0], positions[0])
        x = x + L.attention_out(lp.attn, attn)
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
        for lp in self.layers:
            x, aux = self._remat_block(lp, x, positions)
            if aux:
                auxes.append(aux)
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        return unembed(self, x), _sum_aux(auxes)

    def _remat_block(self, lp: Group, x: torch.Tensor, positions: torch.Tensor) -> tuple:
        """One block of `forward` -> (x, aux), checkpointed as ``cfg.remat``
        says when autograd records it."""
        remat = self.cfg.remat
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {remat!r}")
        fn = functools.partial(self._block_x, lp, positions=positions)
        if remat == "none" or not torch.is_grad_enabled():
            return fn(x)
        if remat == "full":
            return ckpt.checkpoint(fn, x, use_reentrant=False)
        return ckpt.checkpoint(fn, x, use_reentrant=False, context_fn=_dots_context)

    def _block_x(self, lp: Group, x: torch.Tensor, *, positions: torch.Tensor) -> tuple:
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
        ks, vs = [], []
        for lp in self.layers:
            x, k, v, _ = self._block(lp, x, positions, float(cfg.num_experts))
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
            x = x + self._ffn(lp, h, float(cfg.num_experts))[0]  # dropless at decode
        x = L.rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = unembed(self, x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        return init_cache(self.cfg, batch, max_len, device=self.device)


def init_params(cfg: ModelConfig, *, device, generator=None) -> Transformer:
    """The model with freshly drawn weights (the reference's
    ``init_params``; here the module owns them)."""
    return Transformer(cfg, device=device, generator=generator)
