"""Shared model layers: norms, RoPE, GQA attention (direct + online-softmax
chunked), SwiGLU/GeGLU MLPs.

Port of the math of `repro.models.layers`. Layers are plain functions
over dict-like parameter groups (a `torch.nn.ParameterDict` or a dict of
tensors) with the reference's names and its ``(d_in, d_out)`` weight
layout. dtype policy, as in the reference: parameters in the config's
dtype, every product the reference marks ``preferred_element_type=f32``
produces f32 (here by upcasting both operands, the plain route) and is
cast where the reference casts; softmax and norms run in f32. Attention
is the reference's einsum and softmax, not a fused library kernel, so
its numbers can be held against the reference.

Tensor parallelism is explicit: a rank-local model
(`repro_torch.distributed.shard_model`) passes its `TP` (the model
group, this rank, the group's size) to the row-parallel products
(`attention_out`, the MLPs' ``w_down``), which produce the local
partial product in ``_out_proj_dtype()``, sum it with one all-reduce
over the model group and then cast, where the reference's partitioner
puts its reduction. Where a product's input is split over channels but
its weight reads every channel (`gather_columns`, `column_parallel`)
the activation is assembled whole first, and a norm over a
channel-split activation reduces its statistics over the group
(`norm_split`). The logical-axis helpers (`set_sharding_rules`,
`logical_to_pspec`, `manual_mode`, `shard`) resolve the reference's
rules; `shard` on a local tensor changes nothing.

Under autograd (grad mode on and the input requiring grad) each of
those collectives is a `torch.autograd.Function` with the backward its
forward implies, Megatron's convention: a tensor every rank of the group
holds whole carries the whole cotangent on every rank. `sum_replicated`
(the row-parallel products' and the vocab-parallel embedding's sum, read
whole by every rank) passes the cotangent through; `sum_partial` (a
norm's statistics, a zero-filled gather: each rank reads its own part of
the sum) sums the ranks' cotangents; `enter` (where a whole activation
or a whole leaf meets a rank's own block of a product or a norm: the
column-parallel products, ``norm_split``'s scale) is the identity and
sums the cotangent in the backward. `gather_columns` assembles an
activation from its column blocks and, by its call site, either sums
the cotangent (each rank then reads only its own part of the whole) or
keeps the rank's own (each rank runs the whole in a computation whose
result every rank reads whole). Without autograd every collective is
the in-place all-reduce it was, so serving issues the same collectives.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = [
    "AttnSpec",
    "TP",
    "all_reduce",
    "apply_rope",
    "attention",
    "attention_chunked",
    "attention_direct",
    "attention_out",
    "boundary_cast",
    "clear_sharding_rules",
    "column_parallel",
    "decode_attention",
    "dense_init",
    "embed_init",
    "enter",
    "gather_columns",
    "init_attention",
    "init_layernorm",
    "init_mlp",
    "init_mlp_gelu",
    "init_rmsnorm",
    "layer_norm",
    "logical_to_pspec",
    "manual_mode",
    "mlp_geglu",
    "mlp_gelu",
    "mlp_swiglu",
    "norm_split",
    "qkv_proj",
    "rms_norm",
    "rope_freqs",
    "row_parallel",
    "set_sharding_rules",
    "set_tp_reduce_dtype",
    "shard",
    "sum_partial",
    "sum_replicated",
]

# ---------------------------------------------------------------------------
# logical axis -> mesh axis mapping (MaxText-style logical axis rules)
# ---------------------------------------------------------------------------

# logical axes used in sharding constraints throughout the models
#   "batch"   -> data-parallel axes ("pod","data")
#   "seq"     -> optional sequence sharding (prefill)
#   "embed"   -> FSDP axis ("data")      [weights' d_model dim]
#   "heads"   -> tensor-parallel ("model")
#   "ff"      -> tensor-parallel ("model")
#   "vocab"   -> tensor-parallel ("model")
#   "expert"  -> None (experts iterate locally; ff dim is TP-sharded)
_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": None,
    "lru": "model",
    "kv_seq": "model",  # flash-decoding: cache sequence dim over TP axis
}

_ACTIVE_RULES = dict(_DEFAULT_RULES)
_ACTIVE_MESH_AXES: tuple = ()  # axis names present in the active mesh
_ACTIVE_MESH = None  # the mesh itself (moe_ffn_local's default mesh)


def set_sharding_rules(rules, mesh_axis_names, mesh=None) -> None:
    """Install logical->mesh rules for subsequent shard() calls."""
    global _ACTIVE_RULES, _ACTIVE_MESH_AXES, _ACTIVE_MESH
    _ACTIVE_RULES = dict(_DEFAULT_RULES)
    if rules:
        _ACTIVE_RULES.update(rules)
    _ACTIVE_MESH_AXES = tuple(mesh_axis_names)
    _ACTIVE_MESH = mesh


def clear_sharding_rules() -> None:
    global _ACTIVE_MESH_AXES, _ACTIVE_MESH
    _ACTIVE_MESH_AXES = ()
    _ACTIVE_MESH = None


def logical_to_pspec(logical_axes):
    """Resolve logical axis names to a `PSpec` under the active rules."""
    from repro_torch.distributed.sharding import PSpec

    spec = []
    for ax in logical_axes:
        if ax is None:
            spec.append(None)
            continue
        mesh_ax = _ACTIVE_RULES.get(ax)
        if mesh_ax is None:
            spec.append(None)
        elif isinstance(mesh_ax, tuple):
            present = tuple(m for m in mesh_ax if m in _ACTIVE_MESH_AXES)
            spec.append(present if present else None)
        else:
            spec.append(mesh_ax if mesh_ax in _ACTIVE_MESH_AXES else None)
    return PSpec(*spec)


_MANUAL_DEPTH = [0]  # >0 inside a shard-local region: shard() resolves nothing


class manual_mode:
    """Context manager disabling shard() inside shard-local regions."""

    def __enter__(self):
        _MANUAL_DEPTH[0] += 1

    def __exit__(self, *exc):
        _MANUAL_DEPTH[0] -= 1


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint by logical axes. A local
    tensor already is this rank's block, and the collectives the layout
    implies are issued where it changes (the row-parallel products, the
    assembled q/k/v, the vocab-parallel embedding): ``x`` is returned
    as it is, its values unchanged, on a mesh or not, inside
    `manual_mode` or not."""
    return x


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place in its model (tensor-parallel) group: the
    process group (None for one rank), its rank in it, the group's size."""

    group: object
    rank: int
    size: int


def all_reduce(t: torch.Tensor, tp, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``tp``'s group ("sum", "max" or
    "min"), timed into `core.distributed.COLLECTIVES`; nothing without a
    group. No autograd node: `sum_replicated` and `sum_partial` are the
    differentiable sums."""
    if tp is None or tp.group is None:
        return t
    from repro_torch.core.distributed import all_reduce as _all_reduce

    return _all_reduce(t, tp.group, op=op)


def _recorded(t: torch.Tensor) -> bool:
    """Whether autograd records an op on ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` to reduce into."""
    return t.clone(memory_format=torch.contiguous_format)


class _Sum(torch.autograd.Function):
    """The sum over a group, into a new tensor (a selective checkpoint may
    hold ``t`` as a product it saved, which a sum in place would change);
    the backward passes the cotangent through (``partial`` False) or
    sums it over the group (True)."""

    @staticmethod
    def forward(ctx, t, tp, partial):
        ctx.tp, ctx.partial = tp, partial
        return all_reduce(_copy(t), tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(_copy(g), ctx.tp)
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), ctx.tp), None


def sum_replicated(t: torch.Tensor, tp) -> torch.Tensor:
    """``t`` summed over ``tp``'s group (in place), the sum read whole by
    every rank: a row-parallel product, the vocab-parallel embedding.
    Under autograd the cotangent passes through (Megatron's exit op)."""
    if tp is None or tp.group is None:
        return t
    if _recorded(t):
        return _Sum.apply(t, tp, False)
    return all_reduce(t, tp)


def sum_partial(t: torch.Tensor, tp) -> torch.Tensor:
    """``t`` summed over ``tp``'s group (in place), each rank reading its
    own part of the sum (a norm's statistics over a channel-split
    activation, a zero-filled gather): under autograd the backward sums
    the ranks' cotangents."""
    if tp is None or tp.group is None:
        return t
    if _recorded(t):
        return _Sum.apply(t, tp, True)
    return all_reduce(t, tp)


def enter(t: torch.Tensor, tp) -> torch.Tensor:
    """``t`` (whole on every rank of ``tp``'s group) where it meets this
    rank's own block of a product or a norm: the identity, and under
    autograd the backward sums the cotangent over the group (Megatron's
    entry op). No collective in the forward."""
    if tp is None or tp.group is None or not _recorded(t):
        return t
    return _Enter.apply(t, tp)


class _Gather(torch.autograd.Function):
    """`gather_block` with its backward: the cotangent summed over the
    group, this rank's block kept (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, whole, dim, tp):
        ctx.tp, ctx.dim, ctx.n = tp, dim, t.shape[dim]
        return _gathered(t, whole, dim, tp)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(_copy(g), ctx.tp)
        # a copy of the block, so the whole buffer is freed at once
        return _copy(g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n)), None, None, None


def _gathered(t: torch.Tensor, whole: int, dim: int, tp) -> torch.Tensor:
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = whole
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, tp.rank * n, n).copy_(t)
    return all_reduce(buf, tp)


def gather_block(t: torch.Tensor, whole: int, dim: int, tp) -> torch.Tensor:
    """The whole of a tensor split along ``dim`` over ``tp``'s group into
    contiguous blocks, ``t`` this rank's (the block at ``tp.rank``), on
    every rank: ``t`` written at its offset into a zero-filled buffer
    ``whole`` long there and summed by one all-reduce (x + 0 = x, so it
    is exact). Under autograd the backward sums the cotangent over the
    group and keeps the rank's block: the reduce-scatter."""
    if _recorded(t):
        return _Gather.apply(t, whole, dim, tp)
    return _gathered(t, whole, dim, tp)


def gather_columns(parts, widths, tp, *, backward: str = "sum") -> list:
    """Whole tensors from column blocks: each of ``parts`` is this rank's
    contiguous block of the last dim of a tensor ``widths[i]`` wide (the
    block at ``tp.rank * block``), or already whole. The split ones are
    written at their offsets into one zero-filled buffer, summed by one
    all-reduce over ``tp``'s group (x + 0 = x, so it is exact: a gather)
    and cut apart again; the whole ones pass as they are. The split
    parts share one dtype.

    Under autograd each part's block takes, by ``backward``:

      * "sum": the cotangent summed over the group (`sum_partial`), where
        each rank then reads only its own part of the whole: the "whole"
        attention layout's ``wo`` (its rows of every head's output),
        `column_parallel`'s products (its columns), a recurrence on its
        own heads;
      * "keep": the rank's own cotangent (`sum_replicated`), where every
        rank reads the whole in a replicated computation whose result
        every rank uses whole, so each already holds the whole cotangent
        (a block a replicated feed-forward reads; summing would count it
        once a rank)."""
    if backward not in ("sum", "keep"):
        raise ValueError(f"unknown backward {backward!r}")
    split = [c.shape[-1] != w for c, w in zip(parts, widths)]
    if not any(split):
        return list(parts)
    lead = next(c for c, sp in zip(parts, split) if sp)
    total = sum(w for w, sp in zip(widths, split) if sp)
    buf = torch.zeros((*lead.shape[:-1], total), dtype=lead.dtype, device=lead.device)
    off, spans = 0, []
    for c, w, sp in zip(parts, widths, split):
        if sp:
            lo = off + tp.rank * c.shape[-1]
            buf[..., lo : lo + c.shape[-1]] = c
            spans.append((off, off + w))
            off += w
        else:
            spans.append(None)
    buf = sum_partial(buf, tp) if backward == "sum" else sum_replicated(buf, tp)
    return [c if span is None else buf[..., span[0] : span[1]]
            for c, span in zip(parts, spans)]


def gather_span(t: torch.Tensor, lo: int, width: int, tp, *, backward: str = "sum"
                ) -> torch.Tensor:
    """The whole of a tensor ``width`` wide in its last dim, of which
    ``t`` is this rank's channels [lo, lo + n), the ranks' spans tiling
    it in any sizes (some may be empty, as uneven heads give): ``t``
    written into a zero-filled buffer, one all-reduce over ``tp``'s group
    (exact, as `gather_columns`, whose ``backward`` it takes)."""
    buf = torch.zeros((*t.shape[:-1], width), dtype=t.dtype, device=t.device)
    buf[..., lo : lo + t.shape[-1]] = t
    return sum_partial(buf, tp) if backward == "sum" else sum_replicated(buf, tp)


def row_parallel_span(x: torch.Tensor, lo: int, width: int, w: torch.Tensor, tp) -> torch.Tensor:
    """``x @ W`` summed over ``tp``'s group, as `row_parallel`, where ``x``
    is this rank's channels [lo, lo + n) of a ``width``-wide activation
    (`gather_span`'s spans) and ``w`` its even row block of ``W`` (width,
    d_out), so the two do not line up: ``x`` is assembled whole
    (`gather_span`, one collective more than `row_parallel`) and cut to
    the row block. Under autograd each rank's cotangent is its row
    block's, summed where assembled. Not cast."""
    rows = w.shape[0]
    whole = gather_span(x, lo, width, tp)
    return row_parallel(whole[..., tp.rank * rows : (tp.rank + 1) * rows], w, tp)


def column_parallel(x: torch.Tensor, width: int, weights, tp) -> list:
    """``x @ w`` (f32) for each of ``weights``, column blocks reading
    every input channel, when ``x`` is this rank's channel block of a
    ``width``-wide activation (or whole): ``x`` is assembled whole first
    (`gather_columns`), then each product is the rank's own columns."""
    (x,) = gather_columns([x], [width], tp)
    return [_dot(x, w) for w in weights]


def norm_split(params, x: torch.Tensor, eps: float, tp, *, kind: str = "rms", lo=None,
               width=None) -> torch.Tensor:
    """`rms_norm` (``kind="rms"``) or `layer_norm` (``"layer"``) over the
    whole last dim when ``x`` holds this rank's contiguous block of it
    (``params`` whole): the statistics' f32 sums are all-reduced over
    ``tp``'s group, then the rank's block is normalised and scaled by its
    block of the scale (and bias). One all-reduce for RMS, two for a
    layer norm (its mean, then its centred second moment, as the
    one-device norm computes them). The block is the even split's, or
    channels [``lo``, ``lo`` + n) of a ``width``-wide whole (uneven
    heads' spans, `gather_span`)."""
    xf = x.to(torch.float32)
    n = x.shape[-1]
    lo = tp.rank * n if lo is None else lo
    width = n * tp.size if width is None else width
    # the whole scale (and bias) meets the rank's block: under autograd the
    # ranks' block gradients are summed into the whole leaf's
    scale = enter(params["scale"], tp)[lo : lo + n].to(torch.float32)
    if kind == "rms":
        var = sum_partial(torch.sum(xf * xf, dim=-1, keepdim=True), tp) / width
        return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
    if kind != "layer":
        raise ValueError(f"unknown norm {kind!r}")
    mu = sum_partial(torch.sum(xf, dim=-1, keepdim=True), tp) / width
    var = sum_partial(torch.sum((xf - mu) ** 2, dim=-1, keepdim=True), tp) / width
    y = (xf - mu) * torch.rsqrt(var + eps) * scale
    return (y + enter(params["bias"], tp)[lo : lo + n].to(torch.float32)).to(x.dtype)


# dtype of the TP output projections' (wo / w_down) products: None is
# f32 accumulation, as in the reference's baseline
_TP_REDUCE_DTYPE = [None]


def set_tp_reduce_dtype(dtype) -> None:
    _TP_REDUCE_DTYPE[0] = dtype


def _out_proj_dtype():
    return _TP_REDUCE_DTYPE[0] or torch.float32


def boundary_cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """Cast an activation at a dot boundary when a TP reduce dtype is set
    (the reference's bf16-TP-reduce option); a no-op otherwise."""
    return t.to(dtype) if _TP_REDUCE_DTYPE[0] is not None else t


def _dot(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` (b: (d_in, d_out)) with the product in ``out_dtype``:
    both operands upcast, so a bf16 product is not rounded before the
    bias add or the cast the reference makes."""
    return torch.matmul(a.to(out_dtype), b.to(out_dtype))


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 einsum of two operands (``preferred_element_type=f32``)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, *, generator=None, device=None, scale: float = 1.0):
    """N(0, (scale / sqrt(fan_in))^2) in f32, cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale / (fan_in ** 0.5)
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * std).to(dtype)


def embed_init(shape, dtype, *, generator=None, device=None):
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, *, device=None) -> dict:
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def layer_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    sliding_window: int = 0  # 0 = unbounded
    chunk: int = 1024
    impl: str = "auto"  # auto | direct | chunked
    decode_seq_shard: bool = False  # flash-decoding cache layout (§Perf)
    gqa_grouped: bool = False  # grouped einsum instead of kv-repeat (§Perf)


def init_attention(d_model: int, spec: AttnSpec, dtype, qkv_bias: bool, *,
                   generator=None, device=None) -> dict:
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    kw = dict(generator=generator, device=device)
    p = {
        "wq": dense_init((d_model, h * hd), dtype, **kw),
        "wk": dense_init((d_model, kvh * hd), dtype, **kw),
        "wv": dense_init((d_model, kvh * hd), dtype, **kw),
        "wo": dense_init((h * hd, d_model), dtype, **kw),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
    return p


def qkv_proj(params, x: torch.Tensor, spec: AttnSpec):
    """(B,S,D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    q = _dot(x, params["wq"])
    k = _dot(x, params["wk"])
    v = _dot(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.to(x.dtype).reshape(b, s, spec.num_heads, spec.head_dim)
    k = k.to(x.dtype).reshape(b, s, spec.num_kv_heads, spec.head_dim)
    v = v.to(x.dtype).reshape(b, s, spec.num_kv_heads, spec.head_dim)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Sk) additive f32 bias: 0 allowed, -inf masked."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, -math.inf)


def attention_direct(q, k, v, spec: AttnSpec, q_pos, k_pos) -> torch.Tensor:
    """Materialized-scores attention. q:(B,Sq,H,hd) k/v:(B,Sk,Hkv,hd)."""
    groups = spec.num_heads // spec.num_kv_heads
    scale = spec.head_dim ** -0.5
    bias = _mask_bias(q_pos, k_pos, spec.causal, spec.sliding_window)
    if spec.gqa_grouped and groups > 1:
        # contract each q-head group against its kv head directly, with no
        # repeated K/V
        b, sq, h, hd = q.shape
        q5 = q.reshape(b, sq, spec.num_kv_heads, groups, hd)
        scores = _einsum("bqhgd,bkhd->bhgqk", q5, k) * scale
        scores = scores + bias[None, None, None]
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = _einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.to(q.dtype).reshape(b, sq, h, hd)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scores = _einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores + bias[None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def attention_chunked(q, k, v, spec: AttnSpec, q_pos, k_pos) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style), a loop in
    place of the reference's scan.

    Never materializes the (Sq, Sk) score matrix: peak extra memory is
    (B, H, Sq, chunk). Exact same math as attention_direct.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    groups = spec.num_heads // spec.num_kv_heads
    chunk = min(spec.chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
    scale = hd ** -0.5
    grouped = spec.gqa_grouped and groups > 1
    hkv = spec.num_kv_heads

    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kci = k[:, c * chunk : (c + 1) * chunk]
        vci = v[:, c * chunk : (c + 1) * chunk]
        pci = k_pos[c * chunk : (c + 1) * chunk]
        if grouped:
            q5 = q.reshape(b, sq, hkv, groups, hd)
            s = (_einsum("bqhgd,bkhd->bhgqk", q5, kci) * scale).reshape(b, h, sq, chunk)
        else:
            s = _einsum("bqhd,bkhd->bhqk", q, _repeat_kv(kci, groups)) * scale
        s = s + _mask_bias(q_pos, pci, spec.causal, spec.sliding_window)[None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard fully-masked rows: m_new may be -inf; exp(-inf - -inf)=nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        denom = denom * alpha + torch.sum(p, dim=-1)
        if grouped:
            p5 = p.to(q.dtype).reshape(b, hkv, groups, sq, chunk)
            pv = _einsum("bhgqk,bkhd->bqhgd", p5, vci).reshape(b, sq, h, hd)
        else:
            pv = _einsum("bhqk,bkhd->bqhd", p.to(q.dtype), _repeat_kv(vci, groups))
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp_min(denom, 1e-30)
    out = acc / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention(q, k, v, spec: AttnSpec, q_pos, k_pos) -> torch.Tensor:
    if spec.num_heads == 0:  # a rank that holds no heads (uneven "q_heads"): empty,
        return q  # and on the graph, so its collectives' backward runs as every rank's
    impl = spec.impl
    if impl == "auto":
        impl = "chunked" if k.shape[1] > 2048 else "direct"
    fn = attention_chunked if impl == "chunked" else attention_direct
    return fn(q, k, v, spec, q_pos, k_pos)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``x @ w`` with ``w``'s rows (and ``x``'s columns) this rank's block
    over ``tp``'s group: the local partial product in
    ``_out_proj_dtype()`` and one all-reduce over the group (bf16 under
    ``set_tp_reduce_dtype(bf16)``). Not cast. Under autograd the sum's
    cotangent passes through (`sum_replicated`)."""
    return sum_replicated(_dot(x, w, _out_proj_dtype()), tp)


def attention_out(params, attn: torch.Tensor, tp=None) -> torch.Tensor:
    b, s, h, hd = attn.shape
    return row_parallel(attn.reshape(b, s, h * hd), params["wo"], tp).to(attn.dtype)


def decode_attention(params, x, cache_k, cache_v, pos, spec: AttnSpec,
                     rope_theta: float = 0.0, tp=None) -> tuple:
    """Single-token decode. x:(B,1,D); cache:(B,Smax,Hkv,hd); pos:(B,)
    int32, equal in every row (the serving engine's one position).

    Returns (attn_out (B,1,D), cache_k, cache_v). The new key and value
    are written into the caches in place at ``pos[0]`` clamped to
    [0, Smax - 1], as the reference's ``dynamic_update_slice`` clamps
    its start: a write past the end overwrites the last slot.
    """
    q, k, v = qkv_proj(params, x, spec)
    if rope_theta:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)
    smax = cache_k.shape[1]
    idx = torch.clamp(pos[:1].to(torch.int64), 0, smax - 1)
    cache_k.index_copy_(1, idx, k)
    cache_v.index_copy_(1, idx, v)
    groups = spec.num_heads // spec.num_kv_heads
    scale = spec.head_dim ** -0.5
    k_pos = torch.arange(smax, dtype=torch.int32, device=x.device)
    valid = k_pos[None, :] <= pos[:, None]
    if spec.sliding_window > 0:
        valid &= k_pos[None, :] > (pos[:, None] - spec.sliding_window)

    if spec.decode_seq_shard:
        # the flash-decoding layout's grouped einsum straight against the
        # cache, with no head repeat (one device: no sharding to apply)
        bq, hk = q.shape[0], spec.num_kv_heads
        q5 = q.reshape(bq, 1, hk, groups, spec.head_dim)
        s = _einsum("bqhgd,bkhd->bhgqk", q5, cache_k) * scale
        s = torch.where(valid[:, None, None, None, :], s, -math.inf)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = _einsum("bhgqk,bkhd->bqhgd", p, cache_v)
        out = o.to(x.dtype).reshape(bq, 1, spec.num_heads, spec.head_dim)
        return attention_out(params, out, tp), cache_k, cache_v

    kk = _repeat_kv(cache_k, groups)
    vv = _repeat_kv(cache_v, groups)
    s = _einsum("bqhd,bkhd->bhqk", q, kk) * scale
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = _einsum("bhqk,bkhd->bqhd", p, vv).to(x.dtype)
    return attention_out(params, out, tp), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d_model: int, d_ff: int, dtype, *, generator=None, device=None) -> dict:
    kw = dict(generator=generator, device=device)
    return {
        "w_gate": dense_init((d_model, d_ff), dtype, **kw),
        "w_up": dense_init((d_model, d_ff), dtype, **kw),
        "w_down": dense_init((d_ff, d_model), dtype, **kw),
    }


def mlp_swiglu(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = enter(x, tp)  # the whole activation meets the ff-split gate and up blocks
    g = boundary_cast(_dot(x, params["w_gate"]), x.dtype)
    u = boundary_cast(_dot(x, params["w_up"]), x.dtype)
    h = shard((F.silu(g) * u).to(x.dtype), "batch", None, "ff")
    return row_parallel(h, params["w_down"], tp).to(x.dtype)


def mlp_geglu(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = enter(x, tp)
    g = boundary_cast(_dot(x, params["w_gate"]), x.dtype)
    u = boundary_cast(_dot(x, params["w_up"]), x.dtype)
    # jax.nn.gelu's default is the tanh approximation
    h = shard((F.gelu(g, approximate="tanh") * u).to(x.dtype), "batch", None, "ff")
    return row_parallel(h, params["w_down"], tp).to(x.dtype)


def init_mlp_gelu(d_model: int, d_ff: int, dtype, *, generator=None, device=None) -> dict:
    kw = dict(generator=generator, device=device)
    return {
        "w_up": dense_init((d_model, d_ff), dtype, **kw),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": dense_init((d_ff, d_model), dtype, **kw),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def mlp_gelu(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The GELU MLP. Under ``tp`` ``w_up`` and ``b_up`` are the rank's ff
    block, ``w_down`` its row block: one all-reduce of the partial
    product, then ``b_down`` (whole) added once."""
    x = enter(x, tp)
    h = _dot(x, params["w_up"]) + params["b_up"].to(torch.float32)
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    if tp is None:
        out = _dot(h, params["w_down"])
    else:
        out = row_parallel(shard(h, "batch", None, "ff"), params["w_down"], tp)
    return (out + params["b_down"].to(torch.float32)).to(x.dtype)
