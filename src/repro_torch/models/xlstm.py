"""xLSTM: mLSTM (matrix-memory) + sLSTM (scalar-memory) blocks.

Port of `repro.models.xlstm` (Beck et al. 2024, at block granularity):

* mLSTM block: up-projection (factor 2), short causal conv feeding q/k,
  matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T with exponential gating
  and max-stabilizer m_t, gated output, down-projection, in the
  chunk-recurrent form: a loop over chunks carries (C, n, m) and each
  chunk is parallel einsum work (the reference's ``lax.scan`` over
  chunks). Decode is the single-step recurrence.
* sLSTM block: scalar memory with hidden-to-gate recurrence, a loop over
  time (the reference's ``lax.scan``).

One sLSTM block every ``cfg.slstm_every`` blocks, mLSTM elsewhere. Every
dtype cast is the reference's; the recurrences run in f32.

A rank-local model (`repro_torch.distributed.shard_model`) holds its
blocks of each parameter and a `ShardPlan` in ``tp``; its layout says
how each block computes:

  * mLSTM: ``w_up``'s column blocks cut across the [x | z] halves (at 2
    ranks one rank holds the x branch, the other the z gate), so the
    up-projection is assembled whole (one all-reduce); the conv runs on
    the rank's channels and its output is assembled whole too, since
    ``wq`` and ``wk`` read every channel; ``w_if`` (replicated) reads the
    whole x branch. "heads": the cell and its state run on the rank's
    heads (`transformer.rank_heads`: an even share where the heads
    divide over the group, else ceil or floor of it, none on some ranks
    where there are fewer heads than ranks), ``mix_norm`` reduces its
    statistics over the group. Where the heads divide, the rank's
    q / k / v columns are its heads and ``w_down`` is row-parallel;
    where they do not, a column block ends inside a head, so q, k and v
    are assembled whole and cut to the rank's heads, and its channels
    meet ``w_down``'s even row block through one collective more
    (`layers.row_parallel_span`);
  * sLSTM: ``w_gates``' column blocks are whole gates [z, i, f, o]
    while ``r_gates`` splits over heads (or stays whole on every rank
    where they do not divide), so the gate inputs are assembled whole
    (one all-reduce) and each rank runs the recurrence on its
    `transformer.rank_heads`' channels of every gate ("heads"); the
    hidden states are then assembled for ``group_norm`` and the
    feed-forward, which stays whole on every rank where its width does
    not divide (1,023 of xlstm-125m);
  * vocab-parallel embedding (unscaled) and an ``lm_head`` whose column
    blocks give vocab-sharded logits (`Model.greedy_pick`).

Under the training layout (``shard_model(serving=False)``) every layer's
leaves are read through `Model.weights`, so a block split over "data"
(``w_if``'s rows, the gates' and the feed-forward's d_model dim) is
gathered whole where it is read. Under autograd each assembled tensor
takes the backward its readers imply (`layers.gather_columns`): summed
where each rank reads its own part (the mLSTM's up-projection, conv
and q / k / v under "heads", which end in ``w_down``'s row blocks; the
sLSTM's gate inputs), the rank's own where
every rank runs the rest whole (the sLSTM's hidden states before a
replicated feed-forward); a whole leaf or activation read in part
enters it (`layers.enter`: ``w_if``, ``b_i``, ``b_f``, ``b_gates``, a
whole ``r_gates``, the block's input).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import Group, Model, model_dtype
from repro_torch.models.transformer import _placed, _whole, embed_tokens, rank_heads, unembed

__all__ = [
    "MLSTMState", "SLSTMState", "XLSTM", "XLSTMCache", "init_cache", "init_params", "is_slstm",
    "mlstm_block", "slstm_block",
]


def is_slstm(cfg: ModelConfig, layer_idx: int) -> bool:
    if cfg.slstm_every <= 0:
        return False
    return layer_idx % cfg.slstm_every == cfg.slstm_every - 1


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_inner = int(cfg.proj_factor_mlstm * d)
    h = cfg.num_heads
    dh = d_inner // h
    return d, d_inner, h, dh


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _normal(shape, scale: float, dt, *, generator=None, device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * scale).to(dt)


def init_mlstm_block(cfg: ModelConfig, dt, *, generator=None, device=None) -> dict:
    d, d_inner, h, dh = _dims(cfg)
    kw = dict(generator=generator, device=device)
    return {
        "w_up": L.dense_init((d, 2 * d_inner), dt, **kw),
        "conv_w": _normal((4, d_inner), 0.02, dt, **kw),
        "conv_b": torch.zeros((d_inner,), dtype=dt, device=device),
        "wq": L.dense_init((d_inner, d_inner), dt, **kw),
        "wk": L.dense_init((d_inner, d_inner), dt, **kw),
        "wv": L.dense_init((d_inner, d_inner), dt, **kw),
        "w_if": L.dense_init((d_inner, 2 * h), torch.float32, **kw),
        "b_i": torch.zeros((h,), dtype=torch.float32, device=device),
        "b_f": torch.full((h,), 3.0, dtype=torch.float32, device=device),  # forget-dominant
        "mix_norm": L.init_rmsnorm(d_inner, dt, device=device),
        "w_down": L.dense_init((d_inner, d), dt, **kw),
    }


def init_slstm_block(cfg: ModelConfig, dt, *, generator=None, device=None) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    ff = int(cfg.proj_factor_slstm * d)
    kw = dict(generator=generator, device=device)
    zeros = torch.zeros((d,), dtype=torch.float32, device=device)
    return {
        # gates z,i,f,o each (d -> d) input + (dh -> dh per head) recurrent
        "w_gates": L.dense_init((d, 4 * d), dt, **kw),
        "r_gates": _normal((4, h, dh, dh), 0.02, dt, **kw),
        "b_gates": torch.cat([zeros, zeros, torch.full_like(zeros, 3.0), zeros]),  # z,i|f|o
        "group_norm": L.init_rmsnorm(d, dt, device=device),
        "w_ff_gate": L.dense_init((d, ff), dt, **kw),
        "w_ff_up": L.dense_init((d, ff), dt, **kw),
        "w_ff_down": L.dense_init((ff, d), dt, **kw),
    }


def init_layer(cfg: ModelConfig, li: int, *, generator=None, device=None) -> dict:
    dt = model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"norm": L.init_rmsnorm(cfg.d_model, dt, device=device)}
    if is_slstm(cfg, li):
        p["slstm"] = init_slstm_block(cfg, dt, **kw)
    else:
        p["mlstm"] = init_mlstm_block(cfg, dt, **kw)
    return p


# ---------------------------------------------------------------------------
# mLSTM cell: chunk-recurrent evaluation
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B,H,dh,dh) f32 matrix memory
    n: torch.Tensor  # (B,H,dh) f32 normalizer
    m: torch.Tensor  # (B,H) f32 stabilizer
    conv: torch.Tensor  # (B,K-1,d_inner) streaming causal-conv state


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int, state: MLSTMState) -> tuple:
    """q,k,v: (B,S,H,dh); log_i/log_f: (B,S,H). Returns (h (B,S,H,dh), state)."""
    b, s, h, dh = q.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    scale = dh ** -0.5
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    c_mat, n_vec, m = state.c, state.n, state.m  # (B,H,dh,dh), (B,H,dh), (B,H)
    hs = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qi, ki, vi, li, lf = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl]
        bcum = torch.cumsum(lf, dim=1)  # inclusive cumsum of log f
        g = li - bcum  # (B,Cn,H)
        gmax = torch.cummax(g, dim=1).values
        m_t = bcum + torch.maximum(m[:, None, :], gmax)  # (B,Cn,H)

        # inter-chunk: q_t C_prev, scaled exp(m_prev - (m_t - b_t))
        inter_scale = torch.exp(m[:, None, :] + bcum - m_t)  # (B,Cn,H)
        qs = qi * scale
        inter = torch.einsum("bthd,bhde->bthe", qs, c_mat) * inter_scale[..., None]
        inter_n = torch.einsum("bthd,bhd->bth", qs, n_vec) * inter_scale

        # intra-chunk: D[t,s] = exp(g_s - max(m_prev, gmax_t)) for s<=t
        mt_rel = m_t - bcum  # = max(m_prev, gmax_t)
        dmat = torch.exp(g[:, None, :, :] - mt_rel[:, :, None, :])  # (B,t,s,H)
        dmat = torch.where(tri[None, :, :, None], dmat, 0.0)
        qk = torch.einsum("bthd,bshd->btsh", qs, ki)  # (B,t,s,H)
        w = qk * dmat
        intra = torch.einsum("btsh,bshd->bthd", w, vi)
        intra_n = torch.sum(w, dim=2)  # (B,t,H)

        num = inter + intra  # (B,Cn,H,dh)
        den = inter_n + intra_n
        denom = torch.maximum(torch.abs(den), torch.exp(-m_t))
        hs.append(num / denom[..., None])

        # carry update to end of chunk
        b_tot = bcum[:, -1, :]  # (B,H)
        m_last = m_t[:, -1, :]
        c_scale = torch.exp(m + b_tot - m_last)  # (B,H)
        kv_scale = torch.exp(g + (b_tot[:, None, :] - m_last[:, None, :]))  # (B,Cn,H)
        c_mat = c_mat * c_scale[..., None, None] + torch.einsum(
            "bshd,bsh,bshe->bhde", ki, kv_scale, vi)
        n_vec = n_vec * c_scale[..., None] + torch.einsum("bshd,bsh->bhd", ki, kv_scale)
        m = m_last
    h_full = torch.cat(hs, dim=1)[:, :s]
    return h_full, MLSTMState(c_mat, n_vec, m, state.conv)


def _mlstm_step(q, k, v, log_i, log_f, state: MLSTMState) -> tuple:
    """Single-token recurrence. q,k,v: (B,H,dh); log_i/f: (B,H)."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    m_new = torch.maximum(log_f + state.m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + state.m - m_new)
    c = state.c * f_p[..., None, None] + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :]
    )
    n = state.n * f_p[..., None] + i_p[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q * scale, c)
    den = torch.einsum("bhd,bhd->bh", q * scale, n)
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
    return num / denom[..., None], MLSTMState(c, n, m_new, state.conv)


def _zero_mlstm_state(cfg: ModelConfig, b: int, dt, device, *, heads=None,
                      conv_width=None) -> MLSTMState:
    """Zero state; ``heads`` and ``conv_width`` are a rank's (its heads,
    its conv channels), the config's by default."""
    _, d_inner, h, dh = _dims(cfg)
    h = h if heads is None else heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros((b, h, dh, dh), **f32),
        n=torch.zeros((b, h, dh), **f32),
        m=torch.zeros((b, h), **f32),
        conv=torch.zeros((b, 3, conv_width or d_inner), dtype=dt, device=device),
    )


def mlstm_block(p, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                single_step: bool = False, tp=None, layout: str = "replicated") -> tuple:
    """x: (B,S,D). Returns (y (B,S,D), MLSTMState). On a rank-local
    model ``tp`` is the model group and ``layout`` "heads" (see the
    module docstring); the state is then the rank's heads and conv
    channels."""
    d, d_inner, h, dh = _dims(cfg)
    dt = x.dtype
    b, s, _ = x.shape
    f32 = torch.float32
    # Under autograd: "heads" ends in w_down's row blocks, so every tensor
    # assembled below feeds only the rank's part of the output (its
    # cotangent summed over the group, `gather_columns`' "sum"), and a
    # whole leaf read there meets that part (`layers.enter`); "replicated"
    # runs the block whole on every rank ("keep")
    split = layout != "replicated"
    w_up = p["w_up"]  # read once: a leaf split over "data" is gathered where read
    if w_up.shape[-1] != 2 * d_inner:
        x = L.enter(x, tp)  # the whole activation meets w_up's column block
    (up,) = L.gather_columns([L._dot(x, w_up).to(dt)], [2 * d_inner], tp,
                             backward="sum" if split else "keep")
    inner, z = up[..., :d_inner], up[..., d_inner:]
    # this rank's conv channels of the x branch (every channel when replicated)
    c_n = p["conv_b"].shape[0]
    c_lo = tp.rank * c_n if split else 0
    inner_c = inner[..., c_lo : c_lo + c_n]

    # short causal conv on the q/k path (streaming form carries K-1 taps)
    kw = p["conv_w"].shape[0]
    if single_step:
        xs_cat = torch.cat([state.conv.to(dt), inner_c], dim=1)  # (B,K,d)
        conv = sum(
            xs_cat[:, i : i + 1, :] * p["conv_w"][i][None, None, :].to(dt) for i in range(kw)
        ) + p["conv_b"].to(dt)
        new_conv_state = xs_cat[:, 1:, :]
    else:
        xp = F.pad(inner_c, (0, 0, kw - 1, 0))
        conv = sum(
            xp[:, i : i + s, :] * p["conv_w"][i][None, None, :].to(dt) for i in range(kw)
        ) + p["conv_b"].to(dt)
        new_conv_state = xp[:, s : s + kw - 1, :]  # last K-1 inputs
    conv = F.silu(conv.to(f32)).to(dt)
    (conv,) = L.gather_columns([conv], [d_inner], tp)  # wq / wk read every channel

    qkv = [L._dot(conv, p["wq"]).to(dt), L._dot(conv, p["wk"]).to(dt),
           L._dot(inner, p["wv"]).to(dt)]
    h_lo, h_hi = rank_heads(h, tp) if split else (0, h)
    even = not split or h % tp.size == 0
    if not even:  # a column block ends inside a head: assembled, cut to the rank's heads
        qkv = [t[..., h_lo * dh : h_hi * dh] for t in L.gather_columns(qkv, [d_inner] * 3, tp)]
    h_n = h_hi - h_lo
    q, k, v = (t.reshape(b, s, h_n, dh) for t in qkv)
    w_if, b_i, b_f = (L.enter(p[n], tp) if split else p[n] for n in ("w_if", "b_i", "b_f"))
    gates = torch.matmul(inner.to(f32), w_if)  # (B,S,2H)
    log_i = (gates[..., :h] + b_i)[..., h_lo:h_hi]
    log_f = F.logsigmoid(gates[..., h:] + b_f)[..., h_lo:h_hi]

    if state is None:
        state = _zero_mlstm_state(cfg, b, dt, x.device, heads=h_n, conv_width=c_n)
    if single_step:
        h_out, state = _mlstm_step(
            q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32), log_i[:, 0], log_f[:, 0], state)
        h_out = h_out[:, None]
    else:
        h_out, state = _mlstm_chunk_scan(
            q.to(f32), k.to(f32), v.to(f32), log_i, log_f, cfg.mlstm_chunk, state)
    state = state._replace(conv=new_conv_state)
    h_out = h_out.reshape(b, s, h_n * dh).to(dt)
    if not split:
        y = L.rms_norm(p["mix_norm"], h_out, cfg.norm_eps) * F.silu(z.to(f32)).to(dt)
        return L._dot(y, p["w_down"]).to(dt), state
    # the rank's heads: its channels of h, z and w_down's rows
    h_mixed = L.norm_split(p["mix_norm"], h_out, cfg.norm_eps, tp, lo=h_lo * dh, width=d_inner)
    y = h_mixed * F.silu(z[..., h_lo * dh : h_hi * dh].to(f32)).to(dt)
    if even:
        return L.row_parallel(y, p["w_down"], tp).to(dt), state
    return L.row_parallel_span(y, h_lo * dh, d_inner, p["w_down"], tp).to(dt), state


# ---------------------------------------------------------------------------
# sLSTM cell: sequential scan
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B,D) f32
    n: torch.Tensor  # (B,D) f32
    h: torch.Tensor  # (B,D) f32
    m: torch.Tensor  # (B,D) f32


def _slstm_scan(r: torch.Tensor, x_gates: torch.Tensor, state: SLSTMState) -> tuple:
    """x_gates: (B,S,4D) input contributions to z,i,f,o gates; r: (4,H,dh,dh)
    the recurrent weights of the H heads whose D = H * dh channels these
    are (a rank's heads, or all of them)."""
    b, s, _ = x_gates.shape
    h_heads, dh = r.shape[1], r.shape[2]
    d = h_heads * dh
    r = r.to(torch.float32)
    st = state
    hs = []
    for t in range(s):
        xg = x_gates[:, t]
        hprev = st.h.reshape(b, h_heads, dh)
        rec = torch.einsum("bhd,ghde->gbhe", hprev, r).reshape(4, b, d)
        zi = xg[:, 0 * d : 1 * d] + rec[0]
        ii = xg[:, 1 * d : 2 * d] + rec[1]
        ff = xg[:, 2 * d : 3 * d] + rec[2]
        oo = xg[:, 3 * d : 4 * d] + rec[3]
        z = torch.tanh(zi)
        o = torch.sigmoid(oo)
        log_f = F.logsigmoid(ff)
        m_new = torch.maximum(log_f + st.m, ii)
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(log_f + st.m - m_new)
        c = f_p * st.c + i_p * z
        n = f_p * st.n + i_p
        h = o * c / torch.clamp_min(n, 1.0)
        st = SLSTMState(c, n, h, m_new)
        hs.append(h)
    return torch.stack(hs, dim=1), st  # (B,S,D)


def slstm_block(p, x: torch.Tensor, cfg: ModelConfig, *, state=None, tp=None,
                layout: str = "replicated", ffn: str = "replicated") -> tuple:
    """x: (B,S,D). Returns (y (B,S,D), SLSTMState). On a rank-local model
    ``tp`` is the model group, ``layout`` "heads" and ``ffn`` "ff" or
    "replicated" (see the module docstring): the state holds the rank's
    heads' channels."""
    b, s, d = x.shape
    dt = x.dtype
    # Under autograd the feed-forward decides the cotangents of the
    # assembled hidden states: a replicated one ("replicated") gives every
    # rank the whole cotangent of the block's output, so they keep the
    # rank's own (`gather_columns`' "keep"); an ff-split one gives each
    # rank its part, summed where assembled, and every whole leaf read on
    # the way meets that part (`layers.enter`). Under "heads" the
    # recurrence runs on the rank's heads, whose gate inputs and bias (and
    # a whole r_gates') slice each rank reads alone
    part = ffn == "ff"
    heads = layout == "heads"
    w_gates = p["w_gates"]  # read once: a leaf split over "data" is gathered where read
    if w_gates.shape[-1] != 4 * d:
        x = L.enter(x, tp)  # the whole activation meets w_gates' column block
    (xg,) = L.gather_columns([L._dot(x, w_gates)], [4 * d], tp,
                             backward="sum" if part or heads else "keep")
    xg = xg + (L.enter(p["b_gates"], tp) if part or heads else p["b_gates"])
    r = p["r_gates"]
    if heads:  # this rank's heads: their channels of each gate
        h_lo, h_hi = rank_heads(cfg.num_heads, tp)
        if r.shape[1] == cfg.num_heads:  # whole: the heads do not divide
            r = L.enter(r, tp)[:, h_lo:h_hi]
        dh = d // cfg.num_heads
        lo, n = h_lo * dh, (h_hi - h_lo) * dh
        xg = torch.cat([xg[..., g * d + lo : g * d + lo + n] for g in range(4)], dim=-1)
    else:
        n = d
    if state is None:
        z = torch.zeros((b, n), dtype=torch.float32, device=x.device)
        state = SLSTMState(z, z, z, z)
    h, state = _slstm_scan(r, xg, state)
    h = h.to(dt)
    if heads:
        h = L.gather_span(h, lo, d, tp, backward="sum" if part else "keep")
    scale = p["group_norm"]["scale"]
    h = L.rms_norm({"scale": L.enter(scale, tp) if part else scale}, h, cfg.norm_eps)
    g = L._dot(h, p["w_ff_gate"])
    u = L._dot(h, p["w_ff_up"])
    y = (F.gelu(g, approximate="tanh") * u).to(dt)
    if ffn == "ff":
        return L.row_parallel(y, p["w_ff_down"], tp).to(dt), state
    return L._dot(y, p["w_ff_down"]).to(dt), state


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


# a one-process model's layout (`ShardPlan.layout` on a rank-local one)
_REPLICATED = {"mlstm": "replicated", "slstm": "replicated", "slstm_ffn": "replicated"}


class XLSTMCache(NamedTuple):
    mlstm: list  # MLSTMState or None per layer
    slstm: list  # SLSTMState or None per layer
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None, mlstm_heads=None,
               conv_width=None, slstm_width=None) -> XLSTMCache:
    """Zero state; the keyword widths are a rank-local model's (its mLSTM
    heads and conv channels, its sLSTM channels), the config's by
    default."""
    dt = model_dtype(cfg)
    ms, ss = [], []
    for li in range(cfg.num_layers):
        if is_slstm(cfg, li):
            z = torch.zeros((batch, cfg.d_model if slstm_width is None else slstm_width),
                            dtype=torch.float32,
                            device=device)
            ss.append(SLSTMState(z, z, z, z))
            ms.append(None)
        else:
            ms.append(_zero_mlstm_state(cfg, batch, dt, device, heads=mlstm_heads,
                                        conv_width=conv_width))
            ss.append(None)
    return XLSTMCache(ms, ss, 0)


class XLSTM(Model):
    """The xLSTM LM with its weights, on one device (an untied ``lm_head``;
    weights drawn as the reference draws them, from ``generator``)."""

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
        self.lm_head = Group(
            {"w": place("lm_head.w", L.dense_init((cfg.d_model, cfg.vocab_size), dt, **kw))}
        )
        self.layers = nn.ModuleList(
            [Group(_placed(place, f"layers.{i}", init_layer(cfg, i, **kw)))
             for i in range(cfg.num_layers)]
        )
        self.tp = None  # a ShardPlan on a rank-local model

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(self.weights(self.final_norm), x, self.cfg.norm_eps)
        return unembed(self, x)  # lm_head, vocab-sharded on a rank

    def _layers(self, x: torch.Tensor, ms: list, ss: list, *, single_step: bool) -> torch.Tensor:
        """Every block over x; ``ms`` / ``ss`` hold each layer's state in
        and take its new state (None in, as `forward` passes, is zero)."""
        for li, lp in enumerate(self.layers):
            states = ss if is_slstm(self.cfg, li) else ms
            x, states[li] = self.remat(self._block, li, lp, x, states[li], single_step)
        return x

    def _block(self, li: int, lp, x: torch.Tensor, state, single_step: bool) -> tuple:
        """Block ``li`` (sLSTM or mLSTM) behind an RMSNorm and a residual,
        from its ``state`` -> (x, its new state)."""
        cfg, plan = self.cfg, self.tp
        tp, lay = (plan.tp, plan.layout) if plan is not None else (None, _REPLICATED)
        lp = self.weights(lp)
        h = L.rms_norm(lp.norm, x, cfg.norm_eps)
        if is_slstm(cfg, li):
            y, state = slstm_block(lp.slstm, h, cfg, state=state, tp=tp, layout=lay["slstm"],
                                   ffn=lay["slstm_ffn"])
        else:
            y, state = mlstm_block(lp.mlstm, h, cfg, state=state, single_step=single_step, tp=tp,
                                   layout=lay["mlstm"])
        return x + y, state

    def forward(self, tokens: torch.Tensor, **_) -> tuple:
        n = self.cfg.num_layers
        x = self._layers(embed_tokens(self, tokens, scale=False), [None] * n, [None] * n,
                         single_step=False)
        return self._logits(x), {}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        b, s = tokens.shape
        cache = self.init_cache(b, max_len)
        ms, ss = list(cache.mlstm), list(cache.slstm)
        x = self._layers(embed_tokens(self, tokens, scale=False), ms, ss, single_step=False)
        return self._logits(x), XLSTMCache(ms, ss, s)

    @torch.no_grad()
    def decode_step(self, cache: XLSTMCache, token: torch.Tensor) -> tuple:
        ms, ss = list(cache.mlstm), list(cache.slstm)
        x = self._layers(embed_tokens(self, token[:, None], scale=False), ms, ss,
                         single_step=True)
        return self._logits(x)[:, 0], XLSTMCache(ms, ss, cache.length + 1)

    def init_cache(self, batch: int, max_len: int) -> XLSTMCache:
        if self.tp is None:
            return init_cache(self.cfg, batch, max_len, device=self.device)
        cfg, lay, size = self.cfg, self.tp.layout, self.tp.model_size
        d_inner = _dims(cfg)[1]
        lo, hi = rank_heads(cfg.num_heads, self.tp.tp) if size > 1 else (0, cfg.num_heads)
        return init_cache(
            cfg, batch, max_len, device=self.device,
            mlstm_heads=hi - lo if lay["mlstm"] == "heads" else cfg.num_heads,
            conv_width=d_inner if lay["mlstm"] == "replicated" else d_inner // size,
            slstm_width=(hi - lo) * (cfg.d_model // cfg.num_heads) if lay["slstm"] == "heads"
            else cfg.d_model)


def init_params(cfg: ModelConfig, *, device, generator=None) -> XLSTM:
    return XLSTM(cfg, device=device, generator=generator)
