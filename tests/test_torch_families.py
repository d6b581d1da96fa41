"""The port's recurrent and audio families (`repro_torch.models.rglru`,
`xlstm` and `whisper`) against the JAX reference at their smoke sizes,
on the reference's own weights: recurrentgemma-2b, xlstm-125m and
whisper-medium, each in float32 and bfloat16 (tests/torch_lm_twins.py's
checks and bars), and the RG-LRU's windowed cache and ring placement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo, rglru, whisper

ARCHS = ("recurrentgemma_2b", "xlstm_125m", "whisper_medium")
DTYPES = sorted(tw.ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch, dtype):
    assert tw.check_forward(arch, dtype) == {}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, dtype):
    tw.check_prefill_decode(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches(arch, dtype):
    tw.check_serving(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches(arch, dtype):
    tw.check_train_step(arch, dtype)


# ---------------------------------------------------------------------------
# the RG-LRU's window
# ---------------------------------------------------------------------------


def test_hybrid_cache_is_windowed():
    """tests/test_models.py::TestLongContextArchs::test_hybrid_cache_is_windowed
    on the port: decode memory is O(window), not O(max_len)."""
    cfg = tbase.get_smoke_config("recurrentgemma_2b")
    cache = rglru.init_cache(cfg, 1, 8192, device="meta")
    kv = [t.shape[1] for t in cache.attn_k + cache.attn_v if t.ndim == 4]
    assert kv and max(kv) <= cfg.local_window
    assert all(h.shape == (1, cfg.lru_width) for h, kind in zip(
        cache.lru_h, (rglru.block_kind(cfg, i) for i in range(cfg.num_layers)))
        if kind == "recurrent")


def _decode_after(model, toks, prefill: int, max_len: int = 64):
    """Logits of prefill(toks[:, :prefill]) then decode of the rest."""
    logits, cache = model.prefill(toks[:, :prefill], max_len)
    out = [logits]
    for t in range(prefill, toks.shape[1]):
        step, cache = model.decode_step(cache, toks[:, t])
        out.append(step[:, None])
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("prefill", [16, 32])
def test_ring_decode_matches_forward(prefill):
    """A prompt of the window (16) or twice it: prefill's slots [:tail]
    are the ring's, and decode gives `forward`'s logits (f32, window 16,
    40 tokens, max_len 64)."""
    _, _, tm = tw.pair("recurrentgemma_2b", "float32")
    toks = torch.from_numpy(tw.tokens(tm.cfg.vocab_size, (2, 40), seed=1))
    full, _ = tm.forward(toks)
    got = _decode_after(tm, toks, prefill)
    torch.testing.assert_close(got, full, atol=tw.ATOL["float32"], rtol=0)


def test_ring_placement_past_window_is_the_reference():
    """A 24-token prompt with a window of 16: prefill writes positions
    8..23 into slots 0..15 in time order, decode reads slot = pos % 16,
    so decoding attends to other positions than `forward` (the
    reference's behaviour, ROADMAP Queue C). The port keeps it: every
    decode logit is the reference's, and both stand apart from forward."""
    jm, params, tm = tw.pair("recurrentgemma_2b", "float32")
    toks = tw.tokens(tm.cfg.vocab_size, (2, 40), seed=1)
    wl, jcache = jm.prefill(params, jnp.asarray(toks[:, :24]), 64)
    want = [np.asarray(wl)]
    for t in range(24, 40):
        step, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[:, t]))
        want.append(np.asarray(step)[:, None])
    want = np.concatenate(want, axis=1)
    got = _decode_after(tm, torch.from_numpy(toks), 24)
    np.testing.assert_allclose(got.numpy(), want, atol=tw.ATOL["float32"], rtol=0)
    full, _ = tm.forward(torch.from_numpy(toks))
    assert float((got[:, 24:] - full[:, 24:]).abs().max()) > 0.05


# ---------------------------------------------------------------------------
# whisper's stub inputs and positions
# ---------------------------------------------------------------------------


def test_whisper_frames_default_to_zeros_and_positions_wrap():
    """No ``encoder_frames`` is zero frames; `extra_input_shapes` names
    them; the learned decoder table wraps past 448 positions."""
    _, _, tm = tw.pair("whisper_medium", "float32")
    cfg = tm.cfg
    toks = torch.from_numpy(tw.tokens(cfg.vocab_size, (2, 8), seed=4))
    zeros = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
    a, _ = tm.forward(toks)
    b, _ = tm.forward(toks, encoder_frames=zeros)
    assert torch.equal(a, b)
    shapes = tm.extra_input_shapes(2, 8)
    assert shapes == {"encoder_frames": model_zoo.TensorSpec((2, cfg.encoder_seq, cfg.d_model),
                                                             torch.float32)}
    pos = torch.tensor([0, 447, 448, 449, 900])
    assert torch.equal(tm._dec_pos_embed(pos), tm.dec_pos[torch.tensor([0, 447, 0, 1, 4])])
    assert whisper.DEC_POS == 448


def test_whisper_decode_past_448_matches_reference():
    """Decoding across position 448 (prompt 446, 4 steps) gives the
    reference's logits: both wrap the learned table."""
    cfg_kw = dict(encoder_seq=8)
    jm, params, tm = tw.pair("whisper_medium", "float32", **cfg_kw)
    toks = tw.tokens(tm.cfg.vocab_size, (1, 450), seed=5)
    wl, jcache = jm.prefill(params, jnp.asarray(toks[:, :446]), 450)
    gl, tcache = tm.prefill(torch.from_numpy(toks[:, :446]), 450)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=tw.ATOL["float32"], rtol=0)
    decode = jax.jit(jm.decode_step)
    for t in range(446, 450):
        wl, jcache = decode(params, jcache, jnp.asarray(toks[:, t]))
        gl, tcache = tm.decode_step(tcache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=tw.ATOL["float32"], rtol=0)
    assert dataclasses.asdict(tm.cfg)["encoder_seq"] == 8
