"""Whether xlstm-125m's bfloat16 scatter is the model's or the port's.

On the card one process's bf16 xlstm-125m lands about 1.0 from the
float32 evaluation of its own weights (largest |logit| 4.3), against
about 0.1 for qwen2.5-3b and recurrentgemma-2b, so phase 14h serves it
in float32. Here both packages run it at full width (d 768, 4 heads,
d_inner 1,536, vocabulary 50,304) and 8 of its 12 layers (the sLSTM at
layer 7 included), on the reference's weights from seed 0, 4 rows of 64
tokens and 3 decode steps: each package's bf16 against its own float32
evaluation of the same bf16 weights, and the two against each other.

The reference's own bf16 lands as far from float32 as the port's (each
step within 1.5x), the two bf16 runs are closer to each other than
either is to float32, and the float32 runs agree within 1e-3. Run with
``-s`` to print the readings.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models.model_zoo import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import base as tbase

LAYERS, ROWS, PROMPT, STEPS = 8, 4, 64, 3


def _reference(cfg, params, toks) -> list:
    logits, cache = jget_model(cfg).prefill(params, jnp.asarray(toks[:, :PROMPT]),
                                            PROMPT + STEPS)
    out = [np.asarray(logits[:, -1], np.float32)]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = jget_model(cfg).decode_step(params, cache, jnp.asarray(toks[:, t]))
        out.append(np.asarray(logits, np.float32))
    return out


def _port(model, toks) -> list:
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(toks[:, :PROMPT]), PROMPT + STEPS)
        out = [logits[:, -1].float().numpy()]
        for t in range(PROMPT, PROMPT + STEPS):
            logits, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]))
            out.append(logits.float().numpy())
    return out


def test_bf16_scatter_is_the_reference_models():
    cfg = {}
    for dt in ("bfloat16", "float32"):
        cfg[dt] = (dataclasses.replace(jbase.get_config("xlstm_125m"), num_layers=LAYERS, dtype=dt),
                   dataclasses.replace(tbase.get_config("xlstm_125m"), num_layers=LAYERS, dtype=dt))
    params = jget_model(cfg["bfloat16"][0]).init(jax.random.PRNGKey(0))
    exact = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    toks = np.random.default_rng(0).integers(
        0, cfg["float32"][0].vocab_size, (ROWS, PROMPT + STEPS)).astype(np.int32)
    run = {
        "ref_bf16": _reference(cfg["bfloat16"][0], params, toks),
        "ref_f32": _reference(cfg["float32"][0], exact, toks),
        "port_bf16": _port(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, params), cfg["bfloat16"][1], device="cpu"), toks),
        "port_f32": _port(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, exact), cfg["float32"][1], device="cpu"), toks),
    }

    def dist(a, b):
        return [float(np.abs(x - y).max()) for x, y in zip(run[a], run[b])]

    got = dict(ref=dist("ref_bf16", "ref_f32"), port=dist("port_bf16", "port_f32"),
               bf16_apart=dist("port_bf16", "ref_bf16"), f32_apart=dist("port_f32", "ref_f32"),
               largest=float(max(np.abs(x).max() for x in run["ref_f32"])))
    print(json.dumps({"xlstm_125m_bf16_from_f32": got}))
    assert max(got["f32_apart"]) <= 1e-3, got
    for ref, port, apart in zip(got["ref"], got["port"], got["bf16_apart"]):
        assert port <= 1.5 * ref and ref <= 1.5 * port, got
        assert apart < min(ref, port), got
