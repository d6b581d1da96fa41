"""The port's examples (`examples/torch_*.py`) against the reference's
examples, on the CPU at a reduced size.

Each twin runs the port example's function with ``device="cpu"`` and,
beside it, the calls the reference example (`examples/*.py`) makes, on
the same inputs: the example's own `SynthSpec` with ``num_tuples`` cut
to 500,000 (so FastMatch still stops before the data runs out) and the
lookahead window cut with it, 512 blocks to 64 (the telemetry example's
256 to 32; the anytime example's SLA budget in proportion). The LM examples run their reference's configuration in
float32, the port's model holding the reference's initial weights
(carried over with `convert.lm_params_from_numpy`, the launcher's or the
example's `get_model` patched). Bars, the ROADMAP's tolerance contract:

* ids, rounds, passes, blocks, tuples, ``exact``, ``stopped``,
  ``stop_reason``, every anytime row's round, tuples, ``n_min``, set and
  status, and the served tokens and engine counters are equal;
* tau within 2e-5, ``delta_upper`` (and ``eps_n``) within rtol 1e-5;
* the training losses within 1e-4 in float32.

A last case runs each example's ``main`` with ``--device cpu`` at a
small size and checks what it prints.
"""

import dataclasses
import importlib.util
import json
import math
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.engine import VARIANTS
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.histsim import HistSimParams as JParams
from repro.data.corpus import CorpusSpec as JCorpusSpec
from repro.data.corpus import make_corpus as jmake_corpus
from repro.data.layout import block_layout as jblock_layout
from repro.data.synth import SynthSpec as JSynthSpec
from repro.data.synth import make_dataset as jmake_dataset
from repro.data.synth import perturb_distribution as jperturb
from repro.launch.train import train_loop as jtrain_loop
from repro.models.model_zoo import get_model as jget_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.fastmatch_server import MatchServer as JServer
from repro.serve.fastmatch_server import StopPolicy as JStop
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.launch import train as tlaunch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_anytime_match", "torch_serve_match",
         "torch_census_explore", "torch_telemetry_trace", "torch_serve_batch",
         "torch_train_lm_fastmatch")
TUPLES, LOOKAHEAD = 500_000, 64
TAU_ATOL, DELTA_RTOL, LOSS_ATOL = 2e-5, 1e-5, 1e-4
RESULT_FIELDS = ("rounds", "passes", "blocks_read", "blocks_considered", "tuples_read",
                 "exact", "stopped", "stop_reason", "qtype")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass resolves its module's names there
    spec.loader.exec_module(mod)
    return mod


def _small(mod):
    return dataclasses.replace(mod.SPEC, num_tuples=TUPLES)


def _ref_data(spec, block_size=None):
    """The reference's dataset and block layout for the port's spec."""
    ds = jmake_dataset(JSynthSpec(**dataclasses.asdict(spec)))
    kw = {} if block_size is None else {"block_size": block_size}
    blocked = jblock_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, seed=spec.seed, **kw)
    return ds, blocked


def _same_result(got, want, what: str = "") -> None:
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids), err_msg=what)
    for field in RESULT_FIELDS:
        assert getattr(got, field) == getattr(want, field), (what, field)
    np.testing.assert_allclose(got.delta_upper, float(want.delta_upper), rtol=DELTA_RTOL,
                               err_msg=what)
    np.testing.assert_allclose(got.state.tau.numpy(), np.asarray(want.state.tau),
                               atol=TAU_ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# the matching examples
# ---------------------------------------------------------------------------


def test_quickstart_matches_reference():
    mod = _example("torch_quickstart")
    spec = _small(mod)
    got = mod.run(spec, "cpu", lookahead=LOOKAHEAD)
    ds, blocked = _ref_data(spec)
    params = JParams(v_z=spec.v_z, v_x=spec.v_x, k=10, eps=0.06, delta=0.01)
    want = jrun_engine(blocked, ds.target, params,
                       JEngineConfig(variant="fastmatch", lookahead=LOOKAHEAD))
    _same_result(got["result"], want)
    assert not want.exact  # the query stopped before the data ran out
    np.testing.assert_array_equal(got["true_top_k"], ds.true_top_k)
    assert f"read {want.blocks_read}/{blocked.num_blocks} blocks" in "\n".join(got["lines"])


def test_anytime_match_matches_reference():
    mod = _example("torch_anytime_match")
    spec = _small(mod)
    budget = 800_000 * TUPLES // mod.SPEC.num_tuples
    got = mod.run(spec, "cpu", lookahead=LOOKAHEAD, budget=budget)
    ds, blocked = _ref_data(spec, block_size=512)
    srv = JServer(blocked, max_queries=4, lookahead=LOOKAHEAD, seed=0)
    rid = srv.submit(ds.target, k=mod.K, eps=mod.EPS, delta=mod.DELTA)
    stream = list(srv.iter_results(rid))
    final = srv.poll_result(rid)
    assert len(got["stream"]) == len(stream) > 2
    for g, w in zip(got["stream"], stream):
        assert (g.round, g.tuples, g.n_min, g.status) == (w.round, w.tuples, w.n_min, w.status)
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.delta_upper, w.delta_upper, rtol=DELTA_RTOL)
        np.testing.assert_allclose(g.eps_n, w.eps_n, rtol=DELTA_RTOL)
    _same_result(got["final"].result, final.result)
    assert got["stream"][-1].ids.tolist() == got["final"].ids.tolist()

    srv2 = JServer(blocked, max_queries=4, lookahead=LOOKAHEAD, seed=0)
    rid2 = srv2.submit(ds.target, k=mod.K, eps=0.01, delta=1e-4, stop=JStop(tuples=budget))
    res2 = srv2.run_until_idle()[rid2]
    _same_result(got["sla_result"], res2)
    assert res2.stop_reason == "tuples"
    ans2 = srv2.poll_result(rid2)
    np.testing.assert_array_equal(got["sla_answer"].ids, ans2.ids)
    np.testing.assert_allclose(got["sla_answer"].margin, ans2.margin, atol=TAU_ATOL)


def test_serve_match_matches_reference(tmp_path):
    mod = _example("torch_serve_match")
    spec = _small(mod)
    got = mod.run(spec, "cpu", lookahead=LOOKAHEAD)
    ds, blocked = _ref_data(spec)
    K, EPS, DELTA = mod.K, mod.EPS, mod.DELTA
    rng = np.random.default_rng(1)
    targets = [ds.target] + [jperturb(ds.target, d, rng) for d in np.linspace(0.005, 0.05, 7)]
    server = JServer(blocked, max_queries=4, lookahead=LOOKAHEAD, seed=0,
                     checkpoint_dir=str(tmp_path))
    rids = [server.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
    results = server.run_until_idle()
    for i, rid in enumerate(rids):
        _same_result(got["results"][i], results[rid], f"query {i}")
    for key in ("total_tuples_read", "total_rounds", "queries_done"):
        assert got["metrics"][key] == server.metrics[key], key
    before = server.metrics["total_tuples_read"]
    late = server.submit(jperturb(ds.target, 0.01, rng), k=K, eps=EPS, delta=DELTA)
    _same_result(got["late_result"], server.run_until_idle()[late], "late")
    assert got["late_new_tuples"] == server.metrics["total_tuples_read"] - before
    solo = sum(
        jrun_engine(blocked, t, JParams(v_z=spec.v_z, v_x=spec.v_x, k=K, eps=EPS, delta=DELTA),
                    JEngineConfig(variant="fastmatch", seed=100 + i, lookahead=LOOKAHEAD)
                    ).tuples_read
        for i, t in enumerate(targets)
    )
    assert got["solo_tuples"] == solo > got["metrics"]["total_tuples_read"]
    server.save_cache()
    restarted = JServer.restore(blocked, checkpoint_dir=str(tmp_path), max_queries=4,
                                lookahead=LOOKAHEAD)
    before = restarted.metrics["total_tuples_read"]
    rid = restarted.submit(jperturb(ds.target, 0.02, rng), k=K, eps=EPS, delta=DELTA)
    _same_result(got["restored_result"], restarted.run_until_idle()[rid], "restored")
    assert got["restored_new_tuples"] == restarted.metrics["total_tuples_read"] - before


def test_census_explore_matches_reference():
    mod = _example("torch_census_explore")
    spec = _small(mod)
    got = mod.run(spec, "cpu", lookahead=LOOKAHEAD)
    ds, blocked = _ref_data(spec)
    params = JParams(v_z=spec.v_z, v_x=spec.v_x, k=10, eps=0.06, delta=0.01)

    def engine(target, **kw):
        return jrun_engine(blocked, target, params, JEngineConfig(lookahead=LOOKAHEAD, **kw))

    _same_result(got["q1"], engine(ds.target, variant="fastmatch"), "q1")
    _same_result(got["q2"], engine(np.full(spec.v_x, 1.0 / spec.v_x), variant="fastmatch"),
                 "q2")
    _same_result(got["q3"], engine(np.asarray([0.4, 0.3, 0.15, 0.1, 0.05]),
                                   variant="fastmatch"), "q3")
    assert tuple(got["variants"]) == VARIANTS
    for variant in VARIANTS:
        _same_result(got["variants"][variant], engine(ds.target, variant=variant, seed=1),
                     variant)
    srv_chi = JServer(blocked, max_queries=2, lookahead=LOOKAHEAD, metric="chi2")
    rid = srv_chi.submit(ds.target, k=10, eps=0.15, delta=0.01)
    _same_result(got["q4"], srv_chi.run_until_idle()[rid], "q4")
    srv = JServer(blocked, max_queries=2, lookahead=LOOKAHEAD)
    rid_top = srv.submit(ds.target, k=10, eps=0.06, delta=0.01)
    rid_close = srv.submit_closeness(ds.target, eps=0.08, gap=0.15, delta=0.01)
    mixed = srv.run_until_idle()
    _same_result(got["q5_topk"], mixed[rid_top], "q5 top-k")
    _same_result(got["q5_closeness"], mixed[rid_close], "q5 closeness")
    assert got["shared_tuples"] == srv.scheduler.tuples_read


def test_telemetry_trace_matches_reference(tmp_path):
    mod = _example("torch_telemetry_trace")
    spec = _small(mod)
    got = mod.run(spec, "cpu", lookahead=LOOKAHEAD // 2, out_dir=tmp_path / "port")
    ds, blocked = _ref_data(spec)
    rng = np.random.default_rng(1)
    targets = [ds.target] + [jperturb(ds.target, d, rng) for d in np.linspace(0.005, 0.05, 5)]
    server = JServer(blocked, max_queries=4, lookahead=LOOKAHEAD // 2, poll_every=4, seed=0,
                     prefetch=True, telemetry=True)
    rids = [server.submit(t, k=mod.K, eps=mod.EPS, delta=mod.DELTA) for t in targets]
    results = server.run_until_idle()
    for i, rid in enumerate(rids):
        _same_result(got["results"][i], results[rid], f"query {i}")
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    assert got["events"] == server.export_trace(ref_dir / "trace.jsonl")
    tel = server.telemetry
    assert got["curve_points"] == tel.export_confidence_csv(ref_dir / "curves.csv")
    assert sorted(got["curves"]) == tel.query_ids()
    for qid, curve in got["curves"].items():
        want = tel.confidence_curve(qid)
        assert curve.shape == want.shape
        # round, tuples, tuples_live, n_min; then tau_min, eps_n, delta_upper, confidence
        np.testing.assert_array_equal(curve[:, :4], want[:, :4])
        np.testing.assert_allclose(curve[:, 4], want[:, 4], rtol=0, atol=TAU_ATOL)
        np.testing.assert_allclose(curve[:, 5:7], want[:, 5:7], rtol=DELTA_RTOL)
        # confidence = max(0, 1 - delta_upper) carries delta_upper's error as an
        # absolute one (relative to 1 - delta_upper it grows as that cancels)
        conf_atol = DELTA_RTOL * want[:, 6] + np.finfo(curve.dtype).eps
        assert np.all(np.abs(curve[:, 7] - want[:, 7]) <= conf_atol), (curve[:, 7], want[:, 7])
    kinds = [json.loads(line)["kind"] for line in got["trace_path"].read_text().splitlines()]
    ref_kinds = [json.loads(line)["kind"]
                 for line in (ref_dir / "trace.jsonl").read_text().splitlines()]
    assert kinds == ref_kinds
    assert got["prom_path"].read_text().strip() and got["csv_path"].read_text().strip()


# ---------------------------------------------------------------------------
# the LM examples
# ---------------------------------------------------------------------------


def test_serve_batch_matches_reference(monkeypatch):
    """Six requests through four slots (two prefills), four new tokens
    each, the smoke qwen2.5-3b in float32 on the reference's weights:
    equal tokens and engine counters."""
    mod = _example("torch_serve_batch")
    jc = dataclasses.replace(jget_smoke_config(mod.ARCH), dtype="float32")
    tc = dataclasses.replace(tget_smoke_config(mod.ARCH), dtype="float32")
    jm = jget_model(jc)
    params = jm.init(jax.random.PRNGKey(0))

    def reference_weights(cfg, *, device=None, generator=None):
        return convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                            device=device)

    monkeypatch.setattr(mod, "get_model", reference_weights)
    kw = dict(n_requests=6, max_new_tokens=4, slots=4, max_len=64)
    got = mod.run(tc, "cpu", **kw)
    eng = JServeEngine(jm, params, slots=kw["slots"], max_len=kw["max_len"])
    rng = np.random.default_rng(0)
    for i in range(kw["n_requests"]):
        eng.submit(JRequest(
            rid=i, prompt=rng.integers(0, jc.vocab_size, size=int(rng.integers(4, 32)))
            .astype(np.int32), max_new_tokens=kw["max_new_tokens"]))
    done = eng.run()
    assert [r.rid for r in got["done"]] == [r.rid for r in done]
    for g, w in zip(got["done"], done):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.output == w.output, g.rid
    assert got["metrics"] == eng.metrics == {"prefills": 2, "decode_ticks": 6,
                                             "tokens_out": 24}


def test_train_lm_fastmatch_matches_reference(monkeypatch, tmp_path):
    """Two steps of 2 x 32 of xlstm-125m at full width, cut to two layers
    (one mLSTM, one sLSTM block) in float32, both launchers on the
    example's corpus from the reference's initial weights: the same
    selection, losses within 1e-4, every step taken."""
    mod = _example("torch_train_lm_fastmatch")
    spec = mod.TrainSpec(steps=2, batch=2, seq=32, ckpt_dir=str(tmp_path / "port"))
    cut = dict(vocab_size=spec.vocab, num_layers=2, slstm_every=2, dtype="float32")
    jc = dataclasses.replace(jget_config("xlstm_125m"), **cut)
    init = jget_model(jc).init(jax.random.PRNGKey(0))

    def reference_weights(cfg, *, device=None, generator=None):
        return convert.lm_params_from_numpy(jax.tree.map(np.asarray, init), cfg, device=device)

    monkeypatch.setattr(tlaunch, "get_model", reference_weights)
    monkeypatch.setattr(mod, "get_config",
                        lambda name: dataclasses.replace(tget_config(name), **cut))
    got = mod.run(spec, "cpu")
    corpus = jmake_corpus(JCorpusSpec(
        num_domains=64, num_buckets=128, vocab_size=spec.vocab, num_blocks=2048,
        block_tokens=2048, n_reference=8, reference_alpha=0.15, seed=0))
    want = jtrain_loop(cfg=jc, steps=spec.steps, batch_size=spec.batch, seq_len=spec.seq,
                       lr=3e-4, ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, corpus=corpus,
                       select_k=8, log_fn=lambda *_: None)
    gs, ws = got["selection"], want["selection"]
    np.testing.assert_array_equal(np.sort(gs.selected_domains), np.sort(ws.selected_domains))
    assert (gs.result.rounds, gs.result.blocks_read) == (ws.result.rounds, ws.result.blocks_read)
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]] == [2]
    for g, w in zip(got["history"], want["history"]):
        for key in ("loss", "ce"):
            assert abs(g[key] - w[key]) <= LOSS_ATOL, (key, g, w)
        assert g["step_ok"] == w["step_ok"] == 1.0
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_ATOL
    assert f"\nfinal loss {got['final_loss']:.4f} after 2 steps" in got["lines"]


# ---------------------------------------------------------------------------
# each example's main, on the CPU at a small size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_main_prints_on_cpu(name, monkeypatch, capsys, tmp_path):
    mod = _example(name)
    argv = ["--device", "cpu"]
    if hasattr(mod, "SPEC"):
        monkeypatch.setattr(mod, "SPEC", dataclasses.replace(mod.SPEC, num_tuples=100_000))
    if name == "torch_train_lm_fastmatch":
        monkeypatch.setattr(mod, "get_config", tget_smoke_config)
        argv += ["--steps", "1", "--batch", "2", "--seq", "16", "--vocab", "256",
                 "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the examples' scratch files
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    first = {
        "torch_quickstart": "generating synthetic census ...",
        "torch_anytime_match": "generating synthetic flights (paper FLIGHTS-q1 shape) ...",
        "torch_serve_match": "generating synthetic census ...",
        "torch_census_explore": "generating POLICE-like dataset (191 candidates, 5 groups) ...",
        "torch_telemetry_trace": "generating synthetic census ...",
        "torch_serve_batch": "served 24 requests in ",
        "torch_train_lm_fastmatch": "arch=xlstm_125m layers=",
    }[name]
    assert out.startswith(first), out[:200]
    last = {
        "torch_quickstart": "  id   est-dist  true-dist",
        "torch_anytime_match": "honest statement at the stop: ids=",
        "torch_serve_match": "restored server answered a fresh query with ",
        "torch_census_explore": "  shared-stream total reads: ",
        "torch_telemetry_trace": "queries from ",
        "torch_serve_batch": "  req ",
        "torch_train_lm_fastmatch": "checkpoints in ",
    }[name]
    assert last in out
    if name == "torch_train_lm_fastmatch":
        loss = float(out.split("final loss ")[1].split()[0])
        assert math.isfinite(loss)


@pytest.mark.parametrize("name", NAMES)
def test_no_device_raises_without_gpu(name):
    """With no device and no GPU, each example raises before it works."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    mod = _example(name)
    args = (mod.TrainSpec(),) if hasattr(mod, "TrainSpec") else (
        (mod.SPEC,) if hasattr(mod, "SPEC") else (None,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.run(*args)
