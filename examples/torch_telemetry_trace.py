"""Telemetry on the PyTorch / CUDA port: trace a served batch, render the
confidence curves.

The port's twin of examples/telemetry_trace.py, with its inputs and its
lines. Runs a `MatchServer` with `repro_torch.obs` telemetry attached,
serves a small batch of matching queries, then shows everything the
subsystem captured:

  * the per-query lifecycle trace (enqueue -> admit -> round batches ->
    retire), dumped as JSONL: the file a dashboard or `jq` consumes;
  * the tuples-to-confidence curve of each query, the measurable form
    of Theorem 1's n -> eps(n): at every poll boundary the scheduler
    records how many tuples the shared stream has read and how much
    failure probability (delta_upper) remains, written as CSV;
  * the Prometheus-format metrics scrape body (counters for tuples /
    rounds / blocks, latency histograms binned by the port's histogram
    kernel).

Telemetry observes without perturbing: the engine's outputs are
bit-identical with and without it (tests/test_torch_obs.py). Runs on
the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_telemetry_trace.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro_torch.serve.fastmatch_server import MatchServer

K, EPS, DELTA = 10, 0.07, 0.01
SPEC = SynthSpec(
    v_z=161, v_x=24, num_tuples=1_000_000, k=K, n_close=10,
    close_distance=0.02, far_distance=0.3, zipf_a=1.0, seed=0,
)


def run(spec: SynthSpec = SPEC, device=None, *, lookahead: int = 256, out_dir=None) -> dict:
    """The example on ``device`` (the GPU unless "cpu"), its three files
    written under ``out_dir`` (a new temporary directory when None):
    every query's result, the trace's event count, the curves' points,
    the three paths, and the lines it prints (``lines``)."""
    device = resolve_device(device)
    lines = ["generating synthetic census ..."]
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, seed=spec.seed)
    lines.append(f"dataset: {blocked.num_tuples:,} tuples in {blocked.num_blocks:,} blocks\n")

    rng = np.random.default_rng(1)
    targets = [ds.target] + [
        perturb_distribution(ds.target, d, rng)
        for d in np.linspace(0.005, 0.05, 5)
    ]

    server = MatchServer(
        blocked, device=device, max_queries=4, lookahead=lookahead, poll_every=4, seed=0,
        prefetch=True, telemetry=True,
    )
    rids = [server.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
    lines.append(f"serving {len(rids)} queries with telemetry attached ...")
    results = server.run_until_idle()

    if out_dir is None:
        out = pathlib.Path(tempfile.mkdtemp(prefix="fastmatch_telemetry_"))
    else:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
    tel = server.telemetry

    # 1. lifecycle trace -> JSONL
    trace_path = out / "trace.jsonl"
    n = server.export_trace(trace_path)
    lines.append(f"\n-- trace: {n} events -> {trace_path}")
    for line in trace_path.read_text().splitlines():
        ev = json.loads(line)
        if ev["kind"] in ("query_admit", "query_retire", "round_batch"):
            keys = ("qid", "slot", "rounds", "tuples", "tuples_read", "windows")
            brief = {k: ev[k] for k in keys if k in ev}
            lines.append(f"   [{ev['seq']:>3}] {ev['kind']:<13} {brief}")

    # 2. tuples-to-confidence curves -> CSV (+ a terminal sketch)
    csv_path = out / "confidence_curves.csv"
    rows = tel.export_confidence_csv(csv_path)
    lines.append(f"\n-- confidence curves: {rows} points -> {csv_path}")
    curves = {}
    for qid in tel.query_ids():
        curve = curves[qid] = tel.confidence_curve(qid)  # columns: obs.CURVE_COLUMNS
        tuples, conf = curve[:, 1], curve[:, 7]
        steps = " ".join(
            f"{int(t):>9,}:{c:5.3f}" for t, c in zip(tuples, conf)
        )
        lines.append(f"   q{qid}: tuples:confidence  {steps}")

    # 3. Prometheus scrape body
    prom_path = out / "metrics.prom"
    prom_path.write_text(server.prometheus_metrics())
    wanted = ("fastmatch_tuples_read_total", "fastmatch_rounds_total",
              "fastmatch_queries_retired_total")
    lines.append(f"\n-- metrics -> {prom_path}")
    for line in server.prometheus_metrics().splitlines():
        if line.startswith(wanted):
            lines.append(f"   {line}")

    m = server.metrics
    lines.append(f"\nserved {m['queries_done']} queries from "
                 f"{m['total_tuples_read']:,} shared tuples "
                 f"({m['tuples_per_query']:,.0f} amortized per query)")
    return dict(results=[results[rid] for rid in rids], events=n, curve_points=rows,
                curves=curves, metrics=m, trace_path=trace_path, csv_path=csv_path,
                prom_path=prom_path, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(SPEC, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
