"""Serving on the PyTorch / CUDA port: many interactive matching
queries, one sample stream.

The port's twin of examples/serve_match.py, with its inputs and its
lines. Simulates the paper's interactive exploration scenario at serving
scale: a pool of analysts each picks a target income distribution and
asks for the k countries whose distributions match it best. A
`MatchServer` answers all of them from one shared pass over the data
(every tuple read advances every live query), and queries arriving later
are served from the already-accumulated counts, often with zero new I/O.
At the end the warm cache is checkpointed and the server "restarted"
from it: a restored server keeps the accumulated sample, so a restart
no longer pays the cold sampling cost. Runs on the GPU unless
``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_serve_match.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.engine import EngineConfig, run_engine
from repro_torch.core.histsim import HistSimParams
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro_torch.serve.fastmatch_server import MatchServer

K, EPS, DELTA = 10, 0.07, 0.01
SPEC = SynthSpec(
    v_z=161, v_x=24, num_tuples=4_000_000, k=K, n_close=10,
    close_distance=0.02, far_distance=0.3, zipf_a=1.0, seed=0,
)


def run(spec: SynthSpec = SPEC, device=None, *, lookahead: int = 512) -> dict:
    """The example on ``device`` (the GPU unless "cpu"): every query's
    result, the late and the restored queries' new tuples, the solo
    engines' tuples, and the lines it prints (``lines``)."""
    device = resolve_device(device)
    lines = ["generating synthetic census ..."]
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, seed=spec.seed)
    lines.append(f"dataset: {blocked.num_tuples:,} tuples in {blocked.num_blocks:,} blocks\n")

    # Eight analysts, eight targets: small perturbations of a base
    # distribution (think: nearby countries' income profiles).
    rng = np.random.default_rng(1)
    targets = [ds.target] + [
        perturb_distribution(ds.target, d, rng)
        for d in np.linspace(0.005, 0.05, 7)
    ]

    with tempfile.TemporaryDirectory(prefix="fastmatch_demo_ckpt_") as ckpt_dir:
        server = MatchServer(blocked, device=device, max_queries=4, lookahead=lookahead,
                             seed=0, checkpoint_dir=ckpt_dir)
        rids = [server.submit(t, k=K, eps=EPS, delta=DELTA) for t in targets]
        lines.append(f"submitted {len(rids)} queries into {server.spec.max_queries} slots ...")
        results = server.run_until_idle()

        lines.append(f"\n{'query':>5} {'tuples while live':>18} {'blocks':>7} {'exact':>6}  top-3")
        for i, rid in enumerate(rids):
            r = results[rid]
            lines.append(f"{i:>5} {r.tuples_read:>18,} {r.blocks_read:>7} {str(r.exact):>6}  "
                         f"{r.ids[:3].tolist()}")
        m = server.metrics
        lines.append(f"\nshared stream: {m['total_tuples_read']:,} tuples "
                     f"({100 * m['fraction_read']:.1f}% of the data) for {m['queries_done']} "
                     f"queries -> {m['tuples_per_query']:,.0f} tuples/query amortized")

        # A latecomer: the counts cache is warm, so it usually costs nothing.
        lines.append("\nlate query on the warm server ...")
        before = server.metrics["total_tuples_read"]
        late = server.submit(perturb_distribution(ds.target, 0.01, rng), k=K, eps=EPS,
                             delta=DELTA)
        late_result = server.run_until_idle()[late]
        late_new = server.metrics["total_tuples_read"] - before
        lines.append(f"late query answered with {late_new:,} new tuples read "
                     f"(delta_upper={late_result.delta_upper:.2e}); "
                     f"top-3 = {late_result.ids[:3].tolist()}")

        # Reference point: one engine per query re-reads the stream N times.
        solo = sum(
            run_engine(
                blocked, t,
                HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=K, eps=EPS, delta=DELTA),
                EngineConfig(variant="fastmatch", seed=100 + i, lookahead=lookahead),
                device=device,
            ).tuples_read
            for i, t in enumerate(targets)
        )
        lines.append(f"\none-engine-per-query reference: {solo:,} tuples "
                     f"({solo / max(m['total_tuples_read'], 1):.1f}x the shared stream)")

        # Warm restart: checkpoint the sample cache, "restart" the server
        # (a fresh MatchServer; in a real deployment this is a new
        # process), and serve from the restored counts. A cold restart
        # would pay the full sampling cost again.
        lines.append("\ncheckpointing the warm cache and restarting ...")
        server.save_cache()
        restarted = MatchServer.restore(blocked, checkpoint_dir=ckpt_dir, device=device,
                                        max_queries=4, lookahead=lookahead)
        before = restarted.metrics["total_tuples_read"]
        rid = restarted.submit(perturb_distribution(ds.target, 0.02, rng), k=K, eps=EPS,
                               delta=DELTA)
        restored_result = restarted.run_until_idle()[rid]
        restored_new = restarted.metrics["total_tuples_read"] - before
        lines.append(f"restored server answered a fresh query with {restored_new:,} new tuples "
                     f"read (cache: {100 * restarted.metrics['fraction_read']:.1f}% of the data "
                     f"already sampled); top-3 = {restored_result.ids[:3].tolist()}")
    return dict(results=[results[rid] for rid in rids], metrics=m, late_result=late_result,
                late_new_tuples=late_new, solo_tuples=solo, restored_result=restored_result,
                restored_new_tuples=restored_new, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(SPEC, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
