"""Anytime serving on the PyTorch / CUDA port: stream a query's
confidence trajectory.

The port's twin of examples/anytime_match.py, with its inputs and its
lines. Submits a top-k matching query in the paper's FLIGHTS-q1 regime
(the sampling-friendly case where FastMatch terminates after reading
~40% of the data) and consumes it through the anytime API instead of
blocking on the final answer:

  * `MatchServer.iter_results` yields a refreshed `AnytimeAnswer` at
    every poll boundary where the statement changed: the current best
    set, the per-candidate decision margins, and the Theorem-1-style
    confidence statement (eps(n) at the weakest candidate, the union
    failure bound delta_upper);
  * a `StopPolicy` shows SLA-driven stopping on a second, much
    stricter query: a hard tuples budget retires it early with the
    honest anytime answer of that round (``exact=False``,
    ``stop_reason="tuples"``), bit-identical to what `poll_result`
    would have said at the same poll.

The printed table is the tuples-to-confidence curve telemetry records
(`repro_torch.obs.CURVE_COLUMNS`). Runs on the GPU unless ``--device
cpu`` is given:

  PYTHONPATH=src python examples/torch_anytime_match.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import resolve_device
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset
from repro_torch.serve.fastmatch_server import MatchServer, StopPolicy

K, EPS, DELTA = 5, 0.06, 0.01
SPEC = SynthSpec(
    v_z=161, v_x=24, num_tuples=6_000_000, k=K, n_close=10,
    close_distance=0.02, far_distance=0.3, zipf_a=1.0,
    close_rank="head", seed=42,
)


def run(spec: SynthSpec = SPEC, device=None, *, lookahead: int = 512,
        budget: int = 800_000) -> dict:
    """The example on ``device`` (the GPU unless "cpu"): every streamed
    answer, the final one, the SLA query's result and answer, and the
    lines it prints (``lines``)."""
    device = resolve_device(device)
    lines = ["generating synthetic flights (paper FLIGHTS-q1 shape) ..."]
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512,
                           seed=spec.seed)
    lines.append(f"dataset: {blocked.num_tuples:,} tuples in {blocked.num_blocks:,} blocks\n")

    srv = MatchServer(blocked, device=device, max_queries=4, lookahead=lookahead, seed=0)
    rid = srv.submit(ds.target, k=K, eps=EPS, delta=DELTA)

    lines.append("streaming anytime answers (one row per changed statement):")
    lines.append(f"{'round':>6} {'tuples':>10} {'n_min':>8} {'eps(n)':>8} "
                 f"{'delta_up':>9} {'conf':>6}  best set")
    stream = []
    for ans in srv.iter_results(rid):
        stream.append(ans)
        best = ",".join(map(str, ans.ids.tolist())) or "-"
        lines.append(f"{ans.round:>6} {ans.tuples:>10,} {ans.n_min:>8.0f} "
                     f"{ans.eps_n:>8.4f} {ans.delta_upper:>9.3g} "
                     f"{ans.confidence:>6.3f}  [{best}] ({ans.status})")
    final = srv.poll_result(rid)
    res = final.result
    lines.append(f"\nfinal: ids={final.ids.tolist()} exact={res.exact} "
                 f"tuples={res.tuples_read:,} "
                 f"({100 * res.tuples_read / blocked.num_tuples:.1f}% of the data)")
    # The promise is (eps, k)-correctness, not the literal argmin set:
    # every returned candidate's TRUE distance is within eps of the
    # true k-th best (ties inside eps are interchangeable by design).
    kth = float(np.sort(ds.true_dists)[K - 1])
    worst = float(ds.true_dists[final.ids].max())
    lines.append(f"true k-th distance {kth:.4f}, worst returned {worst:.4f} -> "
                 f"excess {max(0.0, worst - kth):.4f} "
                 f"({'within' if worst - kth <= EPS else 'OUTSIDE'} eps={EPS})")

    # -- SLA stop: a hard sampling budget on a much stricter query --------
    # eps=0.01 would need far more samples than the dataset holds; the
    # budget stops it honestly instead of letting it scan everything.
    srv2 = MatchServer(blocked, device=device, max_queries=4, lookahead=lookahead, seed=0)
    rid2 = srv2.submit(ds.target, k=K, eps=0.01, delta=1e-4,
                       stop=StopPolicy(tuples=budget))
    res2 = srv2.run_until_idle()[rid2]
    ans2 = srv2.poll_result(rid2)
    lines.append(f"\nSLA query (eps=0.01, tuples<={budget:,}): "
                 f"stopped={res2.stopped} reason={res2.stop_reason!r} "
                 f"exact={res2.exact}")
    lines.append(f"honest statement at the stop: ids={ans2.ids.tolist()} "
                 f"delta_upper={ans2.delta_upper:.3g} "
                 f"margin_min={ans2.margin.min():.4f}")
    return dict(stream=stream, final=final, sla_result=res2, sla_answer=ans2,
                within_eps=worst - kth <= EPS, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(SPEC, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
