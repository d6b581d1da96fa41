"""Interactive-style exploration on the PyTorch / CUDA port: several
matching queries on one dataset.

The port's twin of examples/census_explore.py, with its inputs and its
lines: target shapes from the paper (uniform target, explicit vector
target), a comparison of all engine variants on one query, and the
pluggable-metric layer (a chi-square top-k server, and a tolerant
closeness test sharing a top-k query's sample stream). Runs on the GPU
unless ``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_census_explore.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.engine import VARIANTS, EngineConfig, run_engine
from repro_torch.core.histsim import HistSimParams
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset
from repro_torch.serve.fastmatch_server import MatchServer

SPEC = SynthSpec(
    v_z=191, v_x=5, num_tuples=5_000_000, k=10, n_close=10,
    close_distance=0.015, far_distance=0.3, zipf_a=0.9, seed=2,
)


def run(spec: SynthSpec = SPEC, device=None, *, lookahead: int = 512) -> dict:
    """The example on ``device`` (the GPU unless "cpu"): the five
    queries' results, every variant's result on q1, the truths they are
    printed beside, and the lines it prints (``lines``)."""
    device = resolve_device(device)
    lines = ["generating POLICE-like dataset (191 candidates, 5 groups) ..."]
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, seed=spec.seed)
    params = HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=10, eps=0.06, delta=0.01)

    def engine(target, **kw):
        return run_engine(blocked, target, params,
                          EngineConfig(lookahead=lookahead, **kw), device=device)

    # --- query 1: match the planted target (paper's "closest to target") ---
    res = engine(ds.target, variant="fastmatch")
    lines.append(f"\n[q1: planted target]  ids={sorted(res.ids.tolist())} "
                 f"blocks={res.blocks_read}/{blocked.num_blocks}")

    # --- query 2: uniform target (paper's POLICE-q1/q2 setup) ---
    uniform = np.full(spec.v_x, 1.0 / spec.v_x)
    res_u = engine(uniform, variant="fastmatch")
    true_u = np.argsort(np.abs(ds.true_hists - uniform[None]).sum(axis=1))[:10]
    lines.append(f"[q2: uniform target]  ids={sorted(res_u.ids.tolist())} "
                 f"truth={sorted(true_u.tolist())} blocks={res_u.blocks_read}")

    # --- query 3: explicit target vector (paper FLIGHTS-q3 style) ---
    explicit = np.asarray([0.4, 0.3, 0.15, 0.1, 0.05])
    res_e = engine(explicit, variant="fastmatch")
    lines.append(f"[q3: explicit vector] ids={sorted(res_e.ids.tolist())} "
                 f"blocks={res_e.blocks_read}")

    # --- all variants on q1 ---
    lines.append("\nvariant comparison on q1:")
    variants = {}
    for variant in VARIANTS:
        r = variants[variant] = engine(ds.target, variant=variant, seed=1)
        lines.append(f"  {variant:10s} blocks={r.blocks_read:6d} rounds={r.rounds:5d} "
                     f"wall={r.wall_time_s:6.2f}s exact={r.exact}")

    # --- query 4: chi-square metric (pluggable-metric layer) ---
    # Same dataset, same counts machinery: only the registry distance
    # the shared tau pass computes changes. chi2 taus live in [0, 2] and
    # route through a conservative bound (core/bounds.py), so give the
    # query a wider radius than the l1 eps.
    lines.append("\n[q4: chi-square top-k] serving with metric='chi2' ...")
    srv_chi = MatchServer(blocked, device=device, max_queries=2, lookahead=lookahead,
                          metric="chi2")
    rid = srv_chi.submit(ds.target, k=10, eps=0.15, delta=0.01)
    res_chi = srv_chi.run_until_idle()[rid]
    q = ds.target / ds.target.sum()
    s_ = ds.true_hists + q[None, :]
    d_ = ds.true_hists - q[None, :]
    chi_true = np.where(s_ > 0, d_ * d_ / np.where(s_ > 0, s_, 1), 0).sum(1)
    lines.append(f"  ids={sorted(res_chi.ids.tolist())} "
                 f"truth={sorted(np.argsort(chi_true)[:10].tolist())} "
                 f"blocks={res_chi.blocks_read} exact={res_chi.exact}")

    # --- query 5: closeness test riding a top-k query's samples -------
    # A distribution-testing query through the same queue: label every
    # candidate within eps of the target as close, everything beyond
    # eps + gap as far (labels inside the gap are unconstrained). It
    # shares the counts matrix with the concurrent top-k query, so the
    # pair costs barely more I/O than either alone.
    lines.append("\n[q5: mixed top-k + closeness on one stream]")
    srv = MatchServer(blocked, device=device, max_queries=2, lookahead=lookahead)
    rid_top = srv.submit(ds.target, k=10, eps=0.06, delta=0.01)
    rid_close = srv.submit_closeness(ds.target, eps=0.08, gap=0.15, delta=0.01)
    mixed = srv.run_until_idle()
    rt, rc = mixed[rid_top], mixed[rid_close]
    n_true_close = int((ds.true_dists <= 0.08).sum())
    lines.append(f"  top-k:     ids={sorted(rt.ids.tolist())} tuples={rt.tuples_read}")
    lines.append(f"  closeness: {len(rc.ids)} candidates labeled close "
                 f"(truth: {n_true_close} within eps) tuples={rc.tuples_read}")
    lines.append(f"  shared-stream total reads: {srv.scheduler.tuples_read}")
    return dict(q1=res, q2=res_u, q3=res_e, variants=variants, q4=res_chi, q5_topk=rt,
                q5_closeness=rc, shared_tuples=srv.scheduler.tuples_read,
                num_blocks=blocked.num_blocks, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(SPEC, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
