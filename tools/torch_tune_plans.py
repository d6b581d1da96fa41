#!/usr/bin/env python3
"""Tune the port's kernel plans on one GPU and save them with their provenance.

    python3 tools/torch_tune_plans.py [--out PATH] [--reps R] [--src DIR]

Runs `repro_torch.kernels.autotune.tune_tau` and `tune_ingest` on the
CUDA device for the query shapes of benchmarks/common.py:56-76
(flights_q1, flights_q2 and flights_q4 at 161 x 24, taxi_q1 at
7548 x 24, police_q1 at 191 x 2: three distinct shape keys): tau at
Q in {1, 8} for metric l1 and at Q = 8 for chi2 and hellinger on the
taxi shape, and the ingest of each shape. The winners go to ``--out``
(by default the committed ``benchmarks/results/tuned_torch/cuda.json``)
with the card's name and power limit (nvidia-smi), the torch and CUDA
versions and the date in its header; every candidate's median time goes
to ``chiprun_out/tune_plans.json``. The last line of its standard output
is one JSON object with the winners; it exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (V_Z, V_X) of each query shape of benchmarks/common.py:56-76
SHAPES = {"flights_q1,q2,q4": (161, 24), "taxi_q1": (7548, 24), "police_q1": (191, 2)}
TAU_KEYS = [(v_z, v_x, q, "l1") for v_z, v_x in SHAPES.values() for q in (1, 8)] + [
    (7548, 24, 8, "chi2"), (7548, 24, 8, "hellinger"),
]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "benchmarks" / "results" / "tuned_torch" / "cuda.json")
    # more than the reference's 15: at the small keys the wide branch and
    # the default are a few per cent apart, near the 7 % margin
    ap.add_argument("--reps", type=int, default=100,
                    help="timed calls per candidate, in turns (median)")
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="where repro_torch lives")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the plans are tuned on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src))
    from repro_torch.kernels import _build, autotune

    _build.build_all()
    card = card_line()
    reg = autotune.PlanRegistry(backend="cuda")
    timings = {"tau": {}, "ingest": {}}
    for v_z, v_x, q, metric in TAU_KEYS:
        key = autotune.tau_key(v_z, v_x, q, metric=metric)
        plan, timed = autotune.tune_tau(v_z, v_x, q, metric=metric, device="cuda",
                                        reps=args.reps)
        reg.tau[key] = plan
        timings["tau"][key] = [dict(plan=dataclasses.asdict(c), ms=t * 1e3,
                                    bytes=autotune.tau_bytes(v_z, v_x, q, c, metric))
                               for c, t in timed.items()]
        print(f"{key}: {plan}  ({len(timed)} candidates, "
              f"{min(timed.values()) * 1e3:.4f}-{max(timed.values()) * 1e3:.4f} ms)", flush=True)
    for v_z, v_x in SHAPES.values():
        key = autotune.ingest_key(v_z, v_x)
        plan, timed = autotune.tune_ingest(v_z, v_x, device="cuda", reps=args.reps)
        reg.ingest[key] = plan
        timings["ingest"][key] = [dict(plan=dataclasses.asdict(c), ms=t * 1e3)
                                  for c, t in timed.items()]
        print(f"{key}: {plan}", flush=True)
    reg.meta = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                    date=datetime.date.today().isoformat(), tool="tools/torch_tune_plans.py",
                    reps=args.reps, margin=autotune.DEFAULT_MARGIN)
    path = reg.save(args.out)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tune_plans.json").write_text(json.dumps(
        dict(meta=reg.meta, plans=json.loads(reg.decisions()), timings=timings), indent=1))
    print(f"saved {path}; card: {card}", flush=True)
    print(json.dumps(dict(card=card, plans=json.loads(reg.decisions()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
