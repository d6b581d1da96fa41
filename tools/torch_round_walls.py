#!/usr/bin/env python3
"""Time the port's FastMatch and Scan queries again and again on one GPU.

The query wall of one run moves by tens of percent between runs, so one
run per commit cannot show a host-side difference. This script builds
the TAXI-q1 dataset of ``chip_smoke.py`` phase 4 once, keeps it on the
card, and runs FastMatch and Scan in turns, ``--repeats`` times each
after one warm-up run of each (reported apart, as ``first``). Then it
profiles one run of each and reports, per round, the device time, the
device kernels and the host ``cudaLaunch*`` calls, with the largest
device kernels and host ops. It imports only torch, numpy and the
``repro_torch`` package found under ``--src``, so the same script times
any checkout of the port:

    python3 tools/torch_round_walls.py [--src DIR] [--tuples N] [--repeats R]

The last line of its standard output is one JSON object with the
results; it exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _profile(torch, run) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                device.append((e.key, us / 1e3, e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    rounds = max(res.rounds, 1)
    kernels = sum(c for n, _, c in device if not n.startswith(("Memcpy", "Memset")))
    return dict(
        rounds=res.rounds,
        device_ms=sum(r[1] for r in device),
        device_kernels_per_round=kernels / rounds,
        host_launches_per_round=sum(c for n, _, c in host if n.startswith("cudaLaunch")) / rounds,
        device_top=[dict(name=n[:120], ms=ms, calls=c) for n, ms, c in device[:12]],
        host_top=[dict(name=n[:120], ms=ms, calls=c) for n, ms, c in host[:12]],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--tuples", type=int, default=20_000_000)
    ap.add_argument("--repeats", type=int, default=9)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core import engine, histsim
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec, make_dataset
    from repro_torch.io import InMemorySource

    spec = SynthSpec(v_z=7548, v_x=24, num_tuples=args.tuples, k=10, n_close=10,
                     close_distance=0.05, far_distance=0.45, zipf_a=0.3, close_rank="head",
                     seed=44)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=44)
    source = InMemorySource(blocked, device="cuda")
    params = histsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=10, eps=0.12, delta=0.01)
    configs = {"fastmatch": engine.EngineConfig(variant="fastmatch", seed=0, lookahead=512),
               "scan": engine.EngineConfig(variant="scan")}

    def run(variant):
        return engine.run_engine(source, ds.target, params, configs[variant])

    def timed(variant) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run(variant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if variant == "fastmatch" and res.exact:
            raise AssertionError("fastmatch fell back to an exact read")
        return wall * 1e3

    first = {v: timed(v) for v in configs}
    walls = {v: [] for v in configs}
    for _ in range(args.repeats):
        for v in configs:
            walls[v].append(timed(v))
    out = dict(src=args.src, tuples=args.tuples, repeats=args.repeats,
               card=torch.cuda.get_device_name(0), first_ms=first)
    for v, w in walls.items():
        q1, _, q3 = statistics.quantiles(w, n=4)
        out[v] = dict(median_ms=statistics.median(w), q1_ms=q1, q3_ms=q3, walls_ms=w,
                      profile=_profile(torch, lambda v=v: run(v)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
