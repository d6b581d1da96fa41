#!/usr/bin/env python3
"""Phase 14l of chip_smoke.py alone: every family besides the dense one
trained two steps under the FSDP x TP layout on 4 gloo ranks sharing one
GPU (2 x 2; the uneven heads' cases on 1 x 4), against one process on the
card, on random prompts in place of 14a's selection:

    python3 tools/torch_phase14l.py          # on a GPU: full width, cut in depth
    python3 tools/torch_phase14l.py --cpu    # a rehearsal: smoke configs on the CPU

It prints each family's line as the phase does and every failed check,
writes the report to chiprun_out/phase14l.json, and exits 1 if a check
failed (2 without a CUDA device unless --cpu).
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _rank(rank, world, meta):
    import torch

    import chip_smoke
    from repro_torch.core import distributed

    mesh = distributed.init_mesh((2, 2), device_type=meta["device"])
    mesh14 = distributed.init_mesh((1, 4), device_type=meta["device"])
    t = time.perf_counter()
    out = dict(rank=rank, fam_train={arch: chip_smoke._fam_train_rank(torch, meta, arch, mesh)
                                     for arch, _ in chip_smoke.SHARD_FAM_TRAIN})
    # the uneven cases: the heads do not divide over the model axis
    out["fam_train_uneven"] = {name: chip_smoke._fam_train_rank(torch, meta, name, mesh14)
                               for name in chip_smoke.SHARD_FAM_UNEVEN}
    out["fam_train_s"] = time.perf_counter() - t
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.core import distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="smoke configs on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: phase 14l runs on a GPU (or --cpu)", file=sys.stderr)
        return 2
    card = "CPU"
    if dev == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    seq = 32 if args.cpu else 256
    meta = dict(device=dev, smoke=args.cpu, layers=None,
                prompts=np.random.default_rng(0).integers(0, 151_000, (8, seq)).astype(np.int32))
    meta["fam_train_dir"] = tempfile.mkdtemp(prefix="phase14l_")
    try:
        t = time.perf_counter()
        ref = chip_smoke._fam_train_references(torch, meta, meta["fam_train_dir"])
        ref_s = time.perf_counter() - t
        t = time.perf_counter()
        ranks = distributed.run_ranks(_rank, 4, meta, backend="gloo", device_type=dev,
                                      timeout=900)
        ranks_s = time.perf_counter() - t
    finally:
        shutil.rmtree(meta["fam_train_dir"], ignore_errors=True)
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
            print(f"FAILED {msg}", flush=True)

    out = chip_smoke._check_fam_train(ranks, ref, gate, dev)
    for arch, f in out.items():
        c = f["collectives"][0][-1]
        print(f"14l {arch} ({card}): losses {f['loss']} (one process {f['loss_reference']}); "
              f"errors {json.dumps(f['err'])}; step 2 "
              f"{max(ms[-1] for ms in f['step_ms']):.1f} ms a rank (one process "
              f"{f['one_process_step_ms'][-1]:.1f} ms), {c['calls']:.0f} all-reduces "
              f"({c['bytes'] / 1e9:.2f} GB, {c['host_s']:.2f} s host) a step; rank peaks "
              f"{[round(p, 2) for p in f['peak_gb']]} GB (one process "
              f"{f['one_process_peak_gb']:.2f})", flush=True)
    print(f"14l took {max(rk['fam_train_s'] for rk in ranks):.1f}s in the ranks "
          f"({ranks_s:.1f}s with their start), {ref_s:.1f}s for the one-process references; "
          f"{len(failed)} checks failed")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "phase14l.json").write_text(json.dumps(
        dict(card=card, families=out, failed=failed, reference_s=ref_s, ranks_s=ranks_s),
        default=str))
    return 1 if failed else 0


if __name__ == "__main__":  # the spawned ranks import this file again
    sys.exit(main())
