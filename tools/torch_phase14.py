#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py alone: the kernels' build (phase_setup),
then sharded serving, the pipeline's backward and sharded training on
gloo ranks sharing one GPU (phase_sharded, 14a-14m), without the phases
before it, then phase 15a's predictions of its cells on the meta device
(_scan_predictions):

    python3 tools/torch_phase14.py

It prints what the phase prints, fails as the phase fails, and writes the
phase's report to chiprun_out/phase14.json. It exits 2 without a CUDA
device.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":  # the spawned ranks import this file again
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device: phase 14 runs on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = chip_smoke.phase_setup(torch)
    t = time.perf_counter()
    try:
        out = chip_smoke.phase_sharded(torch, smi)
    finally:
        chip_smoke.log(f"phase 14 took {time.perf_counter() - t:.1f}s")
    out["card"] = smi
    out["predictions"] = chip_smoke._scan_predictions(torch, out)
    for name, p in out["predictions"].items():
        chip_smoke.log(f"15a {name}: {p['flops']:.6g} FLOPs predicted, all-reduces "
                       f"{p.get('predicted')} (rank 0: {p.get('measured', p.get('counted'))})")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "phase14.json").write_text(json.dumps(out, default=str))
