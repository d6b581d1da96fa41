#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone: the kernels' build (phase_setup),
then recurrentgemma-2b, xlstm-125m and whisper-medium trained at full
width through the launcher (phase_family_train, 16a) and the seven
examples on the card (phase_examples, 16b), without the phases before it:

    python3 tools/torch_phase16.py

It prints what the phase prints, fails as the phase fails, and writes the
phase's report to chiprun_out/phase16.json (each example's lines under
chiprun_out/examples/). It exits 2 without a CUDA device.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device: phase 16 runs on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = chip_smoke.phase_setup(torch)
    t = time.perf_counter()
    try:
        out = dict(family_train=chip_smoke.phase_family_train(torch, smi),
                   examples=chip_smoke.phase_examples(torch, smi))
    finally:
        chip_smoke.log(f"phase 16 took {time.perf_counter() - t:.1f}s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "phase16.json").write_text(json.dumps(out, default=str))
    print(smi, flush=True)
