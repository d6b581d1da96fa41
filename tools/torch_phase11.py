#!/usr/bin/env python3
"""Phase 11 of chip_smoke.py alone, from any checkout of the port: the
kernels' build (phase_setup), then the data layer and the full-width LM
(phase_lm: 11a selection, 11b serving, 11d the drift monitor, 11c float32
decode), without the phases before it:

    python3 tools/torch_phase11.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose chip_smoke.py and src/ run (default:
this one), so two commits can be compared in one call on one card
(parent, change, change, parent). It prints what the phase prints,
fails as the phase fails, writes the phase's report to
chiprun_out/phase11_<tag>.json and prints, as its last line, one JSON
object with 11d's capture + check wall and kernel B's times at (1, 64).
It exits 2 without a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout to run")
    ap.add_argument("--tag", default="change", help="names the report file")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device: phase 11 runs on a GPU", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_setup(torch)
    timer = chip_smoke.DeviceTimer(torch)
    t = time.perf_counter()
    out = chip_smoke.phase_lm(torch, timer, smi)
    chip_smoke.log(f"phase 11 took {time.perf_counter() - t:.1f}s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"phase11_{args.tag}.json").write_text(json.dumps(out, default=str))
    mon = out["monitor"]
    print(json.dumps({"tag": args.tag, "root": str(root), "card": smi,
                      "monitor_wall_s": mon["wall_s"], "kernel": mon["kernel"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
