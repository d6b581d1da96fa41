#!/usr/bin/env python3
"""The stable sort `repro_torch.data.synth.make_dataset` groups its
tuples with, on the host (numpy's stable ``argsort``, the default path)
and on the card (``torch.sort(stable=True)``, ``device="cuda"``), at the
smoke's table sizes: ids drawn from the Zipf laws of chip_smoke.py's
phase 4 (V_Z = 7548) and phase 7 (V_Z = 161) tables, 400M by default.
Prints each sort's seconds (the card's with its copies both ways) and
whether the two orders are equal, one JSON line a table:

    python3 tools/torch_synth_sort.py [--tuples N]

Exits 2 without a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def main() -> int:
    import torch

    from repro_torch.data.synth import _stable_sort

    ap = argparse.ArgumentParser()
    ap.add_argument("--tuples", type=int, default=400_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for name, v_z, seed in (("phase4_taxi", 7548, 44), ("phase7_minute", 161, 47)):
        freq = np.arange(1, v_z + 1, dtype=np.float64) ** -0.3
        z = np.random.default_rng(seed).choice(v_z, size=args.tuples,
                                               p=freq / freq.sum()).astype(np.int32)
        _stable_sort(z[:1 << 20], "cuda")  # the card's first sort starts its context
        torch.cuda.synchronize()
        t = time.perf_counter()
        card, card_sorted = _stable_sort(z, "cuda")
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host, host_sorted = _stable_sort(z, None)
        host_s = time.perf_counter() - t
        print(json.dumps(dict(table=name, tuples=args.tuples, v_z=v_z, host_s=host_s,
                              card_s=card_s, equal=bool(np.array_equal(card, host)
                                                        and np.array_equal(card_sorted,
                                                                           host_sorted)),
                              card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
