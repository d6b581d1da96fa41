#!/usr/bin/env python3
"""Where `moe.moe_ffn_mesh`'s two expert buffers cross, on one GPU: ms a
call of one MoE layer at mixtral-8x7b's widths (seeded random experts
in bfloat16: the whole ff, or one model rank's block of it), on a single
process with no collective, at the dropless capacity, for token counts
from a decode tick's to a prefill's, once with the batched (E, min(C,
T)) buffer and once with the T*K pairs sorted by expert
(`moe.BATCHED_EXTRA_ROWS` set each way):

    python3 tools/torch_moe_buffers.py [--tokens 1 2 4 ...] [--splits 1 2] [--calls 20]

Each shape runs batched, sorted, sorted, batched (a warm-up call before
each run of ``--calls`` timed calls, wall time with a sync at the end:
the sorted pairs' host read of the counts is part of a call) and keeps
each buffer's mean. It prints the card, a line a shape (the batched
buffer's rows beyond the pairs, ms for each buffer) and, for each split,
the most extra rows at which the batched buffer still won; the report
goes to chiprun_out/moe_buffers.json. Exits 2 without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

TOKENS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512)


def _ms(torch, call, calls: int) -> float:
    call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=list(TOKENS))
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2],
                    help="model ranks the ff dim is split over (a rank's block is timed)")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    if not torch.cuda.is_available():
        print("no CUDA device: the buffers are timed on a GPU", file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    cfg = get_config("mixtral_8x7b")
    e, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    axes = types.SimpleNamespace(data_groups=(), num_workers=1, worker=0)  # one rank
    gen = torch.Generator(device="cuda").manual_seed(0)
    keep = moe.BATCHED_EXTRA_ROWS
    out = dict(card=card, arch=cfg.arch_id, dtype="bfloat16", calls=args.calls, shapes=[])
    try:
        for split in args.splits:
            params = moe.init_moe(d, cfg.d_ff // split, e, torch.bfloat16, generator=gen,
                                  device="cuda")
            won = None
            for t in args.tokens:
                x = torch.randn((1, t, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                extra = e * t - t * k  # the dropless capacity holds min(C, T) = T a expert

                def call():
                    return moe.moe_ffn_mesh(params, x, num_experts=e, top_k=k,
                                            capacity_factor=float(e), axes=axes, tp=None,
                                            global_slots=False)

                ms = {"batched": [], "sorted": []}
                with torch.no_grad():
                    for name in ("batched", "sorted", "sorted", "batched"):
                        moe.BATCHED_EXTRA_ROWS = float("inf") if name == "batched" else -1
                        ms[name].append(_ms(torch, call, args.calls))
                row = dict(split=split, ff=cfg.d_ff // split, tokens=t, extra_rows=extra,
                           batched_ms=ms["batched"], sorted_ms=ms["sorted"])
                mean = {n: sum(v) / len(v) for n, v in ms.items()}
                if mean["batched"] < mean["sorted"] and (won is None or won < extra):
                    won = extra
                out["shapes"].append(row)
                print(f"ff {cfg.d_ff // split} tokens {t}: extra rows {extra}, batched "
                      f"{ms['batched']} ms, sorted {ms['sorted']} ms", flush=True)
            out[f"batched_won_up_to_rows_ff{cfg.d_ff // split}"] = won
            print(f"ff {cfg.d_ff // split}: the batched buffer won up to {won} extra rows",
                  flush=True)
            del params
    finally:
        moe.BATCHED_EXTRA_ROWS = keep
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_buffers.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
