#!/usr/bin/env python3
"""How far two bfloat16 evaluations of the same model land apart on one GPU.

For each architecture named, the model is drawn at full width from seed 0
in bfloat16 and prefilled on 8 rows of 256 tokens (uniform ids from seed
0), then decoded ``--ticks`` greedy ticks. The same rows are run twice:
all 8 rows as one batch, and the first 4 rows as a batch of their own.
The two differ only in the shapes of the products (the f32 rounding of
each product), so their distance is the spread of bf16 evaluation itself.
The float32 evaluation of the same bf16 weights, fed the same tokens,
gives each bf16 run's distance from exact arithmetic. A sharded model's
logits can be held to one process's no closer than this spread:

    python3 tools/torch_bf16_spread.py [--archs xlstm_125m,...] [--ticks T]

The last line of its standard output is one JSON object with the
results; it exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _run(torch, model, toks, ticks: int, forced=None) -> tuple:
    """The prefill's last logits and ``ticks`` ticks' (greedy, or fed
    ``forced``), float32 numpy, and the tokens fed."""
    logits, cache = model.prefill(toks, 512)
    steps, fed = [logits[:, -1].float()], []
    for i in range(ticks):
        tok = torch.argmax(steps[-1], dim=-1) if forced is None else forced[:, i]
        fed.append(tok)
        logits, cache = model.decode_step(cache, tok)
        steps.append(logits.float())
    return [s.cpu().numpy() for s in steps], torch.stack(fed, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="xlstm_125m,recurrentgemma_2b,qwen2_5_3b")
    ap.add_argument("--ticks", type=int, default=7)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    out = {"card": card, "archs": {}}
    with torch.no_grad():
        for arch in args.archs.split(","):
            cfg = get_config(arch)
            toks = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (8, 256))).to("cuda")
            model = get_model(cfg, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
            eight, fed = _run(torch, model, toks, args.ticks)
            four, _ = _run(torch, model, toks[:4], args.ticks, fed[:4])
            exact = copy.deepcopy(model).float()
            exact.cfg = dataclasses.replace(cfg, dtype="float32")
            del model
            f32, _ = _run(torch, exact, toks[:4], args.ticks, fed[:4])
            del exact
            torch.cuda.empty_cache()
            res = dict(
                bf16_batch8_vs_batch4=[float(np.abs(a[:4] - b).max()) for a, b in zip(eight, four)],
                bf16_batch8_vs_f32=[float(np.abs(a[:4] - b).max()) for a, b in zip(eight, f32)],
                bf16_batch4_vs_f32=[float(np.abs(a - b).max()) for a, b in zip(four, f32)],
                largest_abs_logit=float(np.abs(f32[0]).max()))
            out["archs"][arch] = res
            print(arch, {k: (round(min(v), 4), round(max(v), 4)) if isinstance(v, list) else v
                         for k, v in res.items()}, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
