#!/usr/bin/env python3
"""How far float32 rounding alone moves a family's gradient in one
process: the gradient of phase 14l's cut model (chip_smoke.py's
SHARD_FAM_TRAIN config, seed 0, TF32 off) on tools/torch_phase14l.py's
8 x 256 random batch, computed whole and as the mean of its two 4-row
halves (what 14l's two data replicas sum), which are equal in exact
arithmetic. Prints, for each leaf, the largest |difference| over the
leaf's largest |grad| (floored as 14l floors it), worst first:

    python3 tools/torch_grad_noise.py [--cpu] [arch ...]   # default: xlstm_125m

(``--cpu``: its smoke config on the CPU, a rehearsal.) A family with aux
terms (MoE) is refused: its aux loss does not split over rows. Writes
chiprun_out/grad_noise.json; exits 2 without a CUDA device unless
--cpu.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _grads(grad_fn, state, batch, names) -> dict:
    from repro_torch.optimizer.base import tree_leaves

    grads = grad_fn(state, batch)[3]
    return {names[id(p)]: g.detach().clone() for p, g in zip(tree_leaves(state.params),
                                                              tree_leaves(grads))}


def main(args) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import TrainState
    from repro_torch.train.step import make_grad_fn

    cpu = "--cpu" in args
    archs = [a for a in args if a != "--cpu"] or ["xlstm_125m"]
    dev = "cpu" if cpu else "cuda"
    if not cpu and not torch.cuda.is_available():
        print("no CUDA device: this measures the GPU's rounding", file=sys.stderr)
        return 2
    card = "CPU" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    chip_smoke._fp32_matmuls(torch)
    meta = dict(device=dev, smoke=cpu, layers=None,
                prompts=np.random.default_rng(0).integers(
                    0, 151_000, (8, 32 if cpu else 256)).astype(np.int32))
    out = {}
    for arch in archs:
        cfg = chip_smoke._fam_train_cfg(meta, arch)
        if cfg.num_experts:
            print(f"{arch}: its aux terms do not split over rows", file=sys.stderr)
            return 1
        model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        state = TrainState.create(model, get_optimizer(cfg.optimizer, chip_smoke.TRAIN_LR))
        grad_fn = make_grad_fn(model)
        names = {id(p): name for name, p in model.named_parameters()}
        batch = chip_smoke._fam_train_batch(torch, meta, arch)
        whole = _grads(grad_fn, state, batch, names)
        again = _grads(grad_fn, state, batch, names)
        halves = [_grads(grad_fn, state, {k: v[rows] for k, v in batch.items()}, names)
                  for rows in (slice(0, 4), slice(4, 8))]
        tree_max = max(float(g.abs().max()) for g in whole.values())
        rel = {}
        for name, g in whole.items():
            scale = max(float(g.abs().max()), chip_smoke.SHARD_FAM_GRAD_FLOOR * tree_max)
            split = (halves[0][name] + halves[1][name]) / 2
            rel[name] = (float((split - g).abs().max()) / scale,
                         float((again[name] - g).abs().max()) / scale)
        worst = sorted(rel.items(), key=lambda kv: -kv[1][0])
        print(f"{arch} ({card}): whole batch against the mean of its halves, the largest "
              f"|difference| over the leaf's largest |grad|, worst leaves: "
              f"{[(n, round(r[0], 8)) for n, r in worst[:12]]}; whole batch twice: "
              f"{max(r[1] for r in rel.values())}", flush=True)
        out[arch] = dict(card=card, split=dict((n, r[0]) for n, r in worst),
                         repeat=max(r[1] for r in rel.values()))
        del model, state, grad_fn, whole, again, halves
        if not cpu:
            torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "grad_noise.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
