"""Quickstart on the PyTorch / CUDA port: top-k histogram matching with
HistSim/FastMatch.

The port's twin of examples/quickstart.py, with its inputs and its
lines. Recreates the paper's running example (Q1): "which countries
have income distributions most similar to Greece's?" on a synthetic
census, and shows the engine touching a small fraction of the data
while satisfying the separation/reconstruction guarantees. Runs on the
GPU (the port's CUDA kernels) unless ``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.core.engine import EngineConfig, run_engine
from repro_torch.core.histsim import HistSimParams
from repro_torch.data.layout import block_layout
from repro_torch.data.synth import SynthSpec, make_dataset

# A census-like table: Z = country (161 of them), X = income bracket
# (7 brackets, paper Fig. 1), ~6M rows. Ten countries are planted with
# income distributions close to the target country's.
SPEC = SynthSpec(
    v_z=161, v_x=7, num_tuples=6_000_000, k=10, n_close=10,
    close_distance=0.02, far_distance=0.3, zipf_a=1.0, seed=0,
)


def run(spec: SynthSpec = SPEC, device=None, *, lookahead: int = 512) -> dict:
    """The example on ``device`` (the GPU unless "cpu"): its result, the
    dataset's ground truth and the lines it prints (``lines``)."""
    device = resolve_device(device)
    lines = ["generating synthetic census ..."]
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, seed=spec.seed)

    # "Greece" = the planted target distribution; eps/delta = paper defaults
    params = HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=spec.k, eps=0.06, delta=0.01)
    lines.append(f"matching against target across {blocked.num_blocks} blocks ...")
    res = run_engine(blocked, ds.target, params,
                     EngineConfig(variant="fastmatch", lookahead=lookahead), device=device)

    lines.append(f"\ntop-{params.k} matching countries (ids): {sorted(res.ids.tolist())}")
    lines.append(f"planted ground truth:                    {sorted(ds.true_top_k.tolist())}")
    lines.append(
        f"\nread {res.blocks_read}/{blocked.num_blocks} blocks "
        f"({res.blocks_read / blocked.num_blocks:.1%}) in {res.rounds} rounds, "
        f"{res.wall_time_s:.2f}s wall"
    )
    lines.append(f"certified failure probability delta_upper = {res.delta_upper:.2e} (< 0.01)")
    est = res.state.tau.cpu().numpy()[res.ids]
    true = ds.true_dists[res.ids]
    lines.append("\n  id   est-dist  true-dist")
    for i, e, t in zip(res.ids, est, true):
        lines.append(f"  {i:4d}  {e:.4f}    {t:.4f}")
    return dict(result=res, true_top_k=ds.true_top_k, num_blocks=blocked.num_blocks,
                est=est, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(SPEC, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
