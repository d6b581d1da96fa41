"""The JAX reference's dry-run FLOPs a device with every attention in one
KV chunk: the yardstick for the port's chunked cells.

XLA's ``cost_analysis`` counts a ``while`` body once. The reference's
dry run says so and extrapolates ``scan_layers`` from unrolled 1- and
2-layer compiles, but its `attention_chunked` also scans, over KV chunks
of ``cfg.attn_chunk`` (1,024) wherever the keys are longer than 2,048,
so a cell longer than that is counted at one chunk's attention. This
runs the reference's own ``run_cell`` with ``get_config`` wrapped to set
``attn_chunk`` to the cell's sequence length: one trip of the loop, the
same math.

It imports the JAX reference (so it is not a ``torch_`` tool and never
runs on the card) and, as the reference's dry run does, compiles the
cell for the production mesh's placeholder host devices on the CPU:

  PYTHONPATH=src python tools/ref_dryrun_one_trip.py --arch recurrentgemma-2b --shape prefill_32k

Prints one JSON line: the cell, ``flops_per_device`` with one trip and
``attn_chunk`` as set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro.launch import dryrun, specs  # dryrun sets the host device count first
from repro.configs.base import SHAPES, get_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod"))
    args = ap.parse_args(argv)
    seq = SHAPES[args.shape].seq_len

    def one_trip(arch):
        return dataclasses.replace(get_config(arch), attn_chunk=seq)

    dryrun.get_config = specs.get_config = one_trip
    res = dryrun.run_cell(args.arch, args.shape, args.mesh, verbose=False)
    print(json.dumps(dict(arch=args.arch, shape=args.shape, mesh=args.mesh, attn_chunk=seq,
                          flops_per_device=res["flops_per_device"],
                          cost_method=res["cost_method"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
