"""FLOPs and collective bytes a device of the production cells whose
heads do not divide over "model", on the meta device (no card, no
process group).

Where a rank's heads are not its even column block, its attention (or
mLSTM) output meets ``wo``'s (``w_down``'s) even row block through
`layers.row_parallel_span`: the output assembled whole from zero-filled
buffers (one all-reduce of the activation), then its row block. The
port's run is ``--design assembled``. ``--design rows`` records the
other design, which the port does not take: ``wo``'s row blocks gathered
whole (one all-reduce of the weight), then its rows of the rank's heads;
it is patched in here only. Each cell of ``CELLS`` runs through
`launch.dryrun.run_cell` on the pod at rank (0, 0), a busiest rank
(`transformer.rank_heads` gives rank 0 a largest share); ``--ranks all``
also runs every model rank and reports the most FLOPs and where.

  PYTHONPATH=src python tools/torch_head_split.py [--design rows] [--ranks all] [--out FILE]

Prints one JSON line a cell.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch import dryrun
from repro_torch.models import layers as L

CELLS = (("recurrentgemma-2b", "train_4k"), ("recurrentgemma-2b", "prefill_32k"),
         ("recurrentgemma-2b", "decode_32k"), ("recurrentgemma-2b", "long_500k"),
         ("xlstm-125m", "decode_32k"), ("xlstm-125m", "long_500k"))


def _span_rows(x, lo: int, width: int, w, tp):
    """`layers.row_parallel_span` through ``W`` gathered whole: its rows
    of the span against ``x``, one all-reduce after."""
    return L.row_parallel(x, L.gather_block(w, width, 0, tp)[lo : lo + x.shape[-1]], tp)


def _cell(arch: str, shape: str, coordinate=None) -> dict:
    res = dryrun.run_cell(arch, shape, "pod", verbose=False, coordinate=coordinate)
    return dict(flops=res["flops_per_device"], coll_bytes=res["collective_bytes_per_device"],
                calls=sum(v["count"] for v in res["collectives"].values()), run_s=res["run_s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", choices=("assembled", "rows"), default="assembled")
    ap.add_argument("--ranks", choices=("first", "all"), default="first")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)
    port = L.row_parallel_span
    if args.design == "rows":
        L.row_parallel_span = _span_rows
    lines = []
    try:
        for arch, shape in CELLS:
            line = dict(arch=arch, shape=shape, design=args.design, rank=[0, 0],
                        **_cell(arch, shape))
            if args.ranks == "all":
                per = [_cell(arch, shape, (0, r))["flops"] for r in range(16)]
                line.update(rank_flops=per, busiest=int(max(range(16), key=per.__getitem__)))
            lines.append(line)
            print(json.dumps(line), flush=True)
    finally:
        L.row_parallel_span = port
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
