"""Render the roofline table from the dry run's JSONs.

Port of `repro.launch.roofline`, over `repro_torch.launch.dryrun`'s
results (``build/dryrun`` by default), with the reference's columns.
The terms are the dry run's model of one rank on an H100 SXM
(`dryrun.CARD`), not measurements.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod] [--results DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import RESULTS

__all__ = ["fmt_bytes", "load", "render"]


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def load(mesh: str, results=RESULTS) -> list:
    """The JSONs of ``mesh`` ("pod" or "multipod") under ``results``."""
    rows = []
    for p in sorted(pathlib.Path(results).glob(f"*_{mesh}.json")):
        d = json.loads(p.read_text())
        if d.get("mesh") == mesh:
            rows.append(d)
    return rows


def render(mesh: str, md: bool = True, results=RESULTS) -> str:
    rows = load(mesh, results)
    out = []
    header = (
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | bound | "
        "roofline-frac | model/HLO flops | HBM/dev |"
    )
    out.append(header)
    out.append("|" + "---|" * 9)
    for d in rows:
        if d.get("skipped"):
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | skipped | — | — | — |")
            continue
        if not d.get("ok"):
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | FAILED | — | — | — |")
            continue
        r = d["roofline"]
        tc, tm, tl = r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]
        dom = max(tc, tm, tl)
        frac = tc / dom if dom > 0 else 0.0
        hbm = d["memory"]["argument_bytes"] + d["memory"]["temp_bytes"] + d["memory"]["output_bytes"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {tc*1e3:.2f} | {tm*1e3:.2f} | {tl*1e3:.2f} "
            f"| {r['bottleneck']} | {frac:.3f} | {d['useful_flops_ratio']:.3f} "
            f"| {fmt_bytes(hbm)} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod"))
    ap.add_argument("--results", default=str(RESULTS), help="the dry run's --out directory")
    args = ap.parse_args(argv)
    print(render(args.mesh, results=args.results))


if __name__ == "__main__":
    main()
