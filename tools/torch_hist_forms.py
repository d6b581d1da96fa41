#!/usr/bin/env python3
"""Time kernel B's forms and the private form's variants on one GPU.

    python3 tools/torch_hist_forms.py [--src DIR] [--quick] [--case NAME]

Kernel B (``csrc/histogram.cu``) has a global form and a private one.
``tools/hist_variants.cu``, which this script builds with nvcc beside
the port's kernels, holds the private form with each step swappable for
the alternative it was measured against; the bits of its ``form`` code:
per-thread counter columns (2) or warp-aggregated atomics (16) for the
plain shared atomics, a 4-block cluster's shared-memory merge for the
per-block global atomics (4), the last block's flush after a ticket for
the cooperative grid.sync() (8). For each shape below this script first
holds every variant the shape can take, and both forms of the port's
own entry, bitwise against the plain version (the ingest with input
counts and the fresh histogram, the scratch and its ticket zero after
each call), then times each with `chip_smoke.DeviceTimer`: the drift
monitor's (1, 64) on 587,776 crowded ids and the registry's (1, 14) on
91 ids, both z-less; the corpus selection's 64 x 128 on a 256-block
window (ingest); 7548 x 24 on the main path's window (the global form
alone); then both forms on 262,144 uniform ids at 64 x {16, 64, 128,
256, 512, 768} counts (where the private form's threshold lies), the
private form's grid pinned at (1, 64) and 64 x 128, and the fixed cost
with no samples. ``--quick`` stops after the first three shapes. The
report goes to ``chiprun_out/hist_forms.json``; the last line of
standard output is one JSON object. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS_CU = Path(__file__).resolve().with_name("hist_variants.cu")
# the private form's codes in hist_variants.cu (bit 0 set; variant 0 is
# the port's private form, pinned grids and all)
VARIANTS = {"private+columns": 3, "private+match": 17, "private+ticket": 9,
            "private+columns+ticket": 11, "private+match+ticket": 25, "private+cluster": 5,
            "private+columns+cluster": 7, "private+match+cluster": 21}
PINNED = 1
GRIDS = (16, 33, 66, 132, 264, 528)


def _variant_library(build):
    """Build (once per source hash) and bind ``fm_ingest_variant``."""
    digest = hashlib.sha256(VARIANTS_CU.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"hist_variants-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".so.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp), str(VARIANTS_CU)],
                       check=True, timeout=600)
        tmp.replace(out)
    fn = ctypes.CDLL(str(out)).fm_ingest_variant
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="where repro_torch lives")
    ap.add_argument("--quick", action="store_true", help="the first three shapes only")
    ap.add_argument("--case", action="append", default=[],
                    help="run only the cases whose name holds this (repeatable)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, histogram

    _build.build_all()
    variant_fn = _variant_library(_build)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    timer = cs.DeviceTimer(torch)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    scratch = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def variant_scratch(v_z, v_x):
        """The variants' own scratch: v_z * v_x floats and the ticket word."""
        if (v_z, v_x) not in scratch:
            scratch[v_z, v_x] = torch.zeros(v_z * v_x + 1, dtype=torch.float32, device=dev)
        return scratch[v_z, v_x]

    def launch(label, z, x, counts, rows, v_z, v_x, *, blocks=0, with_rowsums=True):
        """One call of the port's form `label` ("global", "private") or of
        the variant `label` (or, with ``blocks``, the pinned grid)."""
        if label in histogram.FORMS and not blocks:
            return cs._launch_form(torch, label, z, x, counts, rows, v_z, v_x,
                                   with_rowsums=with_rowsums)
        out = torch.empty((v_z, v_x), dtype=torch.float32, device=dev)
        n_out = torch.empty((v_z,), dtype=torch.float32, device=dev) if with_rowsums else None
        rc = variant_fn(
            None if z is None else z.data_ptr(), x.data_ptr(),
            None if counts is None else counts.data_ptr(),
            None if rows is None else rows.data_ptr(), out.data_ptr(),
            None if n_out is None else n_out.data_ptr(), variant_scratch(v_z, v_x).data_ptr(),
            x.numel(), v_z, v_x, VARIANTS.get(label, PINNED), blocks,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fm_ingest_variant {label} at {v_z} x {v_x}: CUDA error {rc}")
        return out, n_out

    def fits(label: str, v_z: int, v_x: int) -> bool:
        # the columns take 256 words a bin; every private variant stays
        # within the rule's bound
        bins = v_z * v_x
        return bins <= histogram.PRIVATE_MAX_BINS and ("columns" not in label
                                                       or bins * 1024 <= 200_000)

    def plain(z, x, counts, rows, v_z, v_x):
        zr = torch.zeros_like(x) if z is None else z
        return histogram.ingest_counts_ref(counts, rows, zr, x, v_z=v_z, v_x=v_x)

    def measure(name, z, x, v_z, v_x, labels, *, ingest=True, blocks=0):
        if args.case and not any(c in name for c in args.case):
            return None
        counts = t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32))
        rows = counts.sum(dim=1)
        want = plain(z, x, counts, rows, v_z, v_x)
        fresh = plain(z, x, torch.zeros_like(counts), torch.zeros_like(rows), v_z, v_x)
        words = (histogram.delta_scratch(v_z, v_x, dev), variant_scratch(v_z, v_x))
        out = dict(shape=[v_z, v_x], samples=int(x.numel()), z_less=z is None, ingest=ingest,
                   blocks=blocks, us={})
        for label in labels:
            got = launch(label, z, x, counts, rows, v_z, v_x, blocks=blocks)
            new = launch(label, z, x, None, None, v_z, v_x, blocks=blocks)
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip((*got, *new), (*want, *fresh)))
            cs.check(ok and not any(bool(w.any()) for w in words),
                     f"{name} {label}: not bitwise the plain version, or the scratch not zero")
            c, r = (counts, rows) if ingest else (None, None)
            ms, _ = timer(lambda label=label, c=c, r=r: launch(
                label, z, x, c, r, v_z, v_x, blocks=blocks, with_rowsums=ingest))
            out["us"][label] = ms * 1e3
        print(json.dumps({"case": name, **out}), flush=True)
        return out

    monitor_x = t(cs._skewed_ids(rng, 587_776, 64))
    registry_x = t(cs._skewed_ids(rng, 91, 14))
    corpus = [t(a) for a in cs._corpus_window_ids(rng)]
    taxi = [t(a) for a in cs._window_ids(rng, 7548, 24)]
    report = dict(card=card, cases=[])

    def variants(v_z, v_x):
        return ["global", "private", *(k for k in VARIANTS if fits(k, v_z, v_x))]

    report["cases"].append(measure("monitor", None, monitor_x, 1, 64, variants(1, 64),
                                   ingest=False))
    report["cases"].append(measure("registry", None, registry_x, 1, 14, variants(1, 14),
                                   ingest=False))
    report["cases"].append(measure("corpus", *corpus, 64, 128, variants(64, 128)))
    if not args.quick:
        report["cases"].append(measure("taxi", *taxi, 7548, 24, ["global"]))
        for v_x in (16, 64, 128, 256, 512, 768):
            z = t(rng.integers(0, 64, size=262_144).astype(np.int32))
            x = t(rng.integers(0, v_x, size=262_144).astype(np.int32))
            # past the rule's bound too, as far as a block's shared memory goes
            labels = ["global", "private", "private+match", "private+ticket"]
            report["cases"].append(measure(f"uniform 64 x {v_x}", z, x, 64, v_x, labels))
        for blocks in GRIDS:
            report["cases"].append(measure("monitor grid", None, monitor_x, 1, 64,
                                           ["private"], ingest=False, blocks=blocks))
            report["cases"].append(measure("corpus grid", *corpus, 64, 128, ["private"],
                                           blocks=blocks))
        # the fixed cost: no samples, beside a PyTorch fill of as many
        # floats; the private form's grid pinned
        empty = t(np.zeros(0, np.int32))
        for v_z, v_x in ((1, 14), (64, 128), (1, 8192)):
            report["cases"].append(measure("no samples", None if v_z == 1 else empty, empty,
                                           v_z, v_x, variants(v_z, v_x), ingest=False))
            for blocks in (2, 8, 64):
                report["cases"].append(measure("no samples grid", None if v_z == 1 else empty,
                                               empty, v_z, v_x, ["private"], ingest=False,
                                               blocks=blocks))
            if not args.case or any(c in "fill" for c in args.case):
                fill = torch.empty(v_z * v_x, device=dev)
                ms, _ = timer(fill.zero_)
                report["cases"].append(dict(case="fill", shape=[v_z, v_x],
                                            us={"zero_": ms * 1e3}))
                print(json.dumps(report["cases"][-1]), flush=True)
    report["cases"] = [c for c in report["cases"] if c is not None]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "hist_forms.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": True, "cases": len(report["cases"]), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
