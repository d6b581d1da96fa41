#!/usr/bin/env python3
"""Time kernel C's wide branch on the GPU and split one launch into phases.

    python3 tools/torch_wide_profile.py [--src DIR]

For each shape of `chip_smoke.C_SHAPES`' wide rows (and Q in {1, 8}) it
prints the device time of one f32 launch and one uint16 launch (the
smoke's `DeviceTimer`: launches queued behind a sleep kernel, CUDA
events), then the median time each block spends in the wide tile's
phases: a copy of ``csrc/distance.cu``, built into a temporary
directory, has block thread 0 read ``%globaltimer`` at the phase
boundaries of `wide_tile_tau` (issue the loads; sum the rows; the
denominators; score; reduce; write), the lines ``// PROFILE-MARK 0`` to
``6`` in the source, launched once. A source that lacks a mark, or
holds one twice, stops the script. The stamps cost
about 0.1 us each, so the phases add to a little more than a launch.
Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((161, 1440, 0), (256, 8192, 0), (7548, 1440, 0), (191, 2, 2), (3, 524_288, 0))
PHASES = ("issue", "row sums", "denominators", "score", "reduce", "write")
MARK = re.compile(r"^\s*// PROFILE-MARK (\d+)\b")


def stamped_source(text: str) -> str:
    """``text`` with thread 0 of each block stamping the time at each mark."""
    lines = text.split("\n")
    marks = {i: int(m.group(1)) for i, line in enumerate(lines) if (m := MARK.match(line))}
    if sorted(marks.values()) != list(range(len(PHASES) + 1)):
        raise SystemExit(f"distance.cu holds PROFILE-MARKs {sorted(marks.values())}, "
                         f"not 0 to {len(PHASES)} once each")
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i in marks:
            out.append('  { unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : '
                       '"=l"(t)); if (threadIdx.x == 0 && g_stamps) '
                       f'g_stamps[blockIdx.x * 8 + {marks[i]}] = t; }}')
    text = "\n".join(out).replace("namespace {", "__device__ unsigned long long* g_stamps;\n"
                                  "namespace {", 1)
    return text + ('\nextern "C" int fm_set_stamps(void* p) '
                   '{ return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }\n')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="where repro_torch lives")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernel runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build, metrics

    csrc = args.src / "repro_torch" / "kernels" / "csrc"
    text = (csrc / "distance.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "distance.cu", Path(tmp) / "distance.so"
        src.write_text(stamped_source(text))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                        str(lib_path), str(src)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    wide = lib.fm_distance_wide
    wide.argtypes, wide.restype = [P, P, P, I, I, I, I, P], I
    lib.fm_set_stamps.argtypes = [P]

    timer = chip_smoke.DeviceTimer(torch)
    print(f"card: {chip_smoke.phase_setup(torch)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for v_z, v_x, sweeps in SHAPES:
        counts = torch.randint(0, 40, (v_z, v_x), generator=gen, device="cuda").float()
        c16, fits = counts.to(torch.uint16), torch.amax(counts) <= 65535.0
        for q in (1, 8):
            t = torch.rand((q, v_x), generator=gen, device="cuda")
            t = (t / t.sum(dim=1, keepdim=True)).contiguous()
            ms, _ = timer(lambda: metrics.distance_multi(counts, t, sweeps=sweeps))
            ms16, _ = timer(lambda: metrics.distance_multi(c16, t, sweeps=sweeps,
                                                           gate=(counts, fits)))
            tau = torch.empty((q, v_z), device="cuda")
            stamps = torch.zeros((v_z * 8 + 8) * 8, dtype=torch.int64, device="cuda")
            lib.fm_set_stamps(ctypes.c_void_p(stamps.data_ptr()))
            rc = wide(counts.data_ptr(), t.data_ptr(), tau.data_ptr(), v_z, v_x, q, 0,
                      torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            lib.fm_set_stamps(ctypes.c_void_p(0))
            rows = stamps.view(-1, 8).cpu().numpy()
            rows = rows[rows[:, 0] > 0]
            phases = ({name: statistics.median((rows[:, k + 1] - rows[:, k]).tolist()) / 1e3
                       for k, name in enumerate(PHASES)} if len(rows) else "two-sweep form")
            print(f"{v_z} x {v_x} sweeps={sweeps} Q={q}: f32 {ms * 1e3:.2f} us, uint16 "
                  f"{ms16 * 1e3:.2f} us; rc {rc}; blocks stamped {len(rows)}; median us a "
                  f"block by phase: {phases}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
