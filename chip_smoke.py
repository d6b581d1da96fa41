#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastMatch on one NVIDIA GPU and check it.

Run from the root of a checkout (one card; about 9 to 12 minutes at the
default size, most of it generating the two datasets on the host):

    python3 chip_smoke.py [--tuples N] [--seed S]

Phases, each of which raises (non-zero exit) when a check fails:

1. Setup: build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel) and print the card's name and power limit.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes: AnyActive on a gathered 512-block window of 236
   words; kernel A as the round runs it, the final marks of a 512-id
   window read in place from a 781,250 x 236 bitmap table (737 MB, made
   on the card from a seed): on a permuted window with padding rows,
   rows read already and a bit-31 row, in the table, gathered-window and
   scan forms, and at W = 237 (the word-by-word path), then timed warm
   and with the table cold against the parent's six-launch marking
   (gather, A, &, read-mask gather, ~, &); the fused ingest of one
   262,144-id window into 7548 x 24 counts, its ids drawn as the main
   path sends them (z zipf 0.3, the tuples of ~10 % of the blocks -1),
   and of uniform, out-of-range and empty batches: bitwise equal to its
   plain version, its inputs unchanged and its scratch back at zero,
   and the fresh histograms it also serves; the batched distance for Q
   in {1, 8} and every metric at 7548 x 24 (narrow branch) and, in the
   wide branch, at 256 x 8192, 161 x 1440 (phase 7's shape), 7548 x 1440,
   191 x 2 under a forced sweeps = 2 and 3 x 524,288 (past the shared
   memory of a cluster: the two-sweep fallback), each in its f32 and its
   uint16 form (bitwise the f32 form), and the uint16 gate on counts
   holding 70,000 (both branches: bitwise the f32 form).
   Integer outputs must be equal, tau within 2e-5. Each check prints its device time (CUDA events around
   launches queued behind a sleep kernel, so the card runs them back to
   back), the kernel alone into preallocated outputs, the plain
   version's and, where one PyTorch call computes the same function,
   that call's; beside B and C, the whole `multiquery.ingest` and
   `multiquery.stats_step` at Q = 1, the whole gated uint16 tau step,
   kernel C under the plan the scheduler resolves for the taxi key at
   Q = 1 and 8 (the main path's launch; ``plan`` and ``plan_ms`` in the
   ``kernels`` line) and the reference's one-broadcast `xla` form (plain
   PyTorch). One ingest under the profiler must run kernel B and
   nothing else.
3. The engine on the test fixture (3M tuples): FastMatch at seed 3 on the
   card and on the CPU must return the same ids, counters and counts,
   and tau within 2e-5. Then `MatchServer` on the same fixture, for
   metric l1 and hellinger: three top-k queries (one with a tuples
   stop) and two closeness queries admitted after the first
   retirement; the card and the CPU must give the same ids, counters
   and stop fields. Then l1 on the card again under
   ``kernel_plans=PlanPair(TauPlan(sweeps=2, lowprec=True),
   IngestPlan(fused=False))``: kernel C's wide uint16 branch and the
   unfused ingest must give the default plans' ids and counters.
4. The engine at the paper's data scale: the TAXI-q1 shape (V_Z = 7548,
   V_X = 24, zipf 0.3, k = 10, eps = 0.12, delta = 0.01, lookahead 512)
   with 400M tuples resident on the card, under the kernel plans the
   scheduler resolves from benchmarks/results/tuned_torch/cuda.json
   (printed). FastMatch (seed 0) runs with every kernel's launch count
   set to 0 just before and read just after; kernels A and B must have
   launched once per round (and at 400M, seed 0: 27 rounds, 12,395
   blocks), kernel C in the form the plan names (Q times a stats step
   under an unrolled plan) and in no other form. Then Scan, counts reset
   again: A and B once per round, and its tau must equal the
   generator's true distances within 2e-5, FastMatch must not be exact,
   must read under half the blocks and must meet Guarantee 1 against
   Scan's exact distances. Both run again under a pinned lowprec plan
   (a plan file under build/): the same ids, rounds and blocks, kernel C
   only in its uint16 form, Scan's tau again within 2e-5 of the true
   distances; Scan's final max count says whether the gate tripped.
   A second FastMatch run under torch.profiler gives the device time by
   kernel and the PyTorch launches per round, and must gather no rows of
   the bitmap table.
5. Serving at full width on phase 4's resident table: `MatchServer(
   max_queries=8, lookahead=512, metric="l1")` answers 8 top-k queries
   (k = 10, eps = 0.12, delta = 0.01; the dataset's target and 7
   perturbations of it at l1 0.05-0.3; the target's own query stops at
   half the tuples its solo `run_engine` reads) and 4 closeness queries
   (eps = 0.10, gap = 0.20, delta = 0.01) submitted after the first
   retirement, one of them followed through `iter_results`. Counts at
   0 just before, read just after: kernels A and B once per round,
   kernel C per statistics step as the server's resolved plan says
   (printed), always called at Q = 8. Every answer is
   checked against the exact tau (kernel C's plain version over Scan's
   final counts): top-k answers (eps, k)-correct, closeness labels
   right outside the gap, the stop and the stream as specified. It
   prints walls, rounds, host syncs, shared against solo tuples, a warm
   re-submission's tuples, a profiled rerun's kernels and launches per
   round, and kernel C and `stats_step` at Q = 8.
8. The I/O, fault and recovery layer, right after phase 5 on its resident
   table, each sub-phase with the launch counts at 0 just before and read
   just after (kernels A and B at least once a round, kernel C at least
   once a statistics step) and its wall printed. 8a: phase 5's workload
   through `maybe_chaos` (FASTMATCH_CHAOS=1, seed 0): every request's ids,
   rounds, tuples and ``exact`` phase 5's, tau bitwise, retries > 0, not
   degraded, ``eps_effective == eps``. 8b: the same workload through
   ``ResilientSource(FaultySource(source, FaultPlan(p_corrupt=0.02,
   p_truncate=0.02), seed=5))``: blocks are quarantined, every outcome
   reports ``degraded`` and ``eps_effective = eps + 2q`` for the q known at
   its own retirement, the counts and n are bitwise the `torch.bincount`
   histogram of exactly the blocks the read mask marks (no quarantined
   tuple reached ingest), top-k answers meet Guarantee 1 at
   ``eps_effective`` and closeness labels are right outside the gap widened
   by 2q. 8c: a `ServeSupervisor` over the resident table serves the 8
   top-k targets with snapshots every 2 retirements; a `FaultySource`
   crashes it halfway through the rounds of an uncrashed run: one restart,
   every answer meets Guarantee 1, the restored cache is bitwise the
   snapshot's files, device memory after the recovery is within 8 MB of
   before the crash, and `MatchServer.restore` on the same files answers
   the last-retired target with 0 new tuples; each save's bytes and wall
   and the recovery's wall are printed. 8d: phase 4's FastMatch query from
   a host-resident source over the kept host arrays without and with
   prefetch, then from the resident table with prefetch: bitwise the same
   ids, tau, rounds and blocks (27 and 12,395 at 400M, seed 0), no prefetch
   worker alive after; walls (each the second run, after a warm-up) and
   device busy shares printed. 8b and 8c run with telemetry on: in 8b the
   registry's ``fastmatch_blocks_quarantined_total`` and the
   ``window_quarantine`` events must be the sources' quarantine (2,048
   blocks in 4 windows at 400M, seed 0); in 8c ``serve_crashes_total`` and
   ``serve_recoveries_total`` must be 1 and ``checkpoint_saves_total`` the
   saves the phase counts.
9. Telemetry, right after phase 8 on its resident table: phase 5's
   workload six times in one process, telemetry off and on in turns
   (``MatchServer(telemetry=True)``), counts at 0 just before each run and
   read just after. Every run must be bitwise phase 5 (each request's
   ids, rounds, tuples, ``exact`` and tau; ``host_syncs``, ``loop_syncs``
   and the exported cache) with phase 5's launches; a profiled on run must
   make phase 5's PyTorch launches a round. On each on run the registry's
   counters must equal the scheduler's mirrors and every curve point's
   ``eps_n`` Theorem 1 at its ``n_min``; the on runs' skeletons must be
   equal; ``export_trace`` and ``prometheus_metrics`` must round-trip; the
   registry's read must launch kernel B once a non-empty histogram and bin
   bitwise as ``np.bincount``. It prints the walls, the accounted
   telemetry host time (every telemetry entry point timed on the last on
   run, as the reference's benchmarks/telemetry_overhead.py accounts it)
   as a share of the off walls' median, the ``round_batch`` split of
   each on run's wall into gather, dispatch and sync, and kernel B at the
   registry's shape against its plain version and `torch.bincount`.
10. The mesh and the data-parallel pump, right after phase 9 on phase
   4's table (7548 x 24: V_Z divides by 2 and 4), generating none: the
   host arrays go into shared memory and four gloo ranks on the card
   (`distributed.run_ranks`) map them; each sub-phase has its own launch
   counts on every rank (kernels A and B once a round, kernel C at least
   once a statistics step). 10a: a 2 x 2 (data x model) `DistributedPump`
   and the single-stream scheduler here, driven with the same 12
   shuffled global windows of 512 blocks, 3 queries admitted first (the
   first stops after two windows of tuples), a fourth at round 3: every
   round's counts, n, read mask, counters, live and retired slots equal,
   and tau and delta_upper bitwise (within the Theorem-1 tolerance of
   `tests/test_torch_rounds.py` if the shard resolved another plan). 10b: phase 4's query
   through `MatchServer(mesh=, pump=True)`, first on a one-rank NCCL
   mesh here, bitwise phase 4 (ids, rounds, blocks, tau, counts, n,
   delta_upper), then on a 4 x 1 pump: Guarantee 1 against Scan's exact
   tau, the bound fired, and the counts and n bitwise the histogram of
   the blocks the read mask marks. 10c: phase 5's workload through a
   2 x 2 pump server, every answer through phase 5's checks. It prints
   rounds, passes, blocks, walls beside phases 4 and 5, every worker's
   gather seconds, collective calls, KB and host ms a round and kernel
   launches a round on every rank, and the phase's seconds with the
   children's start-up; ``{"check": "mesh", ...}``.
   The host arrays are dropped after phase 10.
6. The tuner on the card at the taxi keys (Q = 1 and 8 for l1, Q = 8
   for chi2 and hellinger, and the ingest) into build/tuned_smoke/: every
   candidate's time, and whether each winner is the committed file's
   (reported, not checked).
7. Wide rows: FastMatch at the minute-of-day shape, after phases 4 and 5
   freed their table. FLIGHTS' scheduled departure at minute resolution
   (V_Z = 161 origin airports, V_X = 1440, zipf 0.3, seed 47) with
   ``--tuples`` (400M) resident on the card, phase 4's query (k = 10,
   eps = 0.12, delta = 0.01, lookahead 512) and phase 4's checks:
   FastMatch with A and B once per round (and at 400M, seed 0: 53
   rounds, 27,134 blocks) and kernel C only in its wide f32 form; Scan's
   tau the true distances; Guarantee 1; the pinned
   lowprec plan with the same ids, rounds and blocks, tau bitwise the
   default's and kernel C only as its wide uint16 form; a profiled rerun.

Every kernel must have launched on some path, each path's counts set to
0 just before it and read just after; a kernel's ``launches`` in the
``kernels`` line are those of the first path that runs it (``path``),
with every path's count beside them; kernel B's row adds the registry
read's launches and its registry-shape timing. The last lines are the
``kernels`` JSON line, the card's name and power limit from
nvidia-smi, and ``{"ok": true, "device": {...}}``. Results
also go to ``chiprun_out/chip_smoke.json``. Exits 2 without a CUDA
device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TAU_ATOL = 2e-5
# Peaks of one H100 SXM (NVIDIA's data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

T0 = time.perf_counter()
T0_WALL = time.time()  # this module's import, comparable across processes


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class DeviceTimer:
    """Device time of one call: ``reps`` calls queued behind a sleep kernel
    long enough to cover their enqueue, timed with CUDA events, so the
    card runs them back to back and host overhead stays out. Median over
    ``batches``; also the host's enqueue time per call."""

    def __init__(self, torch):
        self.torch = torch
        start, end = self._events()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.ms_per_cycle = start.elapsed_time(end) / 10_000_000

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def __call__(self, fn, *, reps: int = 30, batches: int = 5) -> tuple:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        cycles = int(3.0 * host_ms / self.ms_per_cycle) + 100_000
        per_call, host = [], []
        for _ in range(batches):
            start, end = self._events()
            torch.cuda._sleep(cycles)
            start.record()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            host.append((time.perf_counter() - t) * 1e3 / reps)
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / reps)
        return statistics.median(per_call), statistics.median(host)


def _device_kernels(torch, fn, *, tries: int = 3) -> list:
    """Names of the device kernels one call of ``fn`` runs, under the
    profiler. A capture that comes back empty (CUPTI drops one now and
    then; a call that ran nothing on the card shows the same) is taken
    again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            break
    return names


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _check_fields(row: dict) -> dict:
    """A kernel measurement as a check line prints it (``kernel_ms``)."""
    return {("kernel_ms" if k == "ms" else k): v for k, v in row.items()}


def phase_setup(torch):
    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SOURCES)} kernel libraries in {time.perf_counter() - t:.1f}s")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}.cu ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    log(f"card: {smi}")
    return smi


# kernel C's phase-2 shapes: (V_Z, V_X, the plan's sweeps)
C_SHAPES = ((7548, 24, 0), (256, 8192, 0), (161, 1440, 0), (7548, 1440, 0), (191, 2, 2),
            (3, 524_288, 0))


def phase_kernels(torch, timer) -> dict:
    """Every kernel against its plain version at the main path's shapes.
    Returns the main-path measurement of each kernel by name."""
    import numpy as np

    from repro_torch.core.bitmap import words_for
    from repro_torch.kernels import anyactive, histogram, metrics, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    main = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the fixed cost of one launch in this timer: a kernel that does nothing
    floor_ms, _ = timer(lambda: torch.cuda._sleep(0))
    emit({"check": "launch_floor", "kernel_ms": floor_ms})

    # -- A: AnyActive, one lookahead window of the TAXI shape
    L, W = 512, words_for(7548)
    bm = rng.integers(0, 2**32, size=(L, W), dtype=np.uint32)
    mask = rng.integers(0, 2**32, size=(W,), dtype=np.uint32)
    bm[rng.random(L) < 0.5] &= ~mask  # half the blocks hold no active candidate
    bm[3] = 0
    bm[3, 7] = 1 << 31  # a block holding only a bit-31 candidate
    mask[7] |= np.uint32(1 << 31)
    b, m = t(bm.view(np.int32)), t(mask.view(np.int32))
    got, want = anyactive.anyactive(b, m), ref.anyactive_ref(b, m)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and bool(got[3]), "anyactive disagrees with its plain version")
    ms, host = timer(lambda: anyactive.anyactive(b, m))
    plain, _ = timer(lambda: ref.anyactive_ref(b, m))
    bnd, by = bound_ms(L * W * 4 + W * 4 + L, 2 * L * W)
    emit({"check": "anyactive", "shape": [L, W], "marked": int(got.sum()), "equal": True,
          "kernel_ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
          "host_us": host * 1e3})
    main["anyactive"] = _phase_marking(torch, timer)

    # -- B: the fused ingest of one lookahead window (512 blocks x 512 tuples)
    from repro_torch.core import multiquery as mq

    v_z, v_x, n = 7548, 24, 262_144
    z, x = (t(a) for a in _window_ids(rng, v_z, v_x))
    uniform = [t(rng.integers(0, v, size=n).astype(np.int32)) for v in (v_z, v_x)]
    dropped = [t(rng.integers(-2, v + 2, size=n).astype(np.int32)) for v in (v_z, v_x)]
    empty = [t(np.zeros(0, np.int32))] * 2
    counts = t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32))
    rows = counts.sum(dim=1)
    scratch = histogram.delta_scratch(v_z, v_x, dev)
    cases = ((z, x, "zipf window ids"), (*uniform, "uniform ids"),
             (*dropped, "out-of-range ids"), (*empty, "empty batch"))
    for zz, xx, tag in cases:
        kept = [a.clone() for a in (counts, rows, zz, xx)]
        got = histogram.ingest_counts(counts, rows, zz, xx, v_z=v_z, v_x=v_x)
        want = histogram.ingest_counts_ref(counts, rows, zz, xx, v_z=v_z, v_x=v_x)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ingest_counts disagrees with its plain version ({tag})")
        check(all(torch.equal(a, b) for a, b in zip((counts, rows, zz, xx), kept)),
              f"ingest_counts changed its inputs ({tag})")
        check(not bool(scratch.any()), f"ingest_counts left the scratch nonzero ({tag})")
        c, r = histogram.histogram_with_rowsums(zz, xx, v_z=v_z, v_x=v_x)
        wc, wr = ref.histogram_with_rowsums_ref(zz, xx, v_z=v_z, v_x=v_x)
        c1 = histogram.histogram(zz, xx, v_z=v_z, v_x=v_x)
        torch.cuda.synchronize()
        check(torch.equal(c, wc) and torch.equal(r, wr) and torch.equal(c1, wc),
              f"histogram disagrees with its plain version ({tag})")
        check(not bool(scratch.any()), f"histogram left the scratch nonzero ({tag})")
    # the library yardstick: one torch.bincount over the flattened kept ids
    keep = z >= 0
    flat = (z.long() * v_x + x.long())[keep]
    lib = torch.bincount(flat, minlength=v_z * v_x).view(v_z, v_x)
    check(torch.equal(lib.float(), histogram.histogram(z, x, v_z=v_z, v_x=v_x)),
          "the bincount yardstick disagrees with the histogram")
    counts_out, rows_out = torch.empty_like(counts), torch.empty_like(rows)
    ptrs = (z.data_ptr(), x.data_ptr(), counts.data_ptr(), rows.data_ptr(),
            counts_out.data_ptr(), rows_out.data_ptr(), scratch.data_ptr(), n, v_z, v_x)
    kern_ms, _ = timer(lambda: histogram.KERNEL.launch(*ptrs))
    flush_ms, _ = timer(lambda: histogram.KERNEL.launch(*ptrs[:7], 0, v_z, v_x))  # no samples
    ms, host = timer(lambda: histogram.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x))
    plain, _ = timer(lambda: histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x))
    library, _ = timer(lambda: torch.bincount(flat, minlength=v_z * v_x))
    # the whole ingest of the main path, Q = 1: one launch, nothing around it
    spec = mq.MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=1, k_cap=10)
    state = mq.admit_slot(mq.init_multi_state(spec, device=dev), 0,
                          t(rng.dirichlet(np.ones(v_x)).astype(np.float32)), 10, 0.12, 0.01)
    state = mq.stats_step(mq.ingest(state, z, x, spec=spec), spec=spec)
    ingest_ms, ingest_host = timer(lambda: mq.ingest(state, z, x, spec=spec))
    ingest_kernels = sorted(set(
        _device_kernels(torch, lambda: mq.ingest(state, z, x, spec=spec))))
    check(ingest_kernels and all("ingest_" in k for k in ingest_kernels),
          f"multiquery.ingest ran kernels besides kernel B: {ingest_kernels}")
    # ids read once, counts and n read once and written once
    bnd, by = bound_ms(8 * n + 2 * (v_z * v_x * 4 + v_z * 4), int(keep.sum()) + 2 * v_z * v_x)
    main["histogram"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=library, host_us=host * 1e3)
    emit({"check": "ingest_counts", "shape": [n, v_z, v_x], "kept": int(keep.sum()),
          "equal": True, "inputs_unchanged": True, "scratch_zero": True,
          **_check_fields(main["histogram"]), "kernel_only_ms": kern_ms, "flush_only_ms": flush_ms,
          "ingest_ms": ingest_ms, "ingest_host_us": ingest_host * 1e3,
          "ingest_kernels": ingest_kernels})

    # -- C: batched distance in its f32 and its uint16 form: the narrow
    # branch at the taxi shape; the wide branch at the minute-of-day path's
    # shape (phase 7), at 7548 x 1440 where the bytes bound dominates, at
    # 256 x 8192, at police_q1's shape under a forced sweeps = 2 (191 x 2) and past
    # its shared-memory threshold (3 x 524,288, the two-sweep fallback)
    from repro_torch.kernels import autotune, ops

    for (vz, vx, sweeps) in C_SHAPES:
        counts_np = rng.integers(0, 40, size=(vz, vx)).astype(np.float32)
        counts_np[rng.random(vz) < 0.2] = 0.0
        counts_np[0] = 0.0  # an empty row
        counts = t(counts_np)
        c16, fits = counts.to(torch.uint16), torch.amax(counts) <= 65535.0
        lowprec = autotune.TauPlan(sweeps=sweeps, lowprec=True)
        wide = metrics.wide_branch(vx, sweeps=sweeps)
        f32_name = "distance_wide" if wide else "distance_multi"
        for q in (1, 8):
            q_hat = t(np.stack([rng.dirichlet(np.ones(vx)) for _ in range(q)]).astype(np.float32))
            for metric in metrics.METRIC_NAMES:
                got = metrics.distance_multi(counts, q_hat, metric=metric, sweeps=sweeps)
                want = metrics.distance_multi_ref(counts, q_hat, metric=metric)
                got16 = metrics.distance_multi(c16, q_hat, metric=metric, sweeps=sweeps,
                                               gate=(counts, fits))
                want16 = metrics.distance_multi_ref(c16, q_hat, metric=metric)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                err16 = float((got16 - want16).abs().max())
                check(err <= TAU_ATOL and bool(torch.isfinite(got).all()),
                      f"distance_multi {metric} Q={q} {vz}x{vx}: max err {err}")
                check(err16 <= TAU_ATOL and torch.equal(got16, got),
                      f"distance_multi uint16 {metric} Q={q} {vz}x{vx}: max err {err16}, "
                      "not bitwise the f32 form")
                ms, host = timer(lambda: metrics.distance_multi(counts, q_hat, metric=metric,
                                                                sweeps=sweeps))
                plain, _ = timer(lambda: metrics.distance_multi_ref(counts, q_hat, metric=metric))
                ms16, host16 = timer(lambda: metrics.distance_multi(
                    c16, q_hat, metric=metric, sweeps=sweeps, gate=(counts, fits)))
                plain16, _ = timer(lambda: metrics.distance_multi_ref(c16, q_hat, metric=metric))
                # the whole gate: max, compare, cast and the uint16 launch
                gated_ms, gated_host = timer(lambda: autotune.run_tau(
                    counts, q_hat, plan=lowprec, metric=metric))
                per_elem = {"l1": 4, "chi2": 6, "hellinger": 7}[metric]
                n_ops = vz * vx * (1 + q * per_elem)
                bnd, by = bound_ms(vz * vx * 4 + q * vx * 4 + q * vz * 4, n_ops)
                bnd16, by16 = bound_ms(vz * vx * 2 + q * vx * 4 + q * vz * 4 + 1, n_ops)
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=None, host_us=host * 1e3)
                row16 = dict(max_abs_err=err16, ms=ms16, plain_ms=plain16, bound_ms=bnd16,
                             bound_by=by16, library_ms=None, host_us=host16 * 1e3)
                extra = {}
                if (q, metric) == (1, "l1") and (vz, vx) in ((7548, 24), (161, 1440)):
                    main[f32_name] = row
                    main[f32_name + "_u16"] = row16
                if (vz, vx, q, metric) == (7548, 24, 1, "l1"):
                    tau = torch.empty((q, vz), dtype=torch.float32, device=dev)
                    extra["kernel_only_ms"], _ = timer(lambda: metrics.KERNEL.launch(
                        counts.data_ptr(), q_hat.data_ptr(), tau.data_ptr(), vz, vx, q, 0))
                    # ~100 launches a call: 5 calls stay inside the launch queue, so the
                    # card runs them back to back; no closeness slot, as on the main path
                    extra["stats_step_ms"], host = timer(
                        lambda: mq.stats_step(state, spec=spec, closeness=False), reps=5)
                    extra["stats_step_host_us"] = host * 1e3
                if vx == 24 and metric == "l1":
                    # the launch the main path makes: the plan the scheduler resolves
                    # for this key from the committed plan file (phases 4 and 5)
                    resolved = autotune.resolve_plans(vz, vx, q, metric=metric, device=dev).tau
                    planned = ops.distance_multi(counts, q_hat, metric=metric, plan=resolved)
                    torch.cuda.synchronize()
                    check(float((planned - want).abs().max()) <= TAU_ATOL,
                          f"the resolved plan {resolved} disagrees at Q={q}")
                    extra["resolved_plan"] = dataclasses.asdict(resolved)
                    extra["resolved_ms"], _ = timer(lambda: ops.distance_multi(
                        counts, q_hat, metric=metric, plan=resolved))
                    row["plan"], row["plan_ms"] = extra["resolved_plan"], extra["resolved_ms"]
                    # the reference's one-broadcast form, plain PyTorch: timed, never run
                    # on the card's path
                    xla = metrics.distance_multi_xla(counts, q_hat)
                    extra["xla_max_abs_err"] = float((xla - want).abs().max())
                    check(extra["xla_max_abs_err"] <= TAU_ATOL, "the xla form disagrees")
                    extra["xla_ms"], _ = timer(lambda: metrics.distance_multi_xla(counts, q_hat))
                emit({"check": "distance_multi", "metric": metric, "q": q, "shape": [vz, vx],
                      "sweeps": sweeps, "branch": "wide" if wide else "narrow",
                      **_check_fields(row), "u16": _check_fields(row16),
                      "u16_bitwise_f32": True, "gated_ms": gated_ms,
                      "gated_host_us": gated_host * 1e3, **extra})
        # the gate's overflow case: one entry past the uint16 range, which the
        # cast wraps; every block must read the f32 counts instead
        over = counts.clone()
        over[min(3, vz - 1), min(5, vx - 1)] = 70_000.0
        over16, over_fits = over.to(torch.uint16), torch.amax(over) <= 65535.0
        q_hat = t(np.stack([rng.dirichlet(np.ones(vx)) for _ in range(8)]).astype(np.float32))
        for metric in metrics.METRIC_NAMES:
            for sweeps in (0, 2):
                want = metrics.distance_multi(over, q_hat, metric=metric, sweeps=sweeps)
                got = metrics.distance_multi(over16, q_hat, metric=metric, sweeps=sweeps,
                                             gate=(over, over_fits))
                planned = autotune.run_tau(over, q_hat, metric=metric,
                                           plan=autotune.TauPlan(sweeps=sweeps, lowprec=True))
                torch.cuda.synchronize()
                check(not bool(over_fits) and torch.equal(got, want) and torch.equal(planned, want),
                      f"the uint16 gate did not fall back exactly ({metric}, {vz}x{vx}, "
                      f"sweeps={sweeps})")
        del counts, c16, over, over16
        emit({"check": "distance_u16_gate", "shape": [vz, vx], "entry": 70_000.0,
              "fits": False, "bitwise_f32": True})
    return main


def _marking_table(torch, rows: int, words: int, seed: int) -> tuple:
    """A bitmap table made on the card from ``seed`` (half its rows miss
    the active mask), the active mask, and a read mask with ~5 % read."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(-2**31, 2**31, (rows, words), generator=gen, dtype=torch.int32,
                          device="cuda")
    mask = torch.randint(-2**31, 2**31, (words,), generator=gen, dtype=torch.int32,
                         device="cuda")
    table[torch.rand(rows, generator=gen, device="cuda") < 0.5] &= ~mask
    read_mask = torch.rand(rows, generator=gen, device="cuda") < 0.05
    return gen, table, mask, read_mask


def _permuted_window(torch, gen, table, mask, read_mask, length: int = 512) -> tuple:
    """A window of ``length`` permuted ids with ~10 % padding rows (id 0,
    not valid), ~5 % of its rows read already, and row 0 a block that
    holds only the last word's bit-31 candidate."""
    ids = torch.randperm(table.shape[0], generator=gen, device="cuda")[:length]
    valid = torch.rand(length, generator=gen, device="cuda") >= 0.1
    ids[~valid] = 0
    valid[0] = True
    read_mask[ids[0]] = False
    table[ids[0]] = 0
    table[ids[0], -1] = -2**31
    mask[-1] |= -2**31
    return ids, valid


def _phase_marking(torch, timer) -> dict:
    """Kernel A as the round runs it: the window's final marks from the
    whole resident bitmap table and the window's ids, in one launch.
    Checked against its plain version on a permuted window (padding,
    rows read already, a bit-31 row), in the gathered-window and scan
    forms, and at W = 237 (the word-by-word path); then timed against
    the parent's six-launch marking (gather, A, &, read-mask gather, ~,
    &), warm and with the table cold. Returns the main-path row."""
    from repro_torch.kernels import anyactive, ops, ref

    nb, W, L = 781_250, 236, 512  # the 400M-tuple TAXI table and window
    gen, table, mask, read_mask = _marking_table(torch, nb, W, 11)
    ids, valid = _permuted_window(torch, gen, table, mask, read_mask)
    kept = [a.clone() for a in (ids, valid, read_mask, mask)]
    want = ref.mark_blocks_ref(ids, valid, read_mask, table, mask, by_id=True)
    got = ops.mark_blocks(ids, valid, read_mask, table, mask, by_id=True)
    gathered = ops.mark_blocks(ids, valid, read_mask, table[ids], mask)
    scan = ops.mark_blocks(ids, valid, read_mask)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and bool(got[0]), "mark_blocks disagrees with its plain version")
    check(torch.equal(gathered, want), "mark_blocks on a gathered window disagrees")
    check(torch.equal(scan, ref.mark_blocks_ref(ids, valid, read_mask)),
          "mark_blocks' scan form disagrees with its plain version")
    check(all(torch.equal(a, b) for a, b in zip((ids, valid, read_mask, mask), kept)),
          "mark_blocks changed its inputs")
    emit({"check": "mark_blocks", "table": [nb, W], "window": L, "padding": int((~valid).sum()),
          "read_already": int((valid & read_mask[ids]).sum()), "marked": int(got.sum()),
          "equal": True, "gathered_equal": True, "scan_equal": True, "inputs_unchanged": True})
    # W = 237: rows off 16-byte boundaries take the word-by-word path
    g2, t2, m2, r2 = _marking_table(torch, 230_000, 237, 12)
    i2, v2 = _permuted_window(torch, g2, t2, m2, r2)
    w2 = ref.mark_blocks_ref(i2, v2, r2, t2, m2, by_id=True)
    check(torch.equal(ops.mark_blocks(i2, v2, r2, t2, m2, by_id=True), w2) and bool(w2[0]),
          "mark_blocks at W = 237 disagrees with its plain version")
    emit({"check": "mark_blocks", "table": [230_000, 237], "window": L, "equal": True})
    del g2, t2, m2, r2, i2, v2, w2

    def parent(i, v):  # the parent's round: gather, kernel A, then four elementwise ops
        return anyactive.anyactive(table[i], mask) & v & ~read_mask[i]

    def fused(i, v):
        return ops.mark_blocks(i, v, read_mask, table, mask, by_id=True)

    def plain(i, v):
        return ref.mark_blocks_ref(i, v, read_mask, table, mask, by_id=True)

    # device kernels of one call of each form
    counts = {name: _device_kernels(torch, lambda fn=fn: fn(ids, valid))
              for name, fn in (("six_launch", parent), ("fused", fused))}
    check(torch.equal(parent(ids, valid), want), "the six-launch marking disagrees")
    check(len(counts["fused"]) == 1 and "mark_kernel" in counts["fused"][0],
          f"the fused marking ran {counts['fused']}")

    # windows as the main path sends them: 512 consecutive unread block ids
    # (the visit order is cyclic over the block ids), all valid; a fresh
    # stretch of the 737 MB table for each call keeps its rows cold
    read_mask.zero_()
    starts = torch.randperm(nb // L, generator=gen, device="cuda")[:200].tolist()
    span = torch.arange(L, device="cuda")
    cold = [(s * L + span, torch.ones(L, dtype=torch.bool, device="cuda")) for s in starts]
    warm = [cold[0]]

    def cycling(fn, windows):
        it = itertools.cycle(windows)
        return lambda: fn(*next(it))

    # ids 8 B, valid 1 B and a read-mask byte a row; each needed row read
    # once; the mask; one byte out
    rows_needed = L
    bnd, by = bound_ms(10 * L + 4 * W * rows_needed + 4 * W + L, 2 * W * rows_needed)
    rows = {}
    for temp, windows in (("warm", warm), ("cold", cold)):
        plain_ms, _ = timer(cycling(plain, windows))
        for name, fn in (("six_launch", parent), ("fused", fused)):
            ms, host = timer(cycling(fn, windows))
            rows[(name, temp)] = dict(ms=ms, host_us=host * 1e3)
            emit({"check": "marking", "form": name, "table": temp, "shape": [nb, W, L],
                  "device_kernels": len(counts[name]), "kernel_ms": ms, "host_us": host * 1e3,
                  "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by})
        rows[("plain", temp)] = plain_ms
    return dict(max_abs_err=0.0, ms=rows[("fused", "cold")]["ms"],
                plain_ms=rows[("plain", "cold")], bound_ms=bnd, bound_by=by, library_ms=None,
                host_us=rows[("fused", "cold")]["host_us"])


def _window_ids(rng, v_z: int, v_x: int, *, blocks: int = 512, block: int = 512) -> tuple:
    """One lookahead window's (z, x) as `fused_round` hands them to ingest:
    z zipf 0.3 over the candidates (as data/synth.py draws them), x
    uniform, and every tuple of ~10 % of the blocks -1 (blocks left
    unmarked)."""
    import numpy as np

    freq = np.arange(1, v_z + 1, dtype=np.float64) ** -0.3
    z = rng.choice(v_z, size=(blocks, block), p=freq / freq.sum()).astype(np.int32)
    x = rng.integers(0, v_x, size=(blocks, block)).astype(np.int32)
    unmarked = rng.random(blocks) < 0.1
    z[unmarked] = -1
    x[unmarked] = -1
    return z.reshape(-1), x.reshape(-1)


def _fixture_dataset(num_tuples: int, seed: int):
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec, make_dataset

    spec = SynthSpec(v_z=80, v_x=16, num_tuples=num_tuples, k=8, n_close=8,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=seed)
    ds = make_dataset(spec)
    return ds, block_layout(ds.z, ds.x, v_z=80, v_x=16, block_size=512, seed=seed)


def phase_engine_small(torch) -> tuple:
    import numpy as np

    from repro_torch.core import engine, histsim

    ds, blocked = _fixture_dataset(3_000_000, 7)
    params = histsim.HistSimParams(v_z=80, v_x=16, k=8, eps=0.08, delta=0.05)
    cfg = engine.EngineConfig(variant="fastmatch", seed=3)
    a = engine.run_engine(blocked, ds.target, params, cfg, device="cuda")
    b = engine.run_engine(blocked, ds.target, params, cfg, device="cpu")
    check(np.array_equal(a.ids, b.ids), f"ids differ: card {a.ids} cpu {b.ids}")
    for f in ("blocks_read", "blocks_considered", "tuples_read", "rounds", "passes", "exact"):
        check(getattr(a, f) == getattr(b, f), f"{f} differs: {getattr(a, f)} vs {getattr(b, f)}")
    check(torch.equal(a.state.counts.cpu(), b.state.counts), "counts differ")
    err = float((a.state.tau.cpu() - b.state.tau).abs().max())
    check(err <= TAU_ATOL, f"tau differs by {err}")
    emit({"check": "engine_small", "ids": a.ids.tolist(), "blocks_read": a.blocks_read,
          "rounds": a.rounds, "exact": a.exact, "tau_max_abs_err": err, "equal": True})
    return ds, blocked


SERVE_FIELDS = ("rounds", "passes", "blocks_read", "blocks_considered", "tuples_read", "exact",
                "stopped", "stop_reason", "qtype")


def _serve_fixture(blocked, target, *, device, metric: str, kernel_plans=None) -> tuple:
    """Mixed serving on the fixture: three top-k queries (one stopped at
    20,000 tuples), then two closeness queries after the first retirement.
    Returns the results and the server."""
    import numpy as np

    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.data.synth import perturb_distribution
    from repro_torch.serve import MatchServer

    rng = np.random.default_rng(17)
    targets = [target] + [perturb_distribution(target, d, rng) for d in (0.05, 0.1)]
    eps_k, (eps_c, gap) = {"l1": (0.08, (0.1, 0.2)), "hellinger": (0.05, (0.01, 0.04))}[metric]
    srv = MatchServer(blocked, device=device, max_queries=4, lookahead=64, seed=3, metric=metric,
                      kernel_plans=kernel_plans)
    srv.submit(targets[0], k=8, eps=eps_k, delta=0.05)
    srv.submit(targets[1], k=8, eps=eps_k, delta=0.05, stop=StopPolicy(tuples=20_000))
    srv.submit(targets[2], k=4, eps=eps_k, delta=0.05)
    while not srv.results:
        srv.step()
    for t in targets[:2]:
        srv.submit_closeness(t, eps=eps_c, gap=gap, delta=0.05)
    return srv.run_until_idle(), srv


def phase_serving_small(torch, ds, blocked) -> dict:
    """Card against CPU for l1 and hellinger, then l1 on the card under a
    pinned plan that forces kernel C's wide branch in its uint16 form and
    the unfused ingest: the same answers and counters as the default
    plans. Returns that run's launches."""
    import numpy as np

    from repro_torch.kernels import autotune, ops

    default_card = None
    for metric in ("l1", "hellinger"):
        card, srv = _serve_fixture(blocked, ds.target, device="cuda", metric=metric)
        cpu, _ = _serve_fixture(blocked, ds.target, device="cpu", metric=metric)
        check(srv.kernel_plans == autotune.PlanPair(),
              f"the fixture's shape resolved plans {srv.kernel_plans}")
        if metric == "l1":
            default_card = card
        check(sorted(card) == sorted(cpu) == list(range(5)),
              f"served {sorted(card)} on the card, {sorted(cpu)} on the CPU")
        for rid, b in cpu.items():
            a = card[rid]
            check(np.array_equal(a.ids, b.ids), f"{metric} request {rid}: ids {a.ids} vs {b.ids}")
            for f in SERVE_FIELDS:
                check(getattr(a, f) == getattr(b, f),
                      f"{metric} request {rid}: {f} {getattr(a, f)} vs {getattr(b, f)}")
        check(cpu[1].stopped and cpu[1].stop_reason == "tuples", "the fixture's stop did not fire")
        emit({"check": "serving_small", "metric": metric, "equal": True,
              "results": {rid: dict(qtype=r.qtype, ids=len(r.ids), rounds=r.rounds,
                                    tuples=r.tuples_read, exact=r.exact, stopped=r.stopped)
                          for rid, r in sorted(cpu.items())}})

    # -- the wide uint16 branch's path: counts at 0 just before, read just after
    pinned = autotune.PlanPair(autotune.TauPlan(sweeps=2, lowprec=True),
                               autotune.IngestPlan(fused=False))
    for kern in ops.KERNELS.values():
        kern.launches = 0
    got, srv = _serve_fixture(blocked, ds.target, device="cuda", metric="l1", kernel_plans=pinned)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    rounds = srv.scheduler.rounds
    check(srv.kernel_plans == pinned, f"the server runs {srv.kernel_plans}, not {pinned}")
    check(sorted(got) == sorted(default_card), "the pinned plans served other requests")
    for rid, b in default_card.items():
        a = got[rid]
        check(np.array_equal(a.ids, b.ids), f"pinned plans, request {rid}: ids {a.ids} vs {b.ids}")
        for f in SERVE_FIELDS:
            check(getattr(a, f) == getattr(b, f),
                  f"pinned plans, request {rid}: {f} {getattr(a, f)} vs {getattr(b, f)}")
    check(launches["distance_wide_u16"] > 0 and launches["histogram"] == rounds
          and launches["anyactive"] == rounds,
          f"the pinned plans launched {launches} in {rounds} rounds")
    check(all(launches[k] == 0 for k in ("distance_multi", "distance_multi_u16", "distance_wide")),
          f"the pinned plans launched another form of kernel C: {launches}")
    emit({"check": "serving_small_pinned_plans", "plans": dataclasses.asdict(pinned),
          "rounds": rounds, "launches": launches, "equal_to_default_plans": True})
    return launches


def _profile_tables(torch, prof) -> tuple:
    """(total device ms, device rows, host rows) of a profile; a row is
    (name, ms, calls), largest first. Device rows are the kernels and
    copies on the card; host rows are the PyTorch ops by self CPU time
    (inflated by the profiler itself, so read them for their order)."""
    device, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                device.append((e.key, us / 1e3, e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return sum(r[1] for r in device), device, host


def taxi_spec(num_tuples: int):
    """Phase 4's table: the reference's taxi_q1 shape scaled up."""
    from repro_torch.data.synth import SynthSpec

    return SynthSpec(v_z=7548, v_x=24, num_tuples=num_tuples, k=10, n_close=10,
                     close_distance=0.05, far_distance=0.45, zipf_a=0.3, close_rank="head",
                     seed=44)


def minute_spec(num_tuples: int):
    """Phase 7's table: FLIGHTS' scheduled departure at minute resolution
    (V_X = 1440) over its 161 origin airports."""
    from repro_torch.data.synth import SynthSpec

    return SynthSpec(v_z=161, v_x=1440, num_tuples=num_tuples, k=10, n_close=10,
                     close_distance=0.05, far_distance=0.45, zipf_a=0.3, close_rank="head",
                     seed=47)


def phase_engine_scale(torch, spec, seed: int, *, check_name: str, expect=None) -> tuple:
    """FastMatch and Scan on ``spec``'s table resident on the card (see the
    module docstring, phases 4 and 7); ``expect`` is FastMatch's (rounds,
    blocks) where they are known. Returns the report and what phase 5
    serves from."""
    import numpy as np

    from repro_torch.core import engine, histsim
    from repro_torch.core.bitmap import words_for
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import make_dataset
    from repro_torch.io import InMemorySource
    from repro_torch.kernels import autotune, metrics, ops

    k, eps, delta = 10, 0.12, 0.01
    num_tuples = spec.num_tuples
    t = time.perf_counter()
    ds = make_dataset(spec)
    gen_s = time.perf_counter() - t
    log(f"generated {num_tuples} tuples in {gen_s:.1f}s")
    t = time.perf_counter()
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=spec.seed)
    layout_s = time.perf_counter() - t
    target, true_dists = ds.target, ds.true_dists
    del ds
    log(f"laid out {blocked.num_blocks} blocks in {layout_s:.1f}s")
    nb = blocked.num_blocks
    resident_gb = (blocked.z_blocks.nbytes + blocked.x_blocks.nbytes + blocked.bitmap.nbytes) / 1e9
    t = time.perf_counter()
    source = InMemorySource(blocked, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    log(f"moved {resident_gb:.2f} GB to the card in {upload_s:.1f}s")

    params = histsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=k, eps=eps, delta=delta)
    cfg = engine.EngineConfig(variant="fastmatch", seed=seed, lookahead=512)
    # what the engine's scheduler resolves from the committed plan file
    plans = autotune.resolve_plans(spec.v_z, spec.v_x, 1, metric="l1", device="cuda")
    c_launches = autotune.tau_launches(plans.tau, spec.v_x, 1)
    if spec.v_x > metrics.NARROW_MAX_VX:
        check(c_launches == {"distance_wide": 1},
              f"{plans.tau} does not take kernel C's wide f32 form once a stats step")
    log(f"resolved plans: {plans}")

    def check_c(launches: dict, expect: dict, run: str) -> None:
        for name in ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16"):
            if name in expect:
                check(launches[name] > 0 and launches[name] % expect[name] == 0,
                      f"{run}: {launches[name]} {name} launches, not a positive multiple of "
                      f"{expect[name]}")
            else:
                check(launches[name] == 0, f"{run}: kernel C's {name} form ran under {plans}")

    # -- the main path: every launch count at 0 just before, read just after
    for kern in ops.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fm = engine.run_engine(source, target, params, cfg)
    torch.cuda.synchronize()
    fm_wall = time.perf_counter() - t
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"fastmatch: {fm.rounds} rounds, {fm.blocks_read}/{nb} blocks, {fm_wall:.3f}s, "
        f"{fm.host_syncs} host syncs, launches {launches}")
    for name in ("histogram", "anyactive"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    check_c(launches, c_launches, "fastmatch")
    for name in ("histogram", "anyactive"):
        check(launches[name] == fm.rounds,
              f"{launches[name]} {name} launches for {fm.rounds} fastmatch rounds")
    if expect is not None:
        check((fm.rounds, fm.blocks_read) == expect,
              f"fastmatch took {fm.rounds} rounds and read {fm.blocks_read} blocks, not {expect}")

    for kern in ops.KERNELS.values():
        kern.launches = 0
    t = time.perf_counter()
    scan = engine.run_engine(source, target, params, engine.EngineConfig(variant="scan"))
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t
    scan_launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    log(f"scan: {scan.rounds} rounds, {scan.blocks_read} blocks, {scan_wall:.3f}s, "
        f"launches {scan_launches}")
    for name in ("histogram", "anyactive"):
        check(scan_launches[name] == scan.rounds,
              f"{scan_launches[name]} {name} launches for {scan.rounds} scan rounds")
    check_c(scan_launches, c_launches, "scan")

    truth = scan.state.tau.cpu().numpy()
    check(bool(np.isfinite(truth).all()) and truth.shape == (spec.v_z,), "scan tau malformed")
    scan_err = float(np.abs(truth.astype(np.float64) - true_dists).max())
    check(scan.exact and scan.blocks_read == nb, "scan did not read every block")
    check(scan_err <= TAU_ATOL, f"scan tau differs from the generator's by {scan_err}")
    check(not fm.exact, "fastmatch fell back to an exact read")
    check(fm.blocks_read < 0.5 * nb, f"fastmatch read {fm.blocks_read} of {nb} blocks")
    check(fm.delta_upper < delta, f"fastmatch delta_upper {fm.delta_upper} >= {delta}")
    true_top = set(np.argsort(truth, kind="stable")[:k].tolist())
    worst = max(float(truth[i]) for i in fm.ids)
    missing = sorted(true_top - set(fm.ids.tolist()))
    for j in missing:
        check(worst - float(truth[j]) < eps, f"Guarantee 1 broken by candidate {j}")

    # -- the same two queries under a pinned lowprec plan (kernel C's uint16
    # form behind the gate), through a plan file as a deployment would pin it
    pinned = autotune.PlanPair(autotune.TauPlan(lowprec=True), plans.ingest)
    reg = autotune.PlanRegistry(backend="cuda")
    reg.tau[autotune.tau_key(spec.v_z, spec.v_x, 1)] = pinned.tau
    reg.ingest[autotune.ingest_key(spec.v_z, spec.v_x)] = pinned.ingest
    autotune.reload(path=reg.save(ROOT / "build" / "smoke_plans" / "cuda.json"), backend="cuda")
    try:
        check(autotune.resolve_plans(spec.v_z, spec.v_x, 1, device="cuda") == pinned,
              "the pinned plan file did not resolve")
        lowprec = {}
        for run, variant_cfg, base in (("fastmatch", cfg, fm),
                                       ("scan", engine.EngineConfig(variant="scan"), scan)):
            for kern in ops.KERNELS.values():
                kern.launches = 0
            t = time.perf_counter()
            res = engine.run_engine(source, target, params, variant_cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            runs = {n: kern.launches for n, kern in ops.KERNELS.items()}
            check(np.array_equal(res.ids, base.ids) and res.rounds == base.rounds
                  and res.blocks_read == base.blocks_read,
                  f"{run} under a lowprec plan: ids {res.ids}, {res.rounds} rounds, "
                  f"{res.blocks_read} blocks, not the default plan's")
            check(torch.equal(res.state.tau, base.state.tau),
                  f"{run} under a lowprec plan: tau is not bitwise the default plan's")
            check_c(runs, autotune.tau_launches(pinned.tau, spec.v_x, 1),
                    f"{run} under a lowprec plan")
            max_count = float(res.state.counts.max())
            lowprec[run] = dict(rounds=res.rounds, blocks_read=res.blocks_read, wall_s=wall,
                                launches=runs, max_count=max_count,
                                gate_tripped=max_count > 65535.0, tau_bitwise_default=True)
            if run == "scan":
                lp_err = float(np.abs(res.state.tau.cpu().numpy().astype(np.float64)
                                      - true_dists).max())
                check(lp_err <= TAU_ATOL, f"scan under a lowprec plan: tau off by {lp_err}")
                lowprec[run]["tau_max_abs_err_vs_generator"] = lp_err
            log(f"{run} under {pinned.tau}: {res.rounds} rounds, {res.blocks_read} blocks, "
                f"{wall:.3f}s, max count {max_count:.0f} (gate tripped: "
                f"{lowprec[run]['gate_tripped']}), launches {runs}")
    finally:
        autotune.reload(backend="cuda")

    # -- where the device time goes: the same query under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        again = engine.run_engine(source, target, params, cfg)
        torch.cuda.synchronize()
    check(np.array_equal(again.ids, fm.ids) and again.rounds == fm.rounds,
          "a repeated fastmatch run differs")
    # the rounds read bitmap rows in place: no gather takes the bitmap table
    table_shape = [nb, words_for(spec.v_z)]
    gathers = [e for e in prof.events()
               if e.name in ("aten::index", "aten::index_select") and e.input_shapes]
    check(not [e for e in gathers if list(e.input_shapes[0]) == table_shape],
          "a profiled round gathered rows of the bitmap table")
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    busy = device_ms / (fm_wall * 1e3) if device_ms > 0 else None
    # what one round costs in launches: runtime launch calls on the host,
    # kernels (not copies or memsets) on the card
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))
    log(f"profiled fastmatch: device time {device_ms:.3f} ms of {fm_wall * 1e3:.1f} ms wall")

    out = dict(
        shape=[spec.v_z, spec.v_x], tuples=num_tuples, blocks=nb, resident_gb=resident_gb,
        generate_s=gen_s,
        layout_s=layout_s, upload_s=upload_s,
        fastmatch=dict(ids=fm.ids.tolist(), rounds=fm.rounds, passes=fm.passes,
                       blocks_read=fm.blocks_read, blocks_share=fm.blocks_read / nb,
                       tuples_read=fm.tuples_read, wall_s=fm_wall, host_syncs=fm.host_syncs,
                       delta_upper=fm.delta_upper, exact=fm.exact,
                       ms_per_round=fm_wall * 1e3 / max(fm.rounds, 1),
                       peak_device_gb=peak_gb, missing_true_top_k=missing),
        scan=dict(rounds=scan.rounds, blocks_read=scan.blocks_read, wall_s=scan_wall,
                  tau_max_abs_err_vs_generator=scan_err),
        launches=launches, scan_launches=scan_launches,
        plans=dataclasses.asdict(plans), lowprec=lowprec,
        profile=dict(device_ms=device_ms, device_busy_share=busy,
                     host_launches_per_round=host_launches / again.rounds,
                     device_kernels_per_round=device_kernels / again.rounds,
                     index_ops_per_round=len(gathers) / again.rounds,
                     top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel[:15]],
                     host_top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_host_op[:15]]),
    )
    emit({"check": check_name, **{k2: v for k2, v in out.items() if k2 != "profile"}})
    emit({"check": f"{check_name}_profile", **out["profile"]})
    # what phases 5 and 8 serve from: the resident table, the exact counts,
    # and the host arrays (phase 8's host-resident source)
    ctx = dict(source=source, target=target, counts=scan.state.counts, params=params, cfg=cfg,
               solo_target=fm, blocked=blocked, fastmatch=fm)
    return out, ctx


class _StatsProbe:
    """Counts `multiquery.stats_step` calls and records the Q of every
    `ops.distance_multi` call while installed (phase 5's launch checks);
    the kernels' own launch counts are untouched."""

    def __init__(self):
        from repro_torch.core import multiquery as mq
        from repro_torch.kernels import ops

        self.mq, self.ops = mq, ops
        self.stats_steps, self.qs = 0, []
        self._stats_step, self._distance = mq.stats_step, ops.distance_multi

    def __enter__(self):
        def stats_step(*a, **kw):
            self.stats_steps += 1
            return self._stats_step(*a, **kw)

        def distance_multi(counts, q_hat, **kw):
            self.qs.append(int(q_hat.shape[0]))
            return self._distance(counts, q_hat, **kw)

        self.mq.stats_step, self.ops.distance_multi = stats_step, distance_multi
        return self

    def __exit__(self, *exc):
        self.mq.stats_step, self.ops.distance_multi = self._stats_step, self._distance


def _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples: int,
                telemetry=None, server=None, **server_kw) -> dict:
    """Phase 5's workload on one fresh server: 8 top-k queries (the first
    with a tuples stop), served step by step until the first retirement,
    then 4 closeness queries, the first followed through `iter_results`,
    then the rest drained. Returns the server, request ids and stream.
    A ``server`` built beforehand is served as it is (its construction
    outside the wall)."""
    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.serve import MatchServer

    k, eps, delta, eps_c, gap = 10, 0.12, 0.01, 0.10, 0.20
    t = time.perf_counter()
    if server is None:
        server = MatchServer(source, max_queries=8, lookahead=512, metric="l1",
                             telemetry=telemetry, **server_kw)
    topk = [server.submit(tg, k=k, eps=eps, delta=delta,
                          stop=StopPolicy(tuples=stop_tuples) if i == 0 else None)
            for i, tg in enumerate(topk_targets)]
    while not server.results:
        server.step()
    close = [server.submit_closeness(tg, eps=eps_c, gap=gap, delta=delta) for tg in close_targets]
    stream = list(server.iter_results(close[0]))
    server.run_until_idle()
    torch.cuda.synchronize()
    return dict(server=server, topk=topk, close=close, stream=stream,
                wall_s=time.perf_counter() - t)


def phase_serving(torch, timer, ctx: dict) -> dict:
    """Serving at full width on phase 4's resident table (see the module
    docstring, phase 5)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core import multiquery as mq
    from repro_torch.data.synth import perturb_distribution
    from repro_torch.kernels import autotune, metrics, ops

    source, target, params, cfg = ctx["source"], ctx["target"], ctx["params"], ctx["cfg"]
    k, eps, eps_c, gap = 10, 0.12, 0.10, 0.20
    rng = np.random.default_rng(4321)
    topk_targets = [target] + [perturb_distribution(target, d, rng)
                               for d in np.linspace(0.05, 0.3, 7)]
    close_targets = [target] + [perturb_distribution(target, d, rng) for d in (0.05, 0.1, 0.2)]

    # one solo run_engine per top-k target: the I/O the server amortizes
    solo = [ctx["solo_target"]] + [engine.run_engine(source, tg, params, cfg)
                                   for tg in topk_targets[1:]]
    stop_tuples = solo[0].tuples_read // 2
    log(f"solo tuples: {[r.tuples_read for r in solo]}; stop at {stop_tuples}")

    # -- the serving path: counts at 0 just before, read just after
    for kern in ops.KERNELS.values():
        kern.launches = 0
    with _StatsProbe() as probe:
        run = _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples)
    # phases 8 and 9 serve the same workload through faulty sources and
    # with telemetry on
    ctx["workload"] = (topk_targets, close_targets, stop_tuples)
    ctx["served"] = {rid: run["server"].results[rid] for rid in run["topk"] + run["close"]}
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    server, sched = run["server"], run["server"].scheduler
    ctx["phase5"] = dict(host_syncs=sched.host_syncs, loop_syncs=sched.loop_syncs,
                         rounds=sched.rounds, launches=launches, wall_s=run["wall_s"],
                         cache=[leaf.clone() for leaf in sched.export_cache()])
    results = dict(server.results)
    log(f"serving: {sched.rounds} rounds, {sched.host_syncs} host syncs, "
        f"{run['wall_s']:.3f}s, launches {launches}, stats steps {probe.stats_steps}")
    for name in ("anyactive", "histogram"):
        check(launches[name] == sched.rounds,
              f"{launches[name]} {name} launches for {sched.rounds} serving rounds")
    # kernel C as the plans the server resolved say: each stats step one
    # launch at Q = 8, or 8 at Q = 1 under an unrolled plan
    plans = server.kernel_plans
    log(f"serving plans: {plans}")
    c_launches = autotune.tau_launches(plans.tau, source.v_x, 8)
    check(probe.stats_steps == len(probe.qs), "a stats step ran kernel C twice")
    for name in ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16"):
        want = c_launches.get(name, 0) * probe.stats_steps
        check(launches[name] == want,
              f"{launches[name]} {name} launches for {probe.stats_steps} stats steps under {plans}")
    check(set(probe.qs) == {8}, f"kernel C ran at Q = {sorted(set(probe.qs))}, not 8")

    # -- every answer against the exact tau of its target
    q_hats = np.stack([tg / tg.sum() for tg in topk_targets + close_targets]).astype(np.float32)
    truth = metrics.distance_multi_ref(
        ctx["counts"], torch.from_numpy(q_hats).to(ctx["counts"].device)
    ).cpu().numpy().astype(np.float64)
    check(bool(np.isfinite(truth).all()) and truth.shape == (12, source.v_z), "truth malformed")
    answers = []
    for i, rid in enumerate(run["topk"]):
        res, d = results[rid], truth[i]
        check(res.qtype == "topk" and len(res.ids) == k, f"top-k request {rid} malformed")
        true_top = set(np.argsort(d, kind="stable")[:k].tolist())
        worst = max(float(d[j]) for j in res.ids)
        correct = all(worst - float(d[j]) < eps for j in true_top - set(res.ids.tolist()))
        if i == 0:
            check(res.stopped and res.stop_reason == "tuples" and not res.exact,
                  f"the stopped query reports stopped={res.stopped} {res.stop_reason!r}")
            last = server.poll_result(rid)
            check(last.status == "done" and last.stopped and np.array_equal(last.ids, res.ids),
                  "the stopped answer is not its last poll")
        else:
            check(not res.stopped and correct, f"top-k request {rid} is not (eps, k)-correct")
        answers.append(dict(rid=rid, qtype="topk", correct=correct, rounds=res.rounds,
                            tuples=res.tuples_read, exact=res.exact, stopped=res.stopped,
                            delta_upper=res.delta_upper, wall_ms=res.wall_time_s * 1e3))
    for i, rid in enumerate(run["close"]):
        res, d = results[rid], truth[8 + i]
        got = set(res.ids.tolist())
        check(res.qtype == "closeness" and not res.stopped, f"closeness request {rid} malformed")
        check(set(np.flatnonzero(d <= eps_c).tolist()) <= got,
              f"closeness request {rid} missed a candidate within eps")
        check(got.isdisjoint(np.flatnonzero(d >= eps_c + gap).tolist()),
              f"closeness request {rid} labeled a far candidate close")
        answers.append(dict(rid=rid, qtype="closeness", close=len(got), rounds=res.rounds,
                            tuples=res.tuples_read, exact=res.exact,
                            delta_upper=res.delta_upper, wall_ms=res.wall_time_s * 1e3))
    stream = run["stream"]
    final = stream[-1]
    check(final.status == "done" and all(a.status != "done" for a in stream[:-1]),
          "the iter_results stream does not end at its one done answer")
    blocking = results[run["close"][0]]
    check(final.result is blocking and np.array_equal(final.ids, blocking.ids)
          and final.delta_upper == blocking.delta_upper,
          "the iter_results stream does not end with the blocking answer")
    shared = sched.tuples_read
    solo_total = sum(r.tuples_read for r in solo)

    # a warm re-submission of the first target, after everything retired
    rid = server.submit(topk_targets[0], k=k, eps=eps, delta=0.01)
    warm = server.run_until_idle()[rid]
    check(warm.delta_upper < 0.01 or warm.exact, "the warm re-submission did not resolve")

    # -- kernel C and the statistics step at Q = 8, on the path's last state
    state, spec = sched.state, sched.spec
    c_ms, c_host = timer(lambda: metrics.distance_multi(state.counts, state.q_hat))
    c_plain, _ = timer(lambda: metrics.distance_multi_ref(state.counts, state.q_hat))
    # the tau step as the resolved plan runs it (the gate included under lowprec)
    c_plan_ms, c_plan_host = timer(lambda: ops.distance_multi(state.counts, state.q_hat,
                                                              plan=plans.tau))
    stats_ms, stats_host = timer(lambda: mq.stats_step(state, spec=spec), reps=5)
    topk_stats_ms, _ = timer(lambda: mq.stats_step(state, spec=spec, closeness=False), reps=5)

    # -- where the time goes: the same workload on a fresh server, profiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples)
    again_sched = again["server"].scheduler
    check(again_sched.rounds == sched.rounds and again_sched.tuples_read == shared,
          "a repeated serving run differs")
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))

    out = dict(
        rounds=sched.rounds, passes=sched.passes, host_syncs=sched.host_syncs,
        wall_s=run["wall_s"], wall_ms_per_query=run["wall_s"] * 1e3 / 12,
        shared_tuples=shared, solo_tuples=[r.tuples_read for r in solo],
        solo_tuples_total=solo_total, solo_walls_s=[r.wall_time_s for r in solo],
        stop_tuples=stop_tuples, warm_resubmit_tuples=warm.tuples_read,
        warm_resubmit_rounds=warm.rounds, answers=answers, stream_len=len(stream),
        launches=launches, stats_steps=probe.stats_steps,
        plans=dataclasses.asdict(plans),
        kernel_c_q8=dict(ms=c_ms, host_us=c_host * 1e3, plain_ms=c_plain, planned_ms=c_plan_ms,
                         planned_host_us=c_plan_host * 1e3),
        stats_step_q8=dict(ms=stats_ms, host_us=stats_host * 1e3, topk_only_ms=topk_stats_ms),
        profile=dict(wall_s=again["wall_s"], device_ms=device_ms,
                     device_busy_share=device_ms / (again["wall_s"] * 1e3),
                     device_kernels_per_round=device_kernels / again_sched.rounds,
                     host_launches_per_round=host_launches / again_sched.rounds,
                     top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel[:15]]),
    )
    ctx["phase5"]["host_launches_per_round"] = out["profile"]["host_launches_per_round"]
    emit({"check": "serving", **{k2: v for k2, v in out.items() if k2 != "profile"}})
    emit({"check": "serving_profile", **out["profile"]})
    return out


# ---------------------------------------------------------------------------
# phase 8: the I/O, fault and recovery layer on phase 4's resident table
# ---------------------------------------------------------------------------

C_FORMS = ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16")


def _reset_launches() -> None:
    from repro_torch.kernels import ops

    for kern in ops.KERNELS.values():
        kern.launches = 0


def _launch_counts() -> dict:
    from repro_torch.kernels import ops

    return {name: kern.launches for name, kern in ops.KERNELS.items()}


def _check_per_round(launches: dict, rounds: int, stats_steps: int, what: str) -> None:
    """Kernels A and B launched at least once a round, kernel C at least
    once a statistics step (every sampling round runs one; an exact
    completion's ingest rounds run none, and it runs one at its end)."""
    c = sum(launches[name] for name in C_FORMS)
    for name, n, per in (("anyactive", launches["anyactive"], rounds),
                         ("histogram", launches["histogram"], rounds),
                         ("kernel C", c, stats_steps)):
        check(per > 0 and n >= per, f"{what}: {n} {name} launches for {rounds} rounds, "
                                    f"{stats_steps} statistics steps")


def _meets_guarantee1(ids, truth, eps: float, k: int) -> bool:
    """Every true top-k candidate left out is within ``eps`` of the worst
    one returned (Guarantee 1)."""
    import numpy as np

    true_top = set(np.argsort(truth, kind="stable")[:k].tolist())
    worst = max(float(truth[j]) for j in ids)
    return all(worst - float(truth[j]) < eps for j in true_top - set(ids.tolist()))


def _workload_truth(torch, ctx) -> tuple:
    """Phase 5's targets, their queries' eps by request id, and every
    target's exact tau (kernel C's plain version over Scan's counts)."""
    import numpy as np

    from repro_torch.kernels import metrics

    topk, close, _ = ctx["workload"]
    q_hats = np.stack([tg / tg.sum() for tg in topk + close]).astype(np.float32)
    truth = metrics.distance_multi_ref(
        ctx["counts"], torch.from_numpy(q_hats).to(ctx["counts"].device)
    ).cpu().numpy().astype(np.float64)
    eps = {rid: (0.12 if rid < len(topk) else 0.10) for rid in range(len(topk) + len(close))}
    return truth, eps


def _phase8_chaos(torch, ctx) -> dict:
    """8a: phase 5's workload through `maybe_chaos`: bitwise phase 5."""
    import numpy as np

    from repro_torch.io import maybe_chaos

    topk, close, stop_tuples = ctx["workload"]
    base = ctx["served"]
    _, eps = _workload_truth(torch, ctx)
    chaos = maybe_chaos(ctx["source"], env={"FASTMATCH_CHAOS": "1", "FASTMATCH_CHAOS_SEED": "0"})
    _reset_launches()
    with _StatsProbe() as probe:
        run = _serve_taxi(torch, chaos, topk, close, stop_tuples)
    launches = _launch_counts()
    server, sched = run["server"], run["server"].scheduler
    _check_per_round(launches, sched.rounds, probe.stats_steps, "8a")
    check(run["topk"] + run["close"] == list(base), "8a served other requests than phase 5")
    for rid, want in base.items():
        got = server.results[rid]
        check(np.array_equal(got.ids, want.ids), f"8a request {rid}: ids differ from phase 5")
        for f in ("rounds", "tuples_read", "exact", "stopped"):
            check(getattr(got, f) == getattr(want, f),
                  f"8a request {rid}: {f} {getattr(got, f)} vs phase 5's {getattr(want, f)}")
        check(torch.equal(got.state.tau, want.state.tau),
              f"8a request {rid}: tau is not bitwise phase 5's")
        check(not got.degraded and got.eps_effective == eps[rid],
              f"8a request {rid}: degraded={got.degraded}, eps_effective {got.eps_effective}")
    check(chaos.retries_total > 0, "8a: the chaos source retried nothing")
    out = dict(wall_s=run["wall_s"], rounds=sched.rounds, retries=chaos.retries_total,
               injected=chaos.inner.injector.injected, attempts=chaos.inner.injector.attempts,
               launches=launches, bitwise_phase5=True)
    log(f"8a chaos: {out}")
    return out


class _RetireProbe:
    """Records, at every retirement while installed, the quarantine the
    scheduler then knew and what the outcome reports (8b's check)."""

    def __init__(self):
        from repro_torch.core.multiquery import SharedCountsScheduler

        self.cls, self._retire, self.rows = SharedCountsScheduler, SharedCountsScheduler.retire, []

    def __enter__(self):
        probe = self

        def retire(sched, slot, **kw):
            eps = sched.tickets[slot].eps
            bq, tq = sched.blocks_quarantined, sched.tuples_quarantined
            out = probe._retire(sched, slot, **kw)
            want = eps + (2.0 * (tq / sched.total_tuples) if bq else 0.0)
            probe.rows.append(dict(eps=eps, blocks_quarantined=bq, tuples_quarantined=tq,
                                   degraded=out.degraded, eps_effective=out.eps_effective,
                                   expected=want))
            return out

        self.cls.retire = retire
        return self

    def __exit__(self, *exc):
        self.cls.retire = self._retire


def _phase8_quarantine(torch, ctx, expect_quarantine) -> dict:
    """8b: corruption quarantines and degrades honestly; nothing
    quarantined reaches ingest; telemetry counts it."""
    import numpy as np

    from repro_torch.io import FaultPlan, FaultySource, ResilientSource
    from repro_torch.obs import Telemetry

    topk, close, stop_tuples = ctx["workload"]
    truth, eps = _workload_truth(torch, ctx)
    source = ctx["source"]
    tel = Telemetry(device=source.device)
    res_src = ResilientSource(FaultySource(source, FaultPlan(p_corrupt=0.02, p_truncate=0.02),
                                           seed=5), telemetry=tel)
    _reset_launches()
    with _RetireProbe() as probe, _StatsProbe() as stats:
        run = _serve_taxi(torch, res_src, topk, close, stop_tuples, telemetry=tel)
    launches = _launch_counts()
    server, sched = run["server"], run["server"].scheduler
    _check_per_round(launches, sched.rounds, stats.stats_steps, "8b")
    # telemetry: the scheduler's and the source's quarantine counts
    reg = tel.registry
    events = tel.tracer.events("window_quarantine")
    quarantine_telemetry = dict(
        blocks_quarantined_total=reg.get("fastmatch_blocks_quarantined_total").value,
        io_blocks_quarantined_total=reg.get("io_blocks_quarantined_total").value,
        window_quarantine_events=len(events),
        blocks_quarantine_events=len(tel.tracer.events("blocks_quarantine")),
        io_validation_failures_total=reg.get("io_validation_failures_total").value)
    check(quarantine_telemetry["blocks_quarantined_total"] == sched.blocks_quarantined
          and quarantine_telemetry["io_blocks_quarantined_total"] == res_src.blocks_quarantined
          and len(events) == res_src.windows_quarantined
          and sum(e["blocks"] for e in events) == res_src.blocks_quarantined,
          f"8b: telemetry counted {quarantine_telemetry}, the sources "
          f"{sched.blocks_quarantined} / {res_src.windows_quarantined} windows")
    if expect_quarantine is not None:
        check((quarantine_telemetry["blocks_quarantined_total"], len(events))
              == expect_quarantine, f"8b: telemetry {quarantine_telemetry}, not {expect_quarantine}")
    q = sched.tuples_quarantined / sched.total_tuples
    check(sched.blocks_quarantined > 0 and res_src.validation_failures > 0,
          f"8b quarantined {sched.blocks_quarantined} blocks")
    check(probe.rows and all(r["degraded"] == (r["blocks_quarantined"] > 0)
                             and r["eps_effective"] == r["expected"] for r in probe.rows),
          f"8b: an outcome's eps_effective is not eps + 2q at its retirement: {probe.rows}")
    check(any(r["degraded"] for r in probe.rows), "8b: no outcome saw the quarantine")
    # no quarantined tuple reached ingest: the counts are exactly the
    # histogram of the blocks the read mask marks (torch.bincount: the
    # check's oracle)
    v_z, v_x = source.v_z, source.v_x
    read = torch.nonzero(sched.cursor.read_mask).squeeze(1)
    z, x = source._z[read].reshape(-1), source._x[read].reshape(-1)
    keep = z >= 0
    hist = torch.bincount(z[keep].long() * v_x + x[keep].long(), minlength=v_z * v_x)
    hist = hist.to(torch.float32).reshape(v_z, v_x)
    check(torch.equal(hist, sched.state.counts),
          "8b: the counts are not the read blocks' histogram")
    check(torch.equal(hist.sum(dim=1), sched.state.n), "8b: n is not the read blocks' row sums")
    check(not (sched.read_mask & sched.quarantined).any(), "8b: a quarantined block was read")
    answers = []
    for i, rid in enumerate(run["topk"] + run["close"]):
        res = server.results[rid]
        d, e = truth[i], res.eps_effective
        if rid in run["topk"]:
            ok = _meets_guarantee1(res.ids, d, e, 10)
            check(ok or res.stopped, f"8b top-k request {rid} misses Guarantee 1 at {e}")
        else:
            infl = e - eps[rid]
            got = set(res.ids.tolist())
            ok = (set(np.flatnonzero(d <= eps[rid] - infl).tolist()) <= got
                  and got.isdisjoint(np.flatnonzero(d >= eps[rid] + 0.20 + infl).tolist()))
            check(ok, f"8b closeness request {rid} is wrong outside its widened gap")
        answers.append(dict(rid=rid, degraded=res.degraded, eps_effective=e, correct=ok,
                            stopped=res.stopped, rounds=res.rounds, tuples=res.tuples_read))
    out = dict(wall_s=run["wall_s"], rounds=sched.rounds, blocks_read=sched.blocks_read,
               blocks_quarantined=sched.blocks_quarantined,
               tuples_quarantined=sched.tuples_quarantined, q=q,
               eps_inflation=sched.eps_inflation, injected=res_src.inner.injector.injected,
               validation_failures=res_src.validation_failures,
               degraded_outcomes=sum(r["degraded"] for r in probe.rows),
               outcomes=len(probe.rows), counts_are_read_histogram=True, answers=answers,
               launches=launches, telemetry=quarantine_telemetry)
    log(f"8b quarantine: {({k: v for k, v in out.items() if k != 'answers'})}")
    return out


class _SaveProbe:
    """Times every `CheckpointManager.save` while installed, with the
    bytes its step dir holds."""

    def __init__(self):
        from repro_torch.checkpoint import CheckpointManager

        self.cls, self._save, self.saves = CheckpointManager, CheckpointManager.save, []

    def __enter__(self):
        probe = self

        def save(manager, state, step):
            t = time.perf_counter()
            path = probe._save(manager, state, step)
            wall = time.perf_counter() - t
            probe.saves.append(dict(step=step, ms=wall * 1e3,
                                    bytes=sum(f.stat().st_size for f in path.iterdir())))
            return path

        self.cls.save = save
        return self

    def __exit__(self, *exc):
        self.cls.save = self._save


def _phase8_recovery(torch, ctx, tmp: Path) -> dict:
    """8c: a supervisor crashed halfway restores its snapshot and answers
    every request; no device memory leaks from the wounded server."""
    import numpy as np

    from repro_torch.io import FaultPlan, FaultySource
    from repro_torch.serve import MatchServer, ServeSupervisor

    source = ctx["source"]
    topk, _, _ = ctx["workload"]
    truth, _ = _workload_truth(torch, ctx)
    k, eps, delta = 10, 0.12, 0.01
    kw = dict(max_queries=8, lookahead=512, metric="l1", autosave_every=2)

    def supervise(crash_at, directory, telemetry=None):
        sup = ServeSupervisor(FaultySource(source, FaultPlan(crash_at=crash_at)),
                              checkpoint_dir=str(directory), telemetry=telemetry, **kw)
        return sup, [sup.submit(tg, k=k, eps=eps, delta=delta) for tg in topk]

    # the run that never crashes places the crash halfway through its rounds
    clean, clean_rids = supervise(None, tmp / "clean")
    clean_res = clean.run_until_idle()
    clean_rounds = clean.server.scheduler.rounds
    second = sorted(clean_res[r].rounds for r in clean_rids)[1]
    crash_at = 1 + max(clean_rounds // 2, second + 1)  # attempt 0: the config-hash probe
    del clean

    sup, rids = supervise(crash_at, tmp / "crash", telemetry=True)
    mem = {}
    restored = {}
    build, recover = sup._build_server, sup._recover

    def build_server():
        server = build()
        manager, sched = server._manager, server.scheduler
        step = manager.latest_step()
        check(step is not None, "8c: no snapshot was on disk at the crash")
        files = [np.load(manager.dir / f"step_{step}" / f"arr_{i}.npy") for i in range(9)]
        snap = sched.export_cache()
        for f, want in zip(snap._fields, files):
            got = getattr(snap, f).cpu().numpy()
            check(np.array_equal(got, want.astype(got.dtype)) and want.shape == got.shape,
                  f"8c: the restored {f} is not the snapshot's file")
        restored.update(step=step, rounds=sched.rounds, tuples=sched.tuples_read)
        return server

    def recover_server(exc):
        recover(exc)
        torch.cuda.synchronize()
        mem["after_recovery"] = torch.cuda.memory_allocated()

    sup._build_server, sup._recover = build_server, recover_server
    # the device memory with the wounded server still live: read at the
    # fetch that crashes
    faulty = sup._dataset
    fetch = faulty.fetch

    def fetch_and_measure(win, pad_to=None):
        if faulty.injector.attempts == crash_at:
            torch.cuda.synchronize()
            mem["live"] = torch.cuda.memory_allocated()
        return fetch(win, pad_to)

    faulty.fetch = fetch_and_measure
    _reset_launches()
    t = time.perf_counter()
    with _SaveProbe() as saves, _StatsProbe() as stats:
        results = sup.run_until_idle()
        sup.server.save_cache()  # at shutdown, so the restore below sees every read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _launch_counts()
    sched = sup.server.scheduler
    _check_per_round(launches, sched.rounds, stats.stats_steps, "8c")
    check(sup.restarts == 1 and "UnrecoverableIOError" in sup.last_error,
          f"8c: {sup.restarts} restarts, last error {sup.last_error!r}")
    check(sup.unresolved == 0 and sorted(results) == sorted(rids), "8c: a request went unanswered")
    for i, rid in enumerate(rids):
        check(_meets_guarantee1(results[rid].ids, truth[i], eps, k),
              f"8c request {rid} misses Guarantee 1")
    leak = mem["after_recovery"] - mem["live"]
    check(abs(leak) <= 8 << 20, f"8c: device memory moved {leak} bytes across the recovery")
    same_ids = all(np.array_equal(results[r].ids, clean_res[c].ids)
                   for r, c in zip(rids, clean_rids))
    reg = sup.telemetry.registry
    recovery_telemetry = {name: reg.get(name).value for name in (
        "serve_crashes_total", "serve_recoveries_total", "checkpoint_saves_total",
        "checkpoint_save_bytes_total", "fastmatch_queries_retired_total")}
    recovery_telemetry.update(
        serve_crash_events=len(sup.telemetry.tracer.events("serve_crash")),
        serve_recovered_events=len(sup.telemetry.tracer.events("serve_recovered")),
        checkpoint_save_events=len(sup.telemetry.tracer.events("checkpoint_save")))
    check(recovery_telemetry["serve_crashes_total"] == recovery_telemetry["serve_recoveries_total"]
          == recovery_telemetry["serve_crash_events"] == 1
          and recovery_telemetry["checkpoint_saves_total"] == len(saves.saves)
          == recovery_telemetry["checkpoint_save_events"],
          f"8c: telemetry {recovery_telemetry}, {len(saves.saves)} saves counted")

    # warm construction on the same files, no crash plan: the query that
    # retired last did so on the counts saved at shutdown, so its
    # re-submission is covered by the cache and reads nothing new
    last = list(results)[-1]
    t = time.perf_counter()
    warm = MatchServer.restore(source, checkpoint_dir=str(tmp / "crash"), max_queries=8,
                               lookahead=512, metric="l1")
    restore_ms = (time.perf_counter() - t) * 1e3
    warm_rid = warm.submit(topk[rids.index(last)], k=k, eps=eps, delta=delta)
    warm_res = warm.run_until_idle()[warm_rid]
    check(warm_res.tuples_read == 0, f"8c: the covered re-submission read {warm_res.tuples_read}")
    out = dict(wall_s=wall, crash_at=crash_at, clean_rounds=clean_rounds, rounds=sched.rounds,
               restarts=sup.restarts, recovery_ms=sup.recovery_s_total * 1e3,
               restored=restored, saves=saves.saves, restore_ms=restore_ms,
               memory_live_bytes=mem["live"], memory_after_recovery_bytes=mem["after_recovery"],
               memory_moved_bytes=leak, ids_equal_uncrashed=same_ids,
               warm_resubmit_tuples=warm_res.tuples_read, launches=launches,
               telemetry=recovery_telemetry)
    log(f"8c recovery: {out}")
    return out


def _prefetch_threads() -> list:
    import threading

    return [t for t in threading.enumerate() if t.name == "block-prefetch" and t.is_alive()]


def _phase8_prefetch(torch, ctx, expect) -> dict:
    """8d: phase 4's FastMatch query from host memory without and with
    prefetch, then from the resident table with prefetch: bitwise the
    same three times."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.io import InMemorySource

    host = InMemorySource(ctx["blocked"], device_resident=False, device=ctx["source"].device)
    base = ctx["fastmatch"]
    runs = {}
    for name, source, prefetch in (("host", host, False), ("host_prefetch", host, True),
                                   ("resident_prefetch", ctx["source"], True)):
        cfg = dataclasses.replace(ctx["cfg"], prefetch=prefetch)
        # a first run pays the one-time costs (pinned host buffers, the
        # side stream), so the timed run is the second
        warm = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
        check(np.array_equal(warm.ids, base.ids), f"8d {name}: the warm-up run differs")
        _reset_launches()
        with _StatsProbe() as stats:
            t = time.perf_counter()
            res = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = _launch_counts()
        _check_per_round(launches, res.rounds, stats.stats_steps, f"8d {name}")
        check(np.array_equal(res.ids, base.ids) and torch.equal(res.state.tau, base.state.tau)
              and (res.rounds, res.blocks_read) == (base.rounds, base.blocks_read),
              f"8d {name}: {res.rounds} rounds, {res.blocks_read} blocks, not phase 4's answer")
        if expect is not None:
            check((res.rounds, res.blocks_read) == expect, f"8d {name}: not {expect}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
            torch.cuda.synchronize()
        check(np.array_equal(again.ids, res.ids), f"8d {name}: a repeated run differs")
        device_ms, by_kernel, _ = _profile_tables(torch, prof)
        runs[name] = dict(wall_ms=wall * 1e3, rounds=res.rounds, blocks_read=res.blocks_read,
                          device_ms=device_ms, device_busy_share=device_ms / (wall * 1e3),
                          copies=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel
                                  if n.startswith("Memcpy")],
                          launches=launches)
        log(f"8d {name}: {wall * 1e3:.1f} ms, {res.rounds} rounds, device {device_ms:.2f} ms")
    check(not _prefetch_threads(), "8d: a prefetch worker is still alive")
    return dict(runs=runs, bitwise_equal=True, threads_alive=0)


def phase_faults(torch, ctx, *, expect, expect_quarantine) -> dict:
    """Phase 8 (see the module docstring)."""
    import tempfile

    report = {}
    for name, fn in (("chaos", lambda: _phase8_chaos(torch, ctx)),
                     ("quarantine", lambda: _phase8_quarantine(torch, ctx, expect_quarantine))):
        t = time.perf_counter()
        report[name] = fn()
        report[name]["phase_s"] = time.perf_counter() - t
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        report["recovery"] = _phase8_recovery(torch, ctx, Path(tmp))
        report["recovery"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report["prefetch"] = _phase8_prefetch(torch, ctx, expect)
    report["prefetch"]["phase_s"] = time.perf_counter() - t
    emit({"check": "faults", **report})
    return report


# ---------------------------------------------------------------------------
# phase 9: telemetry on phase 4's resident table
# ---------------------------------------------------------------------------


class _CostAccount:
    """The host time spent inside every telemetry entry point while
    installed, reentrancy-guarded so that nested entry points count once
    (the reference's accounting, benchmarks/telemetry_overhead.py). Every
    wrapped entry point runs on the serving loop's thread."""

    def __init__(self):
        from repro_torch.core import multiquery as mq
        from repro_torch.obs import registry, telemetry, tracer

        self.sites = ((mq.SharedCountsScheduler, "_record_poll"),
                      (mq.SharedCountsScheduler, "flush_telemetry"),
                      (mq.SharedCountsScheduler, "_emit_round_batch"),
                      (tracer.Tracer, "emit"), (registry.Counter, "inc"),
                      (registry.Gauge, "set"), (registry.Histogram, "observe"),
                      (registry.Histogram, "observe_many"),
                      (telemetry.Telemetry, "record_curve_point"))
        self.total_s, self.by_site, self._depth, self._saved = 0.0, {}, 0, []

    def _wrap(self, fn, site: str):
        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self.total_s += dt
                self.by_site[site] = self.by_site.get(site, 0.0) + dt
                self._depth -= 1

        return timed

    def __enter__(self):
        for cls, name in self.sites:
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._wrap(fn, f"{cls.__name__}.{name}"))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved.clear()


def _timer_residual_s() -> float:
    """What the wrappers cannot see, a window: the bare `perf_counter`
    pairs of the gather, dispatch and sync timing and the accumulator
    adds, charged as 8 timer calls and 3 list appends (rounded up, as the
    reference charges them), measured here."""
    sink: list = []
    reps = 20_000
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(8):
            time.perf_counter()
        sink.append(0.0)
        sink.append(0.0)
        sink.append(0.0)
        if len(sink) >= 30_000:
            sink.clear()
    return (time.perf_counter() - t0) / reps


def _prometheus_values(text: str) -> dict:
    """{sample name with labels: value} of a Prometheus text body."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _check_against_phase5(torch, run, ctx, launches, what: str) -> None:
    """A serving run of phase 5's workload is bitwise phase 5: every
    request's answer, the polls, the exported cache and the launches."""
    import numpy as np

    p5, base = ctx["phase5"], ctx["served"]
    server, sched = run["server"], run["server"].scheduler
    check(run["topk"] + run["close"] == list(base), f"{what} served other requests than phase 5")
    for rid, want in base.items():
        got = server.results[rid]
        check(np.array_equal(got.ids, want.ids), f"{what} request {rid}: ids differ from phase 5")
        for f in ("rounds", "tuples_read", "exact", "stopped"):
            check(getattr(got, f) == getattr(want, f),
                  f"{what} request {rid}: {f} {getattr(got, f)} vs phase 5's {getattr(want, f)}")
        check(torch.equal(got.state.tau, want.state.tau),
              f"{what} request {rid}: tau is not bitwise phase 5's")
    for f in ("host_syncs", "loop_syncs", "rounds"):
        check(getattr(sched, f) == p5[f], f"{what}: {f} {getattr(sched, f)} vs phase 5's {p5[f]}")
    for f, got, want in zip(sched.export_cache()._fields, sched.export_cache(), p5["cache"]):
        check(torch.equal(got, want), f"{what}: the exported {f} is not bitwise phase 5's")
    check(launches == p5["launches"], f"{what}: launches {launches} vs phase 5's {p5['launches']}")


def phase_telemetry(torch, timer, ctx) -> dict:
    """Phase 9 (see the module docstring)."""
    import contextlib
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import multiquery as mq
    from repro_torch.kernels import histogram, ref

    topk, close, stop_tuples = ctx["workload"]
    source = ctx["source"]
    t_phase = time.perf_counter()
    runs = []
    # off and on in turns, three each; the last on run is the accounted one
    for i, on in enumerate((False, True) * 3):
        accounted = i == 5
        _reset_launches()
        with _CostAccount() if accounted else contextlib.nullcontext() as acct:
            run = _serve_taxi(torch, source, topk, close, stop_tuples,
                              telemetry=True if on else None)
        launches = _launch_counts()
        what = f"9 ({'on' if on else 'off'} run {i // 2 + 1})"
        _check_against_phase5(torch, run, ctx, launches, what)
        check((run["server"].telemetry is not None) == on, f"{what}: telemetry is not {on}")
        runs.append(dict(on=on, wall_s=run["wall_s"], accounted=accounted, server=run["server"],
                         account=acct, launches=launches))
    off_walls = [r["wall_s"] for r in runs if not r["on"]]
    on_runs = [r for r in runs if r["on"]]
    on_walls = [r["wall_s"] for r in on_runs if not r["accounted"]]

    # the registry against the scheduler, the curves against Theorem 1, the
    # skeletons of the on runs against each other
    skeletons, splits = [], []
    for r in on_runs:
        server = r["server"]
        tel, sched = server.telemetry, server.scheduler
        reg = tel.registry
        mirrors = {"fastmatch_rounds_total": sched.rounds,
                   "fastmatch_tuples_read_total": sched.tuples_read,
                   "fastmatch_blocks_read_total": sched.blocks_read,
                   "fastmatch_host_syncs_total": sched.host_syncs,
                   "fastmatch_passes_total": sched.passes,
                   "fastmatch_queries_submitted_total": 12,
                   "fastmatch_queries_admitted_total": 12,
                   "fastmatch_queries_retired_total": 12}
        sched.flush_telemetry()
        for name, want in mirrors.items():
            check(reg.get(name).value == want, f"9: {name} {reg.get(name).value} vs {want}")
        deltas = {e["qid"]: e["delta"] for e in tel.tracer.events("query_admit")}
        check(sorted(deltas) == tel.query_ids() and len(deltas) == 12,
              f"9: curves for {tel.query_ids()}, admissions {sorted(deltas)}")
        for qid in tel.query_ids():
            traj = tel.trajectory(qid)
            check(bool(traj) and all(
                p["eps_n"] == mq._metric_eps_np(p["n_min"], deltas[qid] / source.v_z, source.v_x,
                                                "l1") for p in traj),
                f"9: query {qid}'s eps_n is not Theorem 1 at its n_min")
        skeletons.append(tel.tracer.skeleton())
        batches = tel.tracer.events("round_batch")
        splits.append(dict(
            windows=sum(e["windows"] for e in batches), batches=len(batches),
            gather_ms=sum(e["gather_s"] for e in batches) * 1e3,
            dispatch_ms=sum(e["dispatch_s"] for e in batches) * 1e3,
            sync_ms=sum(e["sync_s"] for e in batches) * 1e3, wall_ms=r["wall_s"] * 1e3))
    check(all(sk == skeletons[0] for sk in skeletons[1:]), "9: the on runs' skeletons differ")

    # the accounted telemetry host time, as a share of the off walls
    acct = on_runs[-1]["account"]
    per_window_s = _timer_residual_s()
    timers_s = splits[-1]["windows"] * per_window_s
    accounted_s = acct.total_s + timers_s
    off_ms = statistics.median(off_walls) * 1e3

    # a profiled on run: the PyTorch launches a round of phase 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = _serve_taxi(torch, source, topk, close, stop_tuples, telemetry=True)
    rounds = again["server"].scheduler.rounds
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))
    check(host_launches / rounds == ctx["phase5"]["host_launches_per_round"],
          f"9: {host_launches / rounds} PyTorch launches a round with telemetry on, phase 5 "
          f"{ctx['phase5']['host_launches_per_round']}")

    # the exports round-trip (a registry read: kernel B bins, counted
    # apart from the serving runs above)
    server = on_runs[0]["server"]
    tel = server.telemetry
    metrics = {name: tel.registry.get(name) for name in tel.registry.names()}
    hists = {name: m for name, m in metrics.items() if m.kind == "histogram"}
    pending = {name: np.asarray(m._pending, np.float64) for name, m in hists.items()}
    _reset_launches()
    t = time.perf_counter()
    prom = server.prometheus_metrics()
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t) * 1e3
    registry_launches = _launch_counts()["histogram"]
    nonempty = [name for name, v in pending.items() if v.size]
    check(registry_launches == len(nonempty),
          f"9: the registry read launched kernel B {registry_launches} times for {nonempty}")
    snap = tel.registry.snapshot()
    for name, vals in pending.items():
        edges = hists[name].edges
        ids = np.searchsorted(edges, vals, side="left")
        want = np.bincount(ids, minlength=len(edges) + 1)
        check(snap[name]["buckets"] == want.tolist(),
              f"9: {name} binned {snap[name]['buckets']}, the plain count {want.tolist()}")
    parsed = _prometheus_values(prom)
    for name, m in snap.items():
        if m["kind"] == "histogram":
            cum = np.cumsum(m["buckets"])[:-1]
            check([parsed[f'{name}_bucket{{le="{le}"}}'] for le in
                   [_le(e) for e in m["edges"]]] == cum.tolist()
                  and parsed[f"{name}_count"] == m["count"], f"9: {name} does not round-trip")
        else:
            check(parsed[name] == m["value"], f"9: {name} does not round-trip")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "trace.jsonl"
        n_events = server.export_trace(path)
        back = [json.loads(line) for line in path.read_text().splitlines()]
    check(n_events == len(back) and back == json.loads(json.dumps(tel.tracer.events())),
          "9: the exported trace does not round-trip")

    # kernel B at the registry's shape: the round-batch histogram's samples
    name = "fastmatch_round_batch_seconds"
    edges = hists[name].edges
    vals = pending[name]
    x = torch.from_numpy(np.searchsorted(edges, vals, side="left").astype(np.int32)).cuda()
    z = torch.zeros_like(x)
    v_x = len(edges) + 1
    got = histogram.histogram(z, x, v_z=1, v_x=v_x)
    plain = ref.histogram_ref(z, x, v_z=1, v_x=v_x)
    check(torch.equal(got, plain), "9: kernel B at the registry's shape differs from its plain version")
    b_ms, b_host = timer(lambda: histogram.histogram(z, x, v_z=1, v_x=v_x))
    b_plain, _ = timer(lambda: ref.histogram_ref(z, x, v_z=1, v_x=v_x))
    b_lib, _ = timer(lambda: torch.bincount(x, minlength=v_x))
    b_bound, b_by = bound_ms(2 * 4 * x.numel() + 4 * v_x, x.numel())
    flush_h = type(hists[name])(name, edges, device=source.device)
    flush_h.observe_many(vals)
    t = time.perf_counter()
    flush_h.bucket_counts()
    flush_us = (time.perf_counter() - t) * 1e6

    out = dict(
        off_walls_ms=[w * 1e3 for w in off_walls], on_walls_ms=[w * 1e3 for w in on_walls],
        accounted_run_wall_ms=on_runs[-1]["wall_s"] * 1e3,
        phase5_wall_ms=ctx["phase5"]["wall_s"] * 1e3,
        accounted_ms=accounted_s * 1e3, accounted_hooks_ms=acct.total_s * 1e3,
        accounted_timers_ms=timers_s * 1e3, timer_residual_us_per_window=per_window_s * 1e6,
        accounted_share_of_off_wall=accounted_s * 1e3 / off_ms,
        accounted_by_site_ms={k: v * 1e3 for k, v in sorted(acct.by_site.items())},
        round_batch=splits, rounds=rounds, host_syncs=ctx["phase5"]["host_syncs"],
        loop_syncs=ctx["phase5"]["loop_syncs"],
        host_launches_per_round=host_launches / rounds,
        device_kernels_per_round=device_kernels / rounds, profiled_device_ms=device_ms,
        profiled_wall_ms=again["wall_s"] * 1e3,
        trace_events=len(skeletons[0]), curve_points=sum(
            len(tel.trajectory(q)) for q in tel.query_ids()),
        registry_read=dict(launches=registry_launches, histograms=nonempty, ms=read_ms,
                           flush_us=flush_us, samples=int(vals.size)),
        registry_kernel=dict(shape=[1, v_x], samples=int(x.numel()), ms=b_ms, host_us=b_host * 1e3,
                             plain_ms=b_plain, library_ms=b_lib, bound_ms=b_bound, bound_by=b_by,
                             max_abs_err=0.0),
        bitwise_phase5=True, launches=on_runs[0]["launches"],
    )
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"9 telemetry: off {out['off_walls_ms']} ms, on {out['on_walls_ms']} ms, accounted "
        f"{out['accounted_ms']:.3f} ms ({out['accounted_share_of_off_wall']:.2%}); "
        f"round_batch {splits[0]}; registry read {registry_launches} B launches, kernel B at "
        f"(1, {v_x}) {b_ms * 1e3:.2f} us; {out['phase_s']:.1f}s")
    emit({"check": "telemetry", **out})
    return out


# ---------------------------------------------------------------------------
# phase 10: the mesh and the data-parallel pump on phase 4's resident table
# ---------------------------------------------------------------------------

MESH_RANKS = 4
LOCKSTEP_ROUNDS = 12
LOCKSTEP_ORDER_SEED = 10  # 10a's shuffled global windows


def _digest(*arrays) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _lockstep_targets(ctx):
    """10a's four queries: phase 5's first top-k targets; the first stops
    after ~2 windows of tuples (a retirement inside the 12 rounds), the
    fourth is admitted at round 3."""
    topk, _, _ = ctx["workload"]
    return [topk[0], topk[1], topk[2], topk[3]]


def _lockstep(sched, targets, order, window: int, full_counts) -> list:
    """Drive ``sched`` through 10a's rounds; one record a round."""
    from repro_torch.core.multiquery import StopPolicy

    k, eps, delta = 10, 0.12, 0.01
    sched.admit(targets[0], k=k, eps=eps, delta=delta,
                stop=StopPolicy(tuples=2 * window * 512))
    for tg in targets[1:3]:
        sched.admit(tg, k=k, eps=eps, delta=delta)
    records = []
    for r in range(LOCKSTEP_ROUNDS):
        if r == 3:
            sched.admit(targets[3], k=k, eps=0.2, delta=delta)
        sched.run_window(order[r * window : (r + 1) * window])
        sched._poll_terminated()
        counts, n = full_counts()
        st = sched.state
        records.append(dict(
            counts=_digest(counts.cpu().numpy()), n=_digest(n.cpu().numpy()),
            tau=st.tau.cpu().numpy(), du=st.delta_upper.cpu().numpy(),
            eps_i=st.eps_i.cpu().numpy(), n_full=n.cpu().numpy(),
            mask=_digest(sched.read_mask),
            counters=[sched.rounds, sched.blocks_read, sched.blocks_considered,
                      sched.tuples_read],
            live=sorted(sched.tickets), retired=sorted(sched.outcomes)))
    return records


def _mesh_rank(rank, world, shared, meta):
    """One gloo rank of phase 10 on the card: 10a's lockstep at 2 x 2, 10b's
    query at 4 x 1, 10c's serving at 2 x 2. Rank 0 returns the records;
    every rank its launches and collective time per sub-phase."""
    import numpy as np
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.multiquery import MultiQuerySpec
    from repro_torch.core.pump import DistributedPump
    from repro_torch.data.layout import BlockedDataset
    from repro_torch.serve import MatchServer

    entered_at = time.time()  # the wall clock, comparable with the parent's
    t_start = time.perf_counter()
    blocked = BlockedDataset(shared["z"].numpy(), shared["x"].numpy(),
                             shared["bitmap"].numpy().view(np.uint32), meta["v_z"], meta["v_x"])
    order = np.random.default_rng(LOCKSTEP_ORDER_SEED).permutation(blocked.num_blocks)
    mesh22 = distributed.init_mesh((2, 2), device_type="cuda")
    mesh41 = distributed.init_mesh((4, 1), device_type="cuda")
    out = dict(rank=rank, entered_at=entered_at, attach_s=time.perf_counter() - t_start,
               startup=dict(imported=T0_WALL, **distributed.RANK_STARTUP))

    def measured(name, fn):
        _reset_launches()
        c0 = dict(distributed.COLLECTIVES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = dict(
            wall_s=time.perf_counter() - t, launches=_launch_counts(),
            collective_calls=distributed.COLLECTIVES["calls"] - c0["calls"],
            collective_s=distributed.COLLECTIVES["seconds"] - c0["seconds"],
            collective_bytes=distributed.COLLECTIVES["bytes"] - c0["bytes"])
        return result

    # -- 10a: the lockstep golden at 2 x 2
    spec = MultiQuerySpec(v_z=meta["v_z"], v_x=meta["v_x"], max_queries=4)
    pmp = DistributedPump(blocked, spec, mesh=mesh22, window=512, seed=0, start_block=0)
    records = measured("lockstep", lambda: _lockstep(pmp, meta["lockstep_targets"], order, 512,
                                                     pmp._full_counts))
    out["lockstep"].update(rounds=pmp.rounds, plans=dataclasses.asdict(pmp.plans),
                           stats_steps=LOCKSTEP_ROUNDS + 4)
    if rank == 0:
        out["lockstep_records"] = records
    del pmp
    torch.cuda.empty_cache()

    # -- 10b: phase 4's query through a 4 x 1 pump server, telemetry on
    t = time.perf_counter()
    srv = MatchServer(blocked, mesh=mesh41, pump=True, max_queries=1, k_cap=10,
                      lookahead=512, seed=meta["seed"], telemetry=True)
    construct_s = time.perf_counter() - t

    def query():
        rid = srv.submit(meta["target"], k=10, eps=0.12, delta=0.01)
        return srv.run_until_idle()[rid]

    res = measured("query", query)
    sched = srv.scheduler
    gathers = [e["worker_gather_s"] for e in srv.telemetry.tracer.events("round_batch")]
    out["query"].update(
        rounds=sched.rounds, passes=sched.passes, host_syncs=sched.host_syncs,
        worker_gather_s=np.sum(gathers, axis=0).tolist(), shard_blocks=sched.shard.num_blocks,
        construct_s=construct_s)
    if rank == 0:
        counts, n = sched._full_counts()
        out["query_result"] = dict(
            ids=np.asarray(res.ids), rounds=res.rounds, passes=res.passes,
            blocks_read=res.blocks_read, tuples_read=res.tuples_read, exact=res.exact,
            delta_upper=res.delta_upper, counts=counts.cpu().numpy(), n=n.cpu().numpy(),
            read_mask=np.array(sched.read_mask))
    del srv, sched, res
    torch.cuda.empty_cache()

    # -- 10c: phase 5's workload through a 2 x 2 pump server
    topk, close, stop_tuples = meta["workload"]
    t = time.perf_counter()
    server = MatchServer(blocked, max_queries=8, lookahead=512, metric="l1", mesh=mesh22,
                         pump=True)
    construct_s = time.perf_counter() - t
    run = measured("serving", lambda: _serve_taxi(torch, blocked, topk, close, stop_tuples,
                                                  server=server))
    server, sched = run["server"], run["server"].scheduler
    out["serving"].update(rounds=sched.rounds, host_syncs=sched.host_syncs,
                          tuples=sched.tuples_read, served_wall_s=run["wall_s"],
                          construct_s=construct_s)
    if rank == 0:
        results = server.results
        blocking = results[run["close"][0]]
        final = run["stream"][-1]
        out["serving_results"] = dict(
            topk=[dict(ids=np.asarray(results[r].ids), stopped=results[r].stopped,
                       stop_reason=results[r].stop_reason, exact=results[r].exact,
                       tuples=results[r].tuples_read, qtype=results[r].qtype)
                  for r in run["topk"]],
            close=[dict(ids=np.asarray(results[r].ids), stopped=results[r].stopped,
                        qtype=results[r].qtype, tuples=results[r].tuples_read)
                   for r in run["close"]],
            stream_ok=bool(final.status == "done"
                           and all(a.status != "done" for a in run["stream"][:-1])
                           and final.result is blocking
                           and np.array_equal(final.ids, blocking.ids)),
            stopped_last_poll=bool(np.array_equal(server.poll_result(run["topk"][0]).ids,
                                                  results[run["topk"][0]].ids)))
    out["total_s"] = time.perf_counter() - t_start
    out["done_at"] = time.time()
    return out


def _share_table(torch, blocked) -> dict:
    """The host arrays in shared memory: a child maps them by handle."""
    import numpy as np

    return dict(
        z=torch.from_numpy(blocked.z_blocks).share_memory_(),
        x=torch.from_numpy(blocked.x_blocks).share_memory_(),
        bitmap=torch.from_numpy(np.ascontiguousarray(blocked.bitmap).view(np.int32))
        .share_memory_())


def _one_rank_nccl(torch, ctx, seed: int) -> dict:
    """10b on a one-rank NCCL mesh in this process: phase 4's query through
    `MatchServer(mesh=, pump=True)`, which must be bitwise phase 4."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.serve import MatchServer

    fm = ctx["fastmatch"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{distributed._free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = distributed.init_mesh((1, 1), device_type="cuda")
        walls = []
        for _ in range(2):  # the second run's wall, after a warm-up; both checked
            server = MatchServer(ctx["blocked"], mesh=mesh, pump=True, max_queries=1, k_cap=10,
                                 lookahead=512, seed=seed)
            _reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rid = server.submit(ctx["target"], k=10, eps=0.12, delta=0.01)
            res = server.run_until_idle()[rid]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            launches = _launch_counts()
            counts, n = server.scheduler._full_counts()
            check(np.array_equal(res.ids, fm.ids)
                  and (res.rounds, res.blocks_read, res.tuples_read, res.exact)
                  == (fm.rounds, fm.blocks_read, fm.tuples_read, fm.exact),
                  f"10b one-rank NCCL: {res.rounds} rounds, {res.blocks_read} blocks, ids "
                  f"{res.ids}, not phase 4's {fm.rounds} / {fm.blocks_read} / {fm.ids}")
            check(torch.equal(res.state.tau, fm.state.tau) and torch.equal(counts, fm.state.counts)
                  and torch.equal(n, fm.state.n) and res.delta_upper == fm.delta_upper,
                  "10b one-rank NCCL: tau, counts, n or delta_upper not bitwise phase 4's")
            _check_per_round(launches, res.rounds, res.rounds + 1, "10b one-rank NCCL")
            del server, counts, n
            torch.cuda.empty_cache()
        check(dist.get_backend() == "nccl", "10b: the one-rank mesh is not NCCL")
        wall = walls[-1]
        out = dict(rounds=res.rounds, blocks_read=res.blocks_read, wall_s=wall,
                   walls_s=walls, launches=launches, bitwise_phase4=True,
                   backend=dist.get_backend(), phase4_wall_s=ctx["fastmatch"].wall_time_s)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"10b one-rank NCCL: {out['rounds']} rounds, {out['blocks_read']} blocks, "
        f"{wall * 1e3:.1f} ms, bitwise phase 4")
    return out


def _theorem1_ok(du_got, du_want, tau_got, tau_want, n, eps_i) -> bool:
    """log(delta_upper) within max_i n_i (eps_i + 2D) 2D + 1e-6 of the
    single stream's, D the tau gap (the Theorem-1 tolerance of
    `tests/test_torch_rounds.py`)."""
    import numpy as np

    d = float(np.abs(tau_got.astype(np.float64) - tau_want.astype(np.float64)).max())
    if d > TAU_ATOL:
        return False
    for s in range(len(du_want)):
        if du_want[s] == 0.0 or du_got[s] == 0.0:
            if du_want[s] != du_got[s]:
                return False
            continue
        bound = float(np.max(n.astype(np.float64) * (eps_i[s].astype(np.float64) + 2 * d)
                             * 2 * d)) + 1e-6
        if abs(np.log(float(du_got[s])) - np.log(float(du_want[s]))) > bound:
            return False
    return True


def phase_mesh(torch, ctx, *, seed: int) -> dict:
    """Phase 10 (see the module docstring): the mesh paths on phase 4's
    resident table and its host arrays."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.core.multiquery import MultiQuerySpec, SharedCountsScheduler
    from repro_torch.kernels import metrics

    t_phase = time.perf_counter()
    blocked, source = ctx["blocked"], ctx["source"]
    v_z, v_x, nb = source.v_z, source.v_x, source.num_blocks

    # -- 10b, first half: a one-rank NCCL mesh in this process
    nccl = _one_rank_nccl(torch, ctx, seed)

    # -- 10a's single stream, here, on the resident table
    targets = _lockstep_targets(ctx)
    order = np.random.default_rng(LOCKSTEP_ORDER_SEED).permutation(nb)
    spec = MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=4)
    single = SharedCountsScheduler(source, spec, window=512, seed=0, start_block=0)
    want = _lockstep(single, targets, order, 512, lambda: (single.state.counts, single.state.n))
    single_plans = dataclasses.asdict(single.plans)
    del single

    # -- the children: 10a at 2 x 2, 10b at 4 x 1, 10c at 2 x 2
    t = time.perf_counter()
    shared = _share_table(torch, blocked)
    share_s = time.perf_counter() - t
    # small arguments only: a child reads its pickled arguments after it
    # imports torch, and the parent's write of a large pickle waits for
    # it, which would start the children one after another
    meta = dict(v_z=v_z, v_x=v_x, seed=seed, target=ctx["target"], lockstep_targets=targets,
                workload=ctx["workload"])
    t, spawned_at = time.perf_counter(), time.time()
    ranks = distributed.run_ranks(_mesh_rank, MESH_RANKS, shared, meta, backend="gloo",
                                  device_type="cuda", timeout=600)
    ranks_s = time.perf_counter() - t
    del shared
    r0 = ranks[0]

    # -- 10a: every round bitwise the single stream (delta_upper within
    # Theorem 1 if the shard resolved another plan)
    got = r0["lockstep_records"]
    same_plans = r0["lockstep"]["plans"] == single_plans
    check(any(w["retired"] for w in want), "10a: no query retired inside the lockstep rounds")
    for r, (g, w) in enumerate(zip(got, want)):
        for key in ("counts", "n", "mask", "counters", "live", "retired"):
            check(g[key] == w[key], f"10a round {r}: {key} differs from the single stream")
        if same_plans:
            check(np.array_equal(g["tau"], w["tau"]) and np.array_equal(g["du"], w["du"]),
                  f"10a round {r}: tau or delta_upper not bitwise the single stream's")
        else:
            check(_theorem1_ok(g["du"], w["du"], g["tau"], w["tau"], w["n_full"], w["eps_i"]),
                  f"10a round {r}: tau or delta_upper past the Theorem-1 tolerance")
    for rk in ranks:
        lk = rk["lockstep"]
        for name in ("anyactive", "histogram"):
            check(lk["launches"][name] == LOCKSTEP_ROUNDS,
                  f"10a rank {rk['rank']}: {lk['launches'][name]} {name} launches for "
                  f"{LOCKSTEP_ROUNDS} rounds")
        check(sum(lk["launches"][c] for c in C_FORMS) >= lk["stats_steps"],
              f"10a rank {rk['rank']}: kernel C launched under once a statistics step")

    # -- 10b: Guarantee 1 against the exact truth; the counts the read
    # blocks' histogram
    q = r0["query_result"]
    truth = ctx["counts"]  # Scan's exact counts: the exact tau below
    q_hat = torch.from_numpy((ctx["target"] / ctx["target"].sum()).astype(np.float32))
    exact_tau = metrics.distance_multi_ref(truth, q_hat[None].to(truth.device))[0]
    exact_tau = exact_tau.cpu().numpy().astype(np.float64)
    check(_meets_guarantee1(q["ids"], exact_tau, 0.12, 10),
          "10b 4 x 1: the answer misses Guarantee 1")
    check(q["delta_upper"] < 0.01 and not q["exact"], "10b 4 x 1: the bound did not fire")
    read = torch.from_numpy(np.flatnonzero(q["read_mask"])).to(source.device)
    z, x = source._z[read].reshape(-1), source._x[read].reshape(-1)
    keep = z >= 0
    hist = torch.bincount(z[keep].long() * v_x + x[keep].long(), minlength=v_z * v_x)
    hist = hist.to(torch.float32).reshape(v_z, v_x).cpu().numpy()
    check(np.array_equal(hist, q["counts"]) and np.array_equal(hist.sum(1), q["n"]),
          "10b 4 x 1: the counts are not the histogram of the blocks the read mask marks")
    check(int(q["read_mask"].sum()) == q["blocks_read"], "10b 4 x 1: read mask and blocks differ")
    for rk in ranks:
        qr = rk["query"]
        _check_per_round(qr["launches"], qr["rounds"], qr["rounds"], f"10b rank {rk['rank']}")

    # -- 10c: phase 5's checks on every answer
    sv = r0["serving_results"]
    wtruth, _ = _workload_truth(torch, ctx)
    for i, res in enumerate(sv["topk"]):
        check(res["qtype"] == "topk" and len(res["ids"]) == 10, f"10c top-k {i} malformed")
        if i == 0:
            check(res["stopped"] and res["stop_reason"] == "tuples" and not res["exact"],
                  f"10c: the stopped query reports {res['stopped']} {res['stop_reason']!r}")
        else:
            check(not res["stopped"] and _meets_guarantee1(res["ids"], wtruth[i], 0.12, 10),
                  f"10c top-k request {i} is not (eps, k)-correct")
    for i, res in enumerate(sv["close"]):
        d, ids = wtruth[8 + i], set(res["ids"].tolist())
        check(res["qtype"] == "closeness" and not res["stopped"], f"10c closeness {i} malformed")
        check(set(np.flatnonzero(d <= 0.10).tolist()) <= ids,
              f"10c closeness {i} missed a candidate within eps")
        check(ids.isdisjoint(np.flatnonzero(d >= 0.30).tolist()),
              f"10c closeness {i} labeled a far candidate close")
    check(sv["stream_ok"] and sv["stopped_last_poll"], "10c: the anytime stream or stop differs")
    for rk in ranks:
        sr = rk["serving"]
        _check_per_round(sr["launches"], sr["rounds"], 1, f"10c rank {rk['rank']}")

    def per_round(rk, name, rounds):
        m = rk[name]
        return dict(launches_per_round={k: v / rounds for k, v in m["launches"].items() if v},
                    collective_ms_per_round=m["collective_s"] * 1e3 / rounds,
                    collectives_per_round=m["collective_calls"] / rounds,
                    collective_kb_per_round=m["collective_bytes"] / 1e3 / rounds)

    out = dict(
        seconds=time.perf_counter() - t_phase, share_s=share_s, ranks_s=ranks_s,
        rank_startup_s=[rk["entered_at"] - spawned_at for rk in ranks],
        rank_startup_steps_s=[{k: v - spawned_at for k, v in rk["startup"].items()}
                              for rk in ranks],
        ranks_shutdown_s=spawned_at + ranks_s - max(rk["done_at"] for rk in ranks),
        rank_attach_s=[rk["attach_s"] for rk in ranks], rank_total_s=[rk["total_s"] for rk in ranks],
        one_rank_nccl=nccl,
        lockstep=dict(rounds=LOCKSTEP_ROUNDS, bitwise=same_plans, plans_equal=same_plans,
                      retired=got[-1]["retired"], wall_s=r0["lockstep"]["wall_s"],
                      per_rank=[per_round(rk, "lockstep", LOCKSTEP_ROUNDS) for rk in ranks]),
        query=dict(mesh=[4, 1], rounds=q["rounds"], passes=q["passes"], blocks_read=q["blocks_read"],
                   tuples_read=q["tuples_read"], wall_s=r0["query"]["wall_s"],
                   construct_s=[rk["query"]["construct_s"] for rk in ranks],
                   phase4=dict(rounds=ctx["fastmatch"].rounds,
                               blocks_read=ctx["fastmatch"].blocks_read,
                               wall_s=ctx["fastmatch"].wall_time_s),
                   worker_gather_s=r0["query"]["worker_gather_s"],
                   per_rank=[per_round(rk, "query", rk["query"]["rounds"]) for rk in ranks]),
        serving=dict(mesh=[2, 2], rounds=r0["serving"]["rounds"],
                     host_syncs=r0["serving"]["host_syncs"], shared_tuples=r0["serving"]["tuples"],
                     wall_s=r0["serving"]["served_wall_s"],
                     construct_s=[rk["serving"]["construct_s"] for rk in ranks],
                     phase5=dict(rounds=ctx["phase5"]["rounds"], wall_s=ctx["phase5"]["wall_s"],
                                 shared_tuples=int(ctx["phase5"]["cache"][5])),
                     tuples=[r["tuples"] for r in sv["topk"] + sv["close"]],
                     per_rank=[per_round(rk, "serving", rk["serving"]["rounds"]) for rk in ranks]),
        launches=dict(lockstep=r0["lockstep"]["launches"], query=r0["query"]["launches"],
                      serving=r0["serving"]["launches"], one_rank_nccl=nccl["launches"]),
    )
    emit({"check": "mesh", **{k: v for k, v in out.items() if k != "launches"}})
    log(f"phase 10 took {out['seconds']:.1f}s (children {ranks_s:.1f}s)")
    return out


def _le(edge: float) -> str:
    """An edge as the registry's Prometheus text writes it."""
    from repro_torch.obs.registry import _fmt

    return _fmt(edge)


# the taxi keys phase 6 tunes: (Q, metric)
TUNE_KEYS = ((1, "l1"), (8, "l1"), (8, "chi2"), (8, "hellinger"))


def phase_tuner(torch) -> dict:
    """The tuner on the card at the taxi keys, into a scratch plan file
    under build/ (the committed one is never written): every candidate's
    time, and whether each winner is the committed file's, reported, not
    checked (winners inside the margin are noise). Returns the tuner's
    launches and the report."""
    from repro_torch.kernels import autotune, ops

    v_z, v_x = 7548, 24
    committed = autotune.PlanRegistry.load(backend="cuda")
    reg = autotune.PlanRegistry(backend="cuda")
    for kern in ops.KERNELS.values():
        kern.launches = 0
    report = dict(tau={}, ingest={})
    for q, metric in TUNE_KEYS:
        key = autotune.tau_key(v_z, v_x, q, metric=metric)
        plan, timed = autotune.tune_tau(v_z, v_x, q, metric=metric, device="cuda")
        reg.tau[key] = plan
        report["tau"][key] = dict(
            winner=dataclasses.asdict(plan),
            matches_committed=committed.tau.get(key) == plan,
            candidates=[dict(plan=dataclasses.asdict(c), ms=ms * 1e3) for c, ms in timed.items()])
        log(f"tuned {key}: {plan} (committed: {committed.tau.get(key)})")
        for c, ms in sorted(timed.items(), key=lambda kv: kv[1]):
            log(f"  {ms * 1e3:9.4f} ms  {c}")
    key = autotune.ingest_key(v_z, v_x)
    plan, timed = autotune.tune_ingest(v_z, v_x, device="cuda")
    reg.ingest[key] = plan
    report["ingest"][key] = dict(
        winner=dataclasses.asdict(plan), matches_committed=committed.ingest.get(key) == plan,
        candidates=[dict(plan=dataclasses.asdict(c), ms=ms * 1e3) for c, ms in timed.items()])
    log(f"tuned {key}: {plan} (committed: {committed.ingest.get(key)})")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    path = reg.save(ROOT / "build" / "tuned_smoke" / "cuda.json")
    check(autotune.PlanRegistry.load(path=path, backend="cuda").decisions() == reg.decisions(),
          "the tuned plan file does not load back byte-stable")
    check(all(launches[name] > 0 for name in ops.KERNELS if name != "anyactive"),
          f"the tuner did not launch every form of kernels B and C: {launches}")
    emit({"check": "tuner", "launches": launches,
          "matches_committed": {k: v["matches_committed"]
                                for part in report.values() for k, v in part.items()}})
    return dict(launches=launches, report=report)


# kernel name -> (its source, the pallas_call it replaces), and the path
# whose run gives its launches: the first of PATHS that launches it
KERNEL_ROWS = {
    "anyactive": ("src/repro_torch/kernels/csrc/anyactive.cu",
                  "src/repro/kernels/anyactive.py:55"),
    "histogram": ("src/repro_torch/kernels/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:108"),
    "distance_multi": ("src/repro_torch/kernels/csrc/distance.cu",
                       "src/repro/kernels/metrics.py:373"),
    "distance_multi_u16": ("src/repro_torch/kernels/csrc/distance.cu",
                           "src/repro/kernels/metrics.py:373"),
    "distance_wide": ("src/repro_torch/kernels/csrc/distance.cu",
                      "src/repro/kernels/metrics.py:385"),
    "distance_wide_u16": ("src/repro_torch/kernels/csrc/distance.cu",
                          "src/repro/kernels/metrics.py:385"),
}
ALSO_REPLACES = {"anyactive": "src/repro/core/multiquery.py:644-645"}
PATHS = ("fastmatch", "serving", "minute_fastmatch", "minute_fastmatch_lowprec",
         "fastmatch_lowprec", "fixture_wide_u16", "tuner")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuples", type=int, default=400_000_000,
                    help="tuples in the paper-scale datasets of phases 4 and 7 (default 400M)")
    ap.add_argument("--seed", type=int, default=0, help="FastMatch's start-block seed")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    smi = phase_setup(torch)
    timer = DeviceTimer(torch)
    log("phase 2: kernels against their plain versions")
    main_rows = phase_kernels(torch, timer)
    log("phase 3: engine and server on the test fixture, card against CPU")
    ds, blocked = phase_engine_small(torch)
    fixture_wide_u16 = phase_serving_small(torch, ds, blocked)
    del ds, blocked
    full_size = (args.tuples, args.seed) == (400_000_000, 0)
    log(f"phase 4: engine at {args.tuples} tuples")
    scale, ctx = phase_engine_scale(torch, taxi_spec(args.tuples), args.seed,
                                    check_name="engine_scale",
                                    expect=(27, 12_395) if full_size else None)
    log("phase 5: serving 12 queries on the resident table")
    serving = phase_serving(torch, timer, ctx)
    log("phase 8: the I/O, fault and recovery layer on the resident table")
    t = time.perf_counter()
    faults = phase_faults(torch, ctx, expect=(27, 12_395) if full_size else None,
                          expect_quarantine=(2_048, 4) if full_size else None)
    log(f"phase 8 took {time.perf_counter() - t:.1f}s")
    log("phase 9: telemetry on the resident table")
    telemetry = phase_telemetry(torch, timer, ctx)
    log(f"phase 10: the mesh and the data-parallel pump, {MESH_RANKS} gloo ranks on the card")
    mesh = phase_mesh(torch, ctx, seed=args.seed)
    del ctx  # the resident table and the host arrays
    torch.cuda.empty_cache()
    log("phase 6: the tuner at the taxi keys")
    tuner = phase_tuner(torch)
    log(f"phase 7: wide rows, FastMatch at the minute-of-day shape, {args.tuples} tuples")
    wide, _ = phase_engine_scale(torch, minute_spec(args.tuples), args.seed,
                                 check_name="wide_rows",
                                 expect=(53, 27_134) if full_size else None)

    leaked = sorted(m for m in sys.modules if m.startswith("jax") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"the port loaded {leaked}")

    # each path's launches, its counts set to 0 just before it and read just after
    paths = dict(fastmatch=scale["launches"], scan=scale["scan_launches"],
                 serving=serving["launches"],
                 fastmatch_lowprec=scale["lowprec"]["fastmatch"]["launches"],
                 scan_lowprec=scale["lowprec"]["scan"]["launches"],
                 fixture_wide_u16=fixture_wide_u16, tuner=tuner["launches"],
                 minute_fastmatch=wide["launches"], minute_scan=wide["scan_launches"],
                 minute_fastmatch_lowprec=wide["lowprec"]["fastmatch"]["launches"],
                 minute_scan_lowprec=wide["lowprec"]["scan"]["launches"],
                 fault_chaos=faults["chaos"]["launches"],
                 fault_quarantine=faults["quarantine"]["launches"],
                 fault_recovery=faults["recovery"]["launches"],
                 telemetry_on=telemetry["launches"],
                 **{f"mesh_{name}": counts for name, counts in mesh["launches"].items()},
                 **{f"prefetch_{name}": run["launches"]
                    for name, run in faults["prefetch"]["runs"].items()})
    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        path = next((p for p in PATHS if paths[p][name] > 0), None)
        check(path is not None, f"kernel {name} was launched on no path")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=paths[path][name], path=path,
                   launches_by_path={p: counts[name] for p, counts in paths.items()},
                   serving_launches=serving["launches"][name], **main_rows[name])
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        if name == "histogram":
            # the registry's binning: one launch a non-empty histogram read
            row["registry_launches"] = telemetry["registry_read"]["launches"]
            row["registry_shape"] = telemetry["registry_kernel"]
        kernels.append(row)
    for row in kernels:
        check(all(isinstance(row[k], (int, float)) and math.isfinite(row[k])
                  for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")), f"bad row {row}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, device=device, kernels=kernels, scale=scale, serving=serving,
             faults=faults, telemetry=telemetry, mesh=mesh, tuner=tuner["report"],
             wide_rows=wide,
             wall_s=time.perf_counter() - T0), indent=1))
    log(f"all checks passed in {time.perf_counter() - T0:.1f}s")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
