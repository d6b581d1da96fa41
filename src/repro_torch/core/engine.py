"""The FastMatch engine: HistSim + block policies + lookahead staleness.

Port of `repro.core.engine`. `run_engine` answers one top-k query; it is
the ``max_queries=1`` case of `multiquery.SharedCountsScheduler`, whose
`fused_round` marks a lookahead window with AnyActive (kernel A),
ingests the marked blocks (kernel B) and runs the statistics (kernel C
plus the deviation assignment) on the device, polling the host every
``poll_every`` windows.

Variants (paper Sec 5.2) are configuration points of the one loop:

  variant     policy      lookahead   stats cadence        criterion
  ---------   ---------   ---------   ------------------   ---------
  fastmatch   anyactive   L (512)     once per window      histsim
  syncmatch   anyactive   1           once per block       histsim
  scanmatch   scan        L           once per window      histsim
  slowmatch   scan        L           once per window      slowmatch
  scan        scan        —           exact full pass      —

Sampling is without replacement from a random start in the pre-shuffled
layout. If a whole pass reads nothing and HistSim has not terminated,
the engine completes exactly; the Scan baseline is that completion on a
fresh scheduler. ``prefetch=True`` wraps the source in a
`PrefetchSource`, which fetches the next window on a worker thread while
the current round runs. The engine runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.histsim import HistSimParams, HistSimState
from repro_torch.core.multiquery import MultiQuerySpec, QueryOutcome, SharedCountsScheduler
from repro_torch.io import PrefetchSource, as_block_source

__all__ = ["EngineConfig", "MatchResult", "run_engine", "VARIANTS"]

VARIANTS = ("fastmatch", "syncmatch", "scanmatch", "slowmatch", "scan")

# The Scan baseline reads the heap in big sequential chunks: 4096 blocks
# of 512 tuples is ~2M tuples per ingest launch.
_SCAN_CHUNK_BLOCKS = 4096


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    variant: str = "fastmatch"
    lookahead: int = 512
    seed: int = 0
    max_rounds: int = 1_000_000
    max_passes: int = 4
    start_block: Optional[int] = None  # None -> random
    # poll termination/counters every this many windows (1 = per window)
    poll_every: int = 1
    # background double-buffered block fetch (`PrefetchSource`)
    prefetch: bool = False

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.poll_every < 1:
            raise ValueError(f"need poll_every >= 1, got {self.poll_every}")

    @property
    def policy(self) -> str:
        return "anyactive" if self.variant in ("fastmatch", "syncmatch") else "scan"

    @property
    def window(self) -> int:
        return 1 if self.variant == "syncmatch" else self.lookahead

    @property
    def criterion(self) -> str:
        return "slowmatch" if self.variant == "slowmatch" else "histsim"


@dataclasses.dataclass
class MatchResult:
    ids: np.ndarray  # (k,) matching candidate ids, closest first
    state: HistSimState
    rounds: int
    blocks_read: int
    blocks_considered: int
    tuples_read: int
    wall_time_s: float
    exact: bool  # True iff the answer rests on a COMPLETE read of the data
    passes: int
    host_syncs: int = 0  # device->host polls the scheduler made for this run
    # I/O degradation (see QueryOutcome): with blocks quarantined,
    # ``exact`` means complete over the surviving blocks and
    # ``eps_effective`` is the widened bound against the full data
    degraded: bool = False
    eps_effective: float = float("nan")
    # "topk" (ids = the k matches) or "closeness" (ids = every candidate
    # labeled close, tau order)
    qtype: str = "topk"
    # SLA early stop (multiquery.StopPolicy): the result is the anytime
    # answer of the stopping poll (exact=False, achieved delta_upper)
    stopped: bool = False
    stop_reason: str = ""  # "confidence" | "tuples" | "wall_ms"

    @property
    def delta_upper(self) -> float:
        return float(self.state.delta_upper)


def _to_match_result(out: QueryOutcome, t0: float, sched: SharedCountsScheduler) -> MatchResult:
    return MatchResult(
        ids=out.ids,
        state=out.state,
        rounds=out.rounds,
        blocks_read=out.blocks_read,
        blocks_considered=out.blocks_considered,
        tuples_read=out.tuples_read,
        wall_time_s=time.perf_counter() - t0,
        exact=out.exact,
        passes=out.passes,
        host_syncs=sched.host_syncs,
        degraded=out.degraded,
        eps_effective=out.eps_effective,
        qtype=out.qtype,
        stopped=out.stopped,
        stop_reason=out.stop_reason,
    )


def run_engine(
    dataset,
    target: np.ndarray,
    params: HistSimParams,
    config: EngineConfig = EngineConfig(),
    *,
    device=None,
) -> MatchResult:
    """Run one matching query to termination. Returns the top-k + stats.

    ``dataset`` is a `BlockedDataset` (moved to ``device``, CUDA unless
    ``"cpu"`` is asked for) or any `BlockSource`. ``exact`` is True iff
    the answer rests on a complete read; a ``max_rounds`` budget cut
    returns the sampled answer with ``exact=False``.
    """
    source = as_block_source(dataset, device=device)
    if params.v_z != source.v_z or params.v_x != source.v_x:
        raise ValueError("params/dataset dimension mismatch")
    if config.prefetch and not isinstance(source, PrefetchSource):
        source = PrefetchSource(source)
    if config.criterion != params.criterion:
        params = dataclasses.replace(params, criterion=config.criterion)

    t0 = time.perf_counter()
    spec = MultiQuerySpec(
        v_z=params.v_z, v_x=params.v_x, max_queries=1, criterion=params.criterion,
        k_cap=params.k,
    )

    if config.variant == "scan":
        # the exact-completion path of the one loop on a fresh scheduler
        sched = SharedCountsScheduler(
            source, spec, policy="scan", window=_SCAN_CHUNK_BLOCKS, seed=config.seed,
            start_block=0,
        )
        sched.admit(target, k=params.k, eps=params.eps, delta=params.delta)
        sched.complete_remaining()
        fired = bool(sched._delta_upper[0] < params.delta)
        out = sched.retire(0, exact=True, terminated=fired)
        return _to_match_result(out, t0, sched)

    sched = SharedCountsScheduler(
        source,
        spec,
        policy=config.policy,
        window=config.window,
        seed=config.seed,
        start_block=config.start_block,
        poll_every=config.poll_every,
    )
    qid = sched.admit(target, k=params.k, eps=params.eps, delta=params.delta)
    sched.pump(max_rounds=config.max_rounds, max_passes=config.max_passes)
    if qid not in sched.outcomes:
        # max_rounds budget cut: best-effort sampled answer, NOT exact
        out = sched.retire(0, exact=False, terminated=False)
    else:
        out = sched.outcomes[qid]
    return _to_match_result(out, t0, sched)
