"""Telemetry for the FastMatch serving stack: what each signal measures.

Port of `repro.obs`. FastMatch's claims are rate claims: tuples drawn a
query, rounds to retirement, speedup at equal recall (paper Sec 5-6).
This package measures them while serving: a `MetricsRegistry` of
counters, gauges and latency histograms with Prometheus-text and JSON
exports, a `Tracer` that keeps each query's lifecycle and each poll's
round batch in a bounded ring with a JSONL sink, and per-query
tuples-to-confidence trajectories (`Telemetry`).

Everything is recorded at the host polls that the scheduler makes
anyway (`SharedCountsScheduler._sync` already copies tau, n and the
bounds back at every poll for the anytime answers): telemetry adds no
device work, no copy and no launch to a round, and a run with telemetry
on is bitwise the run with it off (tests/test_torch_obs.py). The one
device call is the registry's binning, kernel B at V_Z = 1, made when a
reader asks for a histogram (`Histogram._flush`), never while serving.

Metric <-> paper quantity
=========================

Registry metrics (``MatchServer(telemetry=True)``):

  fastmatch_tuples_read_total      — m, the samples drawn: the sample
                                     complexity Theorem 1 bounds and the
                                     speedups of Fig. 6 / Table 4 count
  fastmatch_blocks_read_total      — block reads of the Sec 4.2 bitmap
                                     I/O manager (the unit AnyActive
                                     decides on)
  fastmatch_rounds_total           — statistics-engine iterations
                                     (windows dispatched): the x-axis of
                                     Fig. 5's per-round view of HistSim
  fastmatch_host_syncs_total       — device -> host polls: the cost of
                                     asynchrony that the Sec 4.2
                                     relaxation (and poll_every) amortizes
  fastmatch_passes_total           — cyclic passes over the block layout
  fastmatch_queries_submitted_total/_admitted_total/_retired_total
                                   — the query population the server
                                     multiplexes onto one stream
  fastmatch_blocks_quarantined_total
                                   — blocks dropped from the probe set
                                     by an I/O quarantine (the q of
                                     eps + 2q)
  fastmatch_query_tuples           — histogram of each query's tuples
                                     drawn while live: the per-query m
                                     whose 1/N sharing is the serving win
  fastmatch_query_rounds           — histogram of rounds to retirement
                                     (Fig. 5: rounds HistSim needs
                                     before delta_upper crosses delta)
  fastmatch_query_wall_seconds     — admit -> retire latency (the
                                     interactivity budget of Sec 1)
  fastmatch_round_batch_seconds    — host wall a poll's round batch
                                     (gather + dispatch + sync)
  prefetch_wait_seconds            — consumer stalls waiting on the
                                     sampling engine: Sec 4.2's "must
                                     never stall the statistics engine",
                                     measured (0 wait: fully hidden)
  prefetch_fetch_seconds           — producer-side fetch (and staging)
                                     cost the double buffer hides
  prefetch_queue_depth             — staged windows at the last hand-off
  prefetch_worker_errors_total / prefetch_join_timeouts_total /
  prefetch_dropped_errors_total    — the prefetch warnings, as counters
  io_fetch_retries_total / io_transient_faults_total /
  io_permanent_faults_total / io_validation_failures_total /
  io_blocks_quarantined_total      — the resilient source's fault
                                     accounting
  checkpoint_save_seconds / checkpoint_save_bytes_total /
  checkpoint_saves_total / checkpoint_save_failures_total /
  checkpoint_gc_swept_total / checkpoint_corrupt_steps_total
                                   — the warm cache's persistence cost
                                     and hygiene
  serve_crashes_total / serve_recoveries_total /
  serve_queries_shed_total / serve_recovery_seconds
                                   — the supervisor's liveness decisions

Confidence-trajectory columns (`Telemetry.confidence_curve`):

  tuples        — m so far (shared; ``tuples_live``: charged to the query)
  n_min         — min_i n_i: the worst-sampled candidate, the binding
                  term of every per-candidate Theorem 1 bound
  eps_n         — Theorem 1 eps(n_min) at the per-candidate budget
                  delta / |V_Z| (the AnyActive threshold of Sec 4.2),
                  through the metric's budget inverse: the deviation
                  guaranteed for the worst-sampled candidate
  tau_min       — the running distance estimate of the current best
                  candidate (Alg. 1's tau_i for the head of M)
  delta_upper   — sum_i delta_i, the stats tail's failure bound
                  (Alg. 1 line 6 stops on delta_upper < delta)
  confidence    — 1 - delta_upper: the guarantee level a client could be
                  handed mid-query

Trace events (`Tracer`, JSONL): ``query_enqueue`` -> ``query_admit`` ->
``round_batch``* (windows, gather / dispatch / sync wall) ->
``query_retire`` -> ``query_done`` (the rid <-> qid join, emitted by
`MatchServer`); beside them ``pass_start``, ``exact_completion``,
``budget_exhausted``, ``blocks_quarantine``, ``window_quarantine``,
``checkpoint_save``, ``checkpoint_gc``, ``checkpoint_corrupt``,
``prefetch_stream``, ``prefetch_worker_error``, ``prefetch_join_timeout``,
``prefetch_dropped_error``, ``serve_crash``, ``serve_recovered``,
``query_shed`` and ``query_deadline_retire``. The skeleton (timing fields
stripped) is deterministic for a seeded workload and equal to the
reference's for the same workload: the golden span-tree contract.
"""

from repro_torch.obs.registry import (
    DEFAULT_LATENCY_BINS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.telemetry import CURVE_COLUMNS, Telemetry
from repro_torch.obs.tracer import TIMING_FIELDS, Tracer

__all__ = [
    "CURVE_COLUMNS",
    "Counter",
    "DEFAULT_LATENCY_BINS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TIMING_FIELDS",
    "Telemetry",
    "Tracer",
]
