"""Data-parallel pump: each mesh worker's `ShardedSource` stream feeding
the explicit-collective round.

Port of `repro.core.pump`. The paper's speedup rests on many block
samplers feeding one statistics engine (FastMatch Sec 5).
`DistributedPump` is a `SharedCountsScheduler` whose sampling side is
data-parallel: on a `torch.distributed` mesh every rank runs this host
loop, and the rank of worker w (its index over ``data_axes``) reads only
the blocks of w's contiguous global-id range.

  SharedCountsScheduler(mesh=...)
      One global block stream, read by every rank; the counts
      candidate-sharded over the model axis (`MatchServer(mesh=...)`).

  DistributedPump (``MatchServer(mesh=..., pump=True)``)
      Each round every worker takes the next lookahead window of its own
      range from the shared cyclic visit order, and
      `distributed.make_pump_round` runs mark (kernel A, against the
      replicated union words and the worker's read-mask slice) + masked
      ingest (kernel B, the worker's samples restricted to the rank's
      model rows) + the stats (kernel C on the shard's rows) + the read
      bookkeeping.

Collectives a round: one all-reduce over the data group of the (counts
delta, row-sum delta, 3 counter increments) buffer, and one over the
model group of the (Q + 1, V_Z) tau and n (see
`repro_torch.core.distributed`); a poll adds one all-reduce over every
rank (`SharedCountsScheduler._exchange`: the read-mask slices, n, rank
0's clock, the workers' quarantine verdicts and gather times). Window
bytes never leave their worker.

Golden contract: driven with the same global windows, a pump round
equals the single-stream `fused_round` bit for bit (counts, n, tau,
bounds, read mask, counters) for any mesh shape where the shard
resolves the full matrix's kernel plan, admission and retirement
included. The host loop (passes, poll_every, exact completion, warm
snapshots) is the scheduler's; `export_cache` and `import_cache`
convert between the sliced, padded read mask and the global
`CacheSnapshot`, so snapshots move between pump widths, the
single-stream scheduler and the reference's files.

A worker whose stream ends short of the pass's rounds (a
`ResilientSource` skips a quarantined window) runs empty windows to the
end of the pass, so every rank dispatches the same rounds.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core.multiquery import MultiQuerySpec, SampleCursor, SharedCountsScheduler
from repro_torch.data.layout import BlockedDataset
from repro_torch.io import InMemorySource, PrefetchSource, ShardedSource, WindowData

__all__ = ["DistributedPump"]


class DistributedPump(SharedCountsScheduler):
    """Data-parallel `SharedCountsScheduler`: this rank's worker reads its
    own block range and feeds the pump round.

    Takes the raw `BlockedDataset` (an opaque `BlockSource` cannot be
    split by block ownership) and builds the `ShardedSource` of this
    rank's worker, resident on the mesh's device; with ``prefetch=True``
    the shard stays in host memory behind a `PrefetchSource`, which
    stages each next window while the current round runs. The
    scheduler's own source is the whole dataset in host memory (the
    config-hash probe, accounting). ``host_syncs`` / ``loop_syncs`` count
    the mesh-wide polls. Construction raises without an initialised
    process group.
    """

    def __init__(
        self,
        dataset: BlockedDataset,
        spec: MultiQuerySpec,
        *,
        mesh,
        data_axes=("data",),
        model_axis: str = "model",
        policy: str = "anyactive",
        window: int = 512,
        seed: int = 0,
        start_block: Optional[int] = None,
        poll_every: int = 1,
        prefetch: bool = False,
        histogram_impl: str = "auto",
        onehot_dtype=torch.float32,
        telemetry=None,
        plans=None,
    ):
        if not isinstance(dataset, BlockedDataset):
            raise TypeError(
                "DistributedPump shards the raw BlockedDataset per worker; "
                f"got {type(dataset)!r} (wrap sources only in single-stream mode)"
            )
        self.data_axes = tuple(data_axes)
        axes = distributed.mesh_axes(mesh, self.data_axes, model_axis)
        self.num_workers = axes.num_workers
        nb = dataset.num_blocks
        # ShardedSource's ceil-division ranges; the sliced read mask is
        # padded to the full worker grid (the tail ids are in no window)
        self._blocks_per_worker = -(-nb // self.num_workers)
        self._padded_num_blocks = self._blocks_per_worker * self.num_workers
        self._ranges = [
            (w * self._blocks_per_worker, min((w + 1) * self._blocks_per_worker, nb))
            for w in range(self.num_workers)
        ]
        if any(hi <= lo for lo, hi in self._ranges):
            raise ValueError(
                f"{self.num_workers} workers over {nb} blocks leaves a worker "
                "with no blocks; use fewer workers (or more blocks)"
            )
        self.worker = axes.worker
        self.shard = ShardedSource(
            dataset, self.num_workers, self.worker, device_resident=not prefetch,
            device=axes.device,
        )
        self._stream_source = (
            PrefetchSource(self.shard, telemetry=telemetry) if prefetch else self.shard
        )
        self._assemble_s = 0.0
        super().__init__(
            InMemorySource(dataset, device_resident=False, device=axes.device),
            spec,
            policy=policy,
            window=window,
            seed=seed,
            start_block=start_block,
            poll_every=poll_every,
            mesh=mesh,
            model_axis=model_axis,
            telemetry=telemetry,
            plans=plans,
        )
        self._build_mesh_rounds(histogram_impl, onehot_dtype)

    # -- cursor placement / snapshot layout ---------------------------------

    def _place_cursor(self, cursor: SampleCursor) -> SampleCursor:
        """Pad the global read mask to the worker grid and keep this
        worker's slice; the counters stay whole (mesh-wide totals)."""
        mask = torch.zeros(self._padded_num_blocks, dtype=torch.bool, device=self.device)
        mask[: cursor.read_mask.shape[0]] = cursor.read_mask.to(self.device)
        placed = distributed.cursor_pspecs(self.data_axes).read_mask
        return cursor._replace(read_mask=distributed.place_leaf(mask, placed, self.mesh))

    def _global_read_mask(self) -> torch.Tensor:
        """Gather the sliced mask (the poll's exchange; every rank calls
        it) and strip the worker-grid padding."""
        raw = self._exchange().cpu().numpy()
        shared = self._take_shared(raw)
        return torch.from_numpy(shared["read_mask"].copy()).to(self.device)

    def _quarantine_sources(self) -> tuple:
        """This rank's worker stream too: a `ResilientSource` under it
        quarantines global block ids (`ShardedSource` speaks global), so
        the scheduler's bookkeeping applies as it is, and the poll shares
        the verdicts of every worker."""
        return (self.source, self._stream_source)

    # -- data-parallel window plumbing ---------------------------------------

    def _plan_pass(self, pass_order: np.ndarray) -> tuple:
        """(every worker's window list, rounds): the visit order restricted
        to each worker's id range, cut into lookahead windows and aligned
        to one length with empty windows (a worker whose share ran out
        marks nothing)."""
        per = [pass_order[(pass_order >= lo) & (pass_order < hi)] for lo, hi in self._ranges]
        n_rounds = max(-(-p.size // self.window) for p in per)
        return (
            [
                [p[r * self.window : (r + 1) * self.window] for r in range(n_rounds)]
                for p in per
            ],
            n_rounds,
        )

    def _assemble(self, wd: WindowData) -> WindowData:
        """This worker's window on the rank's device: the one host-to-device
        move of a host-resident shard's window, nothing for a resident
        one. (The reference stacks the W windows here; each rank holds
        only its own.)"""
        return self._on_device(wd)

    def _open_pass_stream(self, pass_order: np.ndarray) -> tuple:
        wins, n_rounds = self._plan_pass(pass_order)
        mine = wins[self.worker]
        empty = np.zeros(0, np.int64)

        def rounds():
            stream = self._stream_source.stream(mine, pad_to=self.window)
            timed = self.telemetry is not None
            try:
                for _ in range(n_rounds):
                    t0 = time.perf_counter()
                    try:
                        wd = next(stream)
                    except StopIteration:
                        # a quarantined window was skipped: every rank runs
                        # the pass's rounds, so fill with empty windows
                        wd = self.shard.fetch(empty, pad_to=self.window)
                    if timed:
                        t1 = time.perf_counter()
                        self._worker_gather_s[0] += t1 - t0
                        wd = self._assemble(wd)
                        self._assemble_s += time.perf_counter() - t1
                    else:
                        wd = self._assemble(wd)
                    yield wd
            finally:
                stream.close()

        return rounds(), n_rounds

    def _round_batch_extra(self) -> dict:
        """Every worker's gather seconds since the last poll (shared by the
        poll's exchange) and this rank's assemble seconds."""
        extra = {
            "worker_gather_s": [float(s) for s in self._shared_gather_s],
            "assemble_s": float(self._assemble_s),
        }
        self._shared_gather_s[:] = 0.0
        self._assemble_s = 0.0
        return extra

    def _fetch_window(self, win: np.ndarray) -> WindowData:
        """An ad-hoc global window (`MatchServer.step`, `run_window`): this
        worker's share of it, padded to the largest share, so one pump
        round serves the window however it straddles the workers."""
        win = np.asarray(win, np.int64).ravel()
        sizes = [int(((win >= lo) & (win < hi)).sum()) for lo, hi in self._ranges]
        pad = max(self.window, max(sizes))
        return self._assemble(self.shard.fetch(self.shard.owned(win), pad_to=pad))

