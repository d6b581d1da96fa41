"""FastMatch-driven training data pipeline (the paper as a data-layer
feature of the training framework).

Phase 1 — SELECT: run the FastMatch engine over the corpus blocks
(Z = domain, X = token bucket, target = reference token mix) to find the
top-k domains whose token distribution matches the reference, touching a
sublinear fraction of blocks (Guarantees 1 & 2 at the given eps/delta).

Phase 2 — STREAM: an infinite batch iterator over the selected domains'
blocks, with:
  * deterministic shard ownership: worker w of W owns blocks where
    block_idx % W == w (contiguous ranges in production; modular here so
    a single process can emulate many workers);
  * straggler mitigation by WORK STEALING: a worker that exhausts its
    queue steals unread blocks from the global remainder — statistically
    harmless because blocks of the shuffled layout are exchangeable
    (paper Sec 4.2 Challenge 1);
  * checkpointable cursor state (resume exactly after preemption).

Port of `repro.data.pipeline`. SELECT runs the port's engine on the
card (kernels A, B and C) unless ``device="cpu"``; STREAM is the
reference's numpy code, copied, so its batches are bitwise the
reference's for the same corpus, selection and seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.bitmap import build_block_bitmap
from repro_torch.core.engine import EngineConfig, MatchResult, run_engine
from repro_torch.core.histsim import HistSimParams
from repro_torch.data.corpus import TokenCorpus
from repro_torch.data.layout import BlockedDataset
from repro_torch.io import BlockSource, InMemorySource, PrefetchSource

__all__ = ["SelectionReport", "select_domains", "TokenStream"]


@dataclasses.dataclass
class SelectionReport:
    selected_domains: np.ndarray
    result: MatchResult
    blocks_scanned_frac: float


def corpus_as_blocked(corpus: TokenCorpus) -> BlockedDataset:
    """View the token corpus as the paper's (z, x) blocked dataset."""
    nb, bt = corpus.tokens.shape
    z_blocks = np.repeat(corpus.domains[:, None], bt, axis=1).astype(np.int32)
    x_blocks = corpus.bucket_of(corpus.tokens).astype(np.int32)
    bitmap = build_block_bitmap(z_blocks, corpus.spec.num_domains)
    return BlockedDataset(
        z_blocks=z_blocks,
        x_blocks=x_blocks,
        bitmap=bitmap,
        v_z=corpus.spec.num_domains,
        v_x=corpus.spec.num_buckets,
    )


def select_domains(
    corpus: TokenCorpus,
    *,
    k: int = 8,
    eps: float = 0.06,
    delta: float = 0.01,
    lookahead: int = 256,
    seed: int = 0,
    poll_every: int = 1,
    prefetch: bool = False,
    source: Optional[BlockSource] = None,
    device=None,
) -> SelectionReport:
    """Phase-1 SELECT through the engine's `BlockSource` I/O layer.

    ``source`` overrides where block data comes from (default: the
    corpus view wrapped in `InMemorySource`, resident on ``device``);
    ``prefetch`` adds the double-buffered background gather;
    ``poll_every`` is the engine's device-poll cadence. The engine runs
    on ``device``: the card unless "cpu" is asked for (a given source
    must lie there).
    """
    if source is None:
        source = InMemorySource(corpus_as_blocked(corpus), device=device)
    if prefetch and not isinstance(source, PrefetchSource):
        source = PrefetchSource(source)
    params = HistSimParams(
        v_z=corpus.spec.num_domains, v_x=corpus.spec.num_buckets, k=k, eps=eps, delta=delta
    )
    res = run_engine(
        source,
        corpus.reference,
        params,
        EngineConfig(
            variant="fastmatch", lookahead=lookahead, seed=seed, poll_every=poll_every
        ),
        device=device,
    )
    return SelectionReport(
        selected_domains=res.ids,
        result=res,
        blocks_scanned_frac=res.blocks_read / source.num_blocks,
    )


@dataclasses.dataclass
class StreamState:
    """Checkpointable cursor (resume-exact after preemption)."""

    epoch: int = 0
    cursor: int = 0  # index into this worker's permuted block list
    stolen: int = 0


class TokenStream:
    """Batched (B, S) token iterator over selected domains' blocks."""

    def __init__(
        self,
        corpus: TokenCorpus,
        selected_domains: np.ndarray,
        *,
        batch_size: int,
        seq_len: int,
        worker: int = 0,
        num_workers: int = 1,
        seed: int = 0,
        state: Optional[StreamState] = None,
    ):
        self.corpus = corpus
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.worker = worker
        self.num_workers = num_workers
        self.seed = seed
        sel = np.isin(corpus.domains, selected_domains)
        all_blocks = np.where(sel)[0]
        self.owned = all_blocks[all_blocks % num_workers == worker]
        self.others = all_blocks[all_blocks % num_workers != worker]
        if self.owned.size == 0:
            raise ValueError("worker owns no blocks; reduce num_workers")
        self.state = state or StreamState()
        self._reshuffle()

    def _reshuffle(self):
        rng = np.random.default_rng((self.seed, self.worker, self.state.epoch))
        self._order = rng.permutation(self.owned)
        # Stolen blocks come WITHOUT replacement from a per-epoch seeded
        # permutation of the remainder — drawing each steal independently
        # could hand the same block to this worker twice in one epoch.
        steal_rng = np.random.default_rng((self.seed, self.worker, self.state.epoch, 1))
        self._steal_order = steal_rng.permutation(self.others)

    def _next_block(self) -> np.ndarray:
        if self.state.cursor >= self._order.size:
            # work stealing first (emulated: walk a permutation of other
            # workers' pools), then wrap to a new epoch.
            if self.state.stolen < self.others.size // max(self.num_workers, 1):
                blk = self._steal_order[self.state.stolen]
                self.state.stolen += 1
                return self.corpus.tokens[blk]
            self.state.epoch += 1
            self.state.cursor = 0
            self.state.stolen = 0
            self._reshuffle()
        blk = self._order[self.state.cursor]
        self.state.cursor += 1
        return self.corpus.tokens[blk]

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        need = self.batch_size * self.seq_len
        buf = []
        have = 0
        while have < need:
            blk = self._next_block()
            buf.append(blk)
            have += blk.size
        flat = np.concatenate(buf)[:need]
        return {"tokens": flat.reshape(self.batch_size, self.seq_len).astype(np.int32)}
