"""Block sources — where the sampling loop's window data comes from.

Port of `repro.io.block_source` (`BlockSource`, `WindowData`,
`InMemorySource`, `as_block_source`). A source serves fixed-shape
windows of blocked (z, x) tuples plus their packed presence bitmap rows
(or, for a device-resident source, the bitmap table the rows are read
from). Every window is padded to one length (``pad_to``) and padded
rows carry ``valid=False``, so the round masks them out of marking,
ingest and the read bookkeeping. Padding repeats block id 0 with no
effect.

A device-resident source's `stream` serves a whole pass: it moves the
pass's padded window indices to the device in one copy, so the loop
issues no host-to-device copy per window (a copy from pageable host
memory would wait for the device). A host-resident source hands its
windows over in host memory; the scheduler moves each to its device
once, or a `PrefetchSource` stages it there ahead of the round.

`ShardedSource` is one data-parallel worker's contiguous block range
(`BlockedDataset.shard`) behind the same interface: it speaks global
block ids, and `owned(win)` filters a global window to its range. Its
device-resident windows hand over the shard's bitmap table, whose row
for global id ``i`` is ``i - id_base``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.layout import BlockedDataset

__all__ = ["BlockSource", "InMemorySource", "ShardedSource", "WindowData", "as_block_source"]


class WindowData(NamedTuple):
    """One padded lookahead window of block data, on the round's device.

    ``bitmap`` is either the window's (L, W) presence rows, gathered, or
    (``bitmap_by_id``) the source's whole (num_blocks, W) table, whose
    rows the marking kernel reads in place through ``indices``; a shard's
    table starts at block ``id_base`` (0 for a whole-dataset source).
    """

    indices: torch.Tensor  # (L,) int64 global block ids (padding repeats id 0)
    z: torch.Tensor  # (L, B) int32 candidate ids, -1 padded within blocks
    x: torch.Tensor  # (L, B) int32 attribute values, -1 padded
    bitmap: torch.Tensor  # (L, W) or (num_blocks, W) int32 packed presence rows (uint32 bits)
    valid: torch.Tensor  # (L,) bool — False on window padding rows
    bitmap_by_id: bool = False  # bitmap is the whole table, indexed by `indices`
    id_base: int = 0  # global id of the by-id table's first row

    def bitmap_rows(self) -> torch.Tensor:
        """(L, W) the window's presence rows (a gather from the table
        when ``bitmap_by_id``)."""
        if not self.bitmap_by_id:
            return self.bitmap
        return self.bitmap[self.indices - self.id_base if self.id_base else self.indices]


@runtime_checkable
class BlockSource(Protocol):
    """What the sampling loop needs from an I/O backend. A source may
    also name the ``device`` its rounds run on."""

    num_blocks: int
    block_size: int
    v_z: int
    v_x: int
    tuples_per_block: np.ndarray  # (num_blocks,) host-side, for accounting

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData: ...

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]: ...


def _pad_windows(windows: list, pad_to: Optional[int]) -> tuple:
    """(num_windows, L) int64 block ids and bool validity, host-side."""
    sizes = [np.asarray(w).size for w in windows]
    length = pad_to if pad_to is not None else max(sizes, default=0)
    idx = np.zeros((len(windows), length), np.int64)
    valid = np.zeros((len(windows), length), bool)
    for i, (win, size) in enumerate(zip(windows, sizes)):
        if size > length:
            raise ValueError(f"window of {size} blocks exceeds pad_to={length}")
        idx[i, :size] = np.asarray(win).ravel()
        valid[i, :size] = True
    return idx, valid


class InMemorySource:
    """The whole blocked dataset behind the source interface.

    ``device_resident=True`` (default) keeps the blocks and the bitmap on
    ``device``: a window gathers its blocks on the device and hands the
    marking the whole bitmap table with the window's ids, so no bitmap
    row is copied. With ``device_resident=False`` they stay in host
    memory (a stand-in for disk or a remote store) and each window,
    bitmap rows included, is gathered on the host and handed over there:
    the scheduler moves it to ``device`` once, or a `PrefetchSource`
    stages it there ahead of the round.
    """

    def __init__(self, dataset: BlockedDataset, *, device_resident: bool = True, device=None):
        self.device = resolve_device(device)
        self.num_blocks = dataset.num_blocks
        self.block_size = dataset.block_size
        self.v_z = dataset.v_z
        self.v_x = dataset.v_x
        self.tuples_per_block = (dataset.z_blocks >= 0).sum(axis=1)
        self.device_resident = device_resident
        z = np.ascontiguousarray(dataset.z_blocks, np.int32)
        x = np.ascontiguousarray(dataset.x_blocks, np.int32)
        bitmap = np.ascontiguousarray(dataset.bitmap, np.uint32).view(np.int32)
        if device_resident:
            self._z = torch.from_numpy(z).to(self.device)
            self._x = torch.from_numpy(x).to(self.device)
            self._bitmap = torch.from_numpy(bitmap).to(self.device)
        else:
            self._z, self._x, self._bitmap = z, x, bitmap

    def _gather(self, idx: torch.Tensor, valid: torch.Tensor) -> WindowData:
        if self.device_resident:
            return WindowData(idx, self._z[idx], self._x[idx], self._bitmap, valid,
                              bitmap_by_id=True)
        host = idx.numpy()
        z, x, bitmap = (torch.from_numpy(a[host]) for a in (self._z, self._x, self._bitmap))
        return WindowData(idx, z, x, bitmap, valid)

    def _place(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.to(self.device) if self.device_resident else t

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        """One window, padded to ``pad_to`` blocks."""
        idx, valid = _pad_windows([win], pad_to)
        return self._gather(self._place(idx[0]), self._place(valid[0]))

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        """The windows of one pass, in order; one index copy for all."""
        windows = list(windows)
        if not windows:
            return
        idx, valid = _pad_windows(windows, pad_to)
        idx, valid = self._place(idx), self._place(valid)
        for i in range(len(windows)):
            yield self._gather(idx[i], valid[i])


class ShardedSource(InMemorySource):
    """One data-parallel worker's contiguous block range.

    Built on `BlockedDataset.shard`; callers keep speaking global block
    ids (one read mask and visit order span the mesh) and the source
    translates them to its range ``[lo, hi)``. `owned(win)` filters a
    global window to this worker's share. It feeds the data-parallel
    rounds of `repro_torch.core.distributed` and `DistributedPump`; it is
    not a dataset for `SharedCountsScheduler`, whose visit order starts at
    block 0 over the whole dataset (the scheduler refuses it).
    """

    def __init__(
        self,
        dataset: BlockedDataset,
        num_shards: int,
        shard_id: int,
        *,
        device_resident: bool = True,
        device=None,
    ):
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"need 0 <= shard_id < num_shards, got {shard_id}/{num_shards}")
        shard = dataset.shard(num_shards, shard_id)
        super().__init__(shard, device_resident=device_resident, device=device)
        per = -(-dataset.num_blocks // num_shards)
        self.lo = shard_id * per
        self.hi = self.lo + shard.num_blocks
        self.global_num_blocks = dataset.num_blocks

    def owned(self, win: np.ndarray) -> np.ndarray:
        """The ids of ``win`` in this worker's range, in window order."""
        win = np.asarray(win, np.int64).ravel()
        return win[(win >= self.lo) & (win < self.hi)]

    def _check(self, win) -> np.ndarray:
        win = np.asarray(win, np.int64).ravel()
        if win.size and ((win < self.lo) | (win >= self.hi)).any():
            raise ValueError(
                f"block ids outside shard range [{self.lo}, {self.hi}); filter with owned()"
            )
        return win - self.lo

    def _globalize(self, wd: WindowData) -> WindowData:
        return wd._replace(
            indices=wd.indices + self.lo, id_base=self.lo if wd.bitmap_by_id else 0
        )

    def fetch(self, win: np.ndarray, pad_to: Optional[int] = None) -> WindowData:
        return self._globalize(super().fetch(self._check(win), pad_to))

    def stream(
        self, windows: Iterable[np.ndarray], pad_to: Optional[int] = None
    ) -> Iterator[WindowData]:
        local = [self._check(w) for w in windows]
        for wd in super().stream(local, pad_to):
            yield self._globalize(wd)


def as_block_source(data, *, device=None) -> BlockSource:
    """BlockedDataset -> InMemorySource on ``device``; any `BlockSource`
    passes through (one that names its device must name ``device`` when
    one is given)."""
    if isinstance(data, BlockedDataset):
        return InMemorySource(data, device=device)
    if isinstance(data, BlockSource):
        have = getattr(data, "device", None)
        if device is not None and have is not None and resolve_device(device) != have:
            raise ValueError(f"source lies on {have}, asked for {device}")
        return data
    raise TypeError(f"expected BlockedDataset or BlockSource, got {type(data)!r}")
