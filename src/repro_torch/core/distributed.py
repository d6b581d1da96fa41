"""Mesh HistSim on `torch.distributed`: the multi-query round with the
counts candidate-sharded and the samples data-parallel.

Port of `repro.core.distributed`. The reference is one JAX program over
a ("pod", "data", "model") mesh under ``shard_map``; here every rank is
a process that runs the same host loop, the mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose dim names are the
reference's axes, and each axis's process group stands for a
``shard_map`` axis. Every function below runs on this rank's local
tensors; nothing is a DTensor (the kernels take local tensors).

  corpus blocks — range-sharded over the data axes: worker w owns the
                  contiguous global ids [w * per, (w + 1) * per)
                  (`repro_torch.io.ShardedSource`) and reads only those
  counts        — candidate-sharded over the model axis: model rank m
                  holds rows [m * V_Z/|model|, (m + 1) * V_Z/|model|) of
                  the shared counts and of n
  per round     — each rank histograms its worker's marked samples,
                  restricted to its model rows, into zeros (kernel B);
                  ONE all-reduce over the data group (one a data axis
                  over ("pod", "data")) sums the flat buffer (counts
                  delta, row-sum delta, counter increments), which is
                  then added to the state: every
                  value is an integer-valued f32 below 2^24, so the sum
                  is exact in any order
  statistics    — kernel C scores the shard's (V_Z/m, V_X) rows for all
                  Q slots; ONE all-reduce over the model group of a
                  zero-filled (Q + 1, V_Z) buffer, each rank writing its
                  own columns of tau and n (x + 0 = x, so it is a
                  gather), and `multiquery.apply_stats` on the full
                  arrays, replicated on every rank: the single-stream
                  round's code

Collectives a round: the data all-reduce of (V_Z/m) * (V_X + 1) + 3
floats and the model all-reduce of (Q + 1) * V_Z floats, independent of
the samples read; window bytes never leave their worker. A group of one
rank issues no collective (decided when the round is built). Every
collective is an ``all_reduce`` with SUM, the one form both gloo and
NCCL take on CUDA and CPU tensors alike.

The placement trees (`multi_state_pspecs`, `cache_pspecs`,
`cursor_pspecs`, `window_pspecs`) replace the reference's
PartitionSpecs: each leaf is `WHOLE` (every rank holds it) or a
`DimSplit` (sliced along dim 0 over the named axes, DTensor's
``Shard(0)``).

Plans resolve on the shard shapes (V_Z/m, V_X, Q): those are the shapes
the kernels see.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from repro_torch.core.multiquery import (
    CacheSnapshot,
    MultiQuerySpec,
    MultiQueryState,
    SampleCursor,
    apply_stats,
)
from repro_torch.core.policies import mark_window
from repro_torch.io.block_source import WindowData
from repro_torch.kernels import autotune, ops

__all__ = [
    "COLLECTIVES",
    "RANK_STARTUP",
    "DimSplit",
    "MeshAxes",
    "WHOLE",
    "barrier",
    "cache_pspecs",
    "cursor_pspecs",
    "gather_counts",
    "init_mesh",
    "make_distributed_round",
    "make_pump_ingest_round",
    "make_pump_round",
    "make_stats_step",
    "mesh_axes",
    "mesh_device",
    "multi_state_pspecs",
    "place_cache",
    "place_leaf",
    "run_ranks",
    "window_pspecs",
]

# A leaf every rank holds whole.
WHOLE = Replicate()


@dataclasses.dataclass(frozen=True)
class DimSplit:
    """A leaf sliced along dim 0 over the mesh ``axes`` (row-major over
    them, the reference's ``P(axes)``): DTensor's ``Shard(0)`` on them."""

    axes: Tuple[str, ...]


# Host wall and count of the mesh collectives this process issued (the
# rounds' and the polls'); `chip_smoke.py` reads them around a run.
COLLECTIVES = {"calls": 0, "seconds": 0.0, "bytes": 0}


def multi_state_pspecs(model_axis: str = "model") -> MultiQueryState:
    """Placements of `MultiQueryState`: the shared counts and n sliced
    over the model axis, every per-query statistic whole."""
    rows = DimSplit((model_axis,))
    return MultiQueryState(
        **{f: WHOLE for f in MultiQueryState._fields if f not in ("counts", "n")},
        counts=rows,
        n=rows,
    )


def cache_pspecs(model_axis: str = "model") -> CacheSnapshot:
    """Placements of a `CacheSnapshot`: counts and n as the live state
    holds them (from `multi_state_pspecs`, so the two cannot drift), the
    read mask and the bookkeeping whole. A snapshot written under one
    mesh shape restores under another through these
    (`CheckpointManager.restore_resharded`, `place_cache`)."""
    ms = multi_state_pspecs(model_axis)
    return CacheSnapshot(
        counts=ms.counts, n=ms.n, **{f: WHOLE for f in CacheSnapshot._fields[2:]}
    )


def cursor_pspecs(data_axes=("data",)) -> SampleCursor:
    """Placements of the pump's `SampleCursor`: the read mask sliced over
    the data axes (worker w holds the mask of its id range, padded to
    per * num_workers), the counters whole (mesh-wide totals)."""
    return SampleCursor(
        read_mask=DimSplit(tuple(data_axes)),
        **{f: WHOLE for f in SampleCursor._fields[1:]},
    )


def window_pspecs(data_axes=("data",)) -> WindowData:
    """Placements of a pump round's window: each worker's window is its
    own slice of the round's (the reference stacks them on dim 0), the
    same on every model rank of the worker."""
    d = DimSplit(tuple(data_axes))
    return WindowData(indices=d, z=d, x=d, bitmap=d, valid=d)


def init_mesh(shape, names=("data", "model"), *, device_type: str = "cuda"):
    """A `DeviceMesh` of ``shape`` with the reference's axis ``names``
    over the initialised default process group (every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialised torch.distributed process group")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


class MeshAxes:
    """This rank's place on a mesh for one (data axes, model axis) split:
    its worker index over the data axes (row-major in the given order,
    the reference's ``_worker_lo`` fold), its model rank, its replica
    index over the remaining axes, its device, and the process groups of
    its data axes and its model axis (none for an axis of one rank, which
    issues no collective)."""

    def __init__(self, mesh, data_axes=("data",), model_axis: str = "model"):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh round needs an initialised torch.distributed process group "
                "(init_process_group, then a DeviceMesh)"
            )
        names = tuple(mesh.mesh_dim_names or ())
        shape = tuple(mesh.mesh.shape)
        data_axes = tuple(data_axes)
        for ax in data_axes + (model_axis,):
            if ax not in names:
                raise ValueError(f"mesh has no axis {ax!r}; axes are {dict(zip(names, shape))}")
        if model_axis in data_axes or len(set(data_axes)) != len(data_axes):
            raise ValueError(f"data axes {data_axes} and model axis {model_axis!r} must differ")
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(
                f"the mesh spans {mesh.mesh.numel()} ranks, the process group "
                f"{dist.get_world_size()}"
            )
        self.mesh = mesh
        self.names, self.shape = names, shape
        self.data_axes, self.model_axis = data_axes, model_axis
        size = dict(zip(names, shape))
        coord = dict(zip(names, mesh.get_coordinate()))
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.num_workers = int(np.prod([size[a] for a in data_axes], dtype=np.int64))
        w = 0
        for ax in data_axes:
            w = w * size[ax] + coord[ax]
        self.worker = w
        self.model_size = size[model_axis]
        self.model_rank = coord[model_axis]
        rest = [a for a in names if a not in data_axes and a != model_axis]
        r = 0
        for ax in rest:
            r = r * size[ax] + coord[ax]
        self.replica = r
        self.device = mesh_device(mesh)
        # a sum over the data fiber is a sum over each of its axes in turn
        self.data_groups = [mesh.get_group(a) for a in data_axes if size[a] > 1]
        self.model_group = mesh.get_group(model_axis) if self.model_size > 1 else None

    @property
    def writer(self) -> bool:
        """One rank a worker writes the worker's shared host state (the
        read mask, quarantine verdicts, gather times) into a poll."""
        return self.model_rank == 0 and self.replica == 0


_AXES: list = []


def mesh_axes(mesh, data_axes=("data",), model_axis: str = "model") -> MeshAxes:
    """The (cached) `MeshAxes` of this rank on ``mesh``."""
    for m, d, a, axes in _AXES:
        if m is mesh and d == tuple(data_axes) and a == model_axis:
            return axes
    axes = MeshAxes(mesh, data_axes, model_axis)
    _AXES.append((mesh, tuple(data_axes), model_axis, axes))
    return axes


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """SUM ``t`` in place over ``group`` (None: the default group), timed
    into `COLLECTIVES`."""
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return t


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here (an all-reduce of one element, the
    form both backends take)."""
    if dist.get_world_size() > 1:
        all_reduce(torch.zeros(1, device=mesh_device(mesh)), None)


def _vz_shard(spec: MultiQuerySpec, axes: MeshAxes) -> int:
    if spec.v_z % axes.model_size != 0:
        raise ValueError(
            f"V_Z={spec.v_z} must divide by model axis size {axes.model_size} "
            "(pad candidates to a multiple; padded rows are never sampled)"
        )
    return spec.v_z // axes.model_size


def _split_slice(n: int, parts: int, index: int) -> slice:
    per = -(-n // parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def _split_index(mesh, axes: tuple) -> tuple:
    """(parts, this rank's part) of a split over ``axes``, row-major."""
    names = tuple(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    parts, index = 1, 0
    for ax in axes:
        if ax not in size:
            raise ValueError(f"mesh has no axis {ax!r}; axes are {names}")
        parts, index = parts * size[ax], index * size[ax] + coord[ax]
    return parts, index


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_leaf(value, placement, mesh) -> torch.Tensor:
    """This rank's piece of a whole leaf under ``placement`` (`WHOLE` or a
    `DimSplit`), on the mesh's device."""
    t = torch.as_tensor(value)
    if isinstance(placement, DimSplit):
        parts, index = _split_index(mesh, placement.axes)
        if t.shape[0] % parts:
            raise ValueError(f"dim 0 of {t.shape[0]} does not split into {parts} parts")
        t = t[_split_slice(t.shape[0], parts, index)]
    elif not isinstance(placement, Replicate):
        raise TypeError(f"a placement is WHOLE or a DimSplit, got {placement!r}")
    return t.to(mesh_device(mesh)).clone()


def place_cache(snap: CacheSnapshot, mesh, model_axis: str = "model") -> CacheSnapshot:
    """Gather a whole snapshot to the host and keep this rank's pieces per
    `cache_pspecs`, on the mesh's device: the in-memory twin of
    `CheckpointManager.restore_resharded`. ``snap`` holds whole leaves
    (what `SharedCountsScheduler.export_cache` returns on any mesh)."""
    host = CacheSnapshot(*(torch.as_tensor(v).cpu() for v in snap))
    return CacheSnapshot(
        *(place_leaf(v, p, mesh) for v, p in zip(host, cache_pspecs(model_axis)))
    )


def gather_counts(counts: torch.Tensor, n: torch.Tensor, axes: MeshAxes,
                  v_z: int) -> tuple:
    """The whole (V_Z, V_X) counts and (V_Z,) n from the model shards,
    on every rank: one model all-reduce of a zero-filled buffer."""
    if axes.model_group is None:
        return counts, n
    rows = counts.shape[0]
    lo = axes.model_rank * rows
    buf = torch.zeros((v_z, counts.shape[1] + 1), dtype=torch.float32, device=counts.device)
    buf[lo : lo + rows, :-1] = counts
    buf[lo : lo + rows, -1] = n
    all_reduce(buf, axes.model_group)
    return buf[:, :-1].contiguous(), buf[:, -1].contiguous()


def _plans(spec: MultiQuerySpec, vz_shard: int, axes: MeshAxes, plans):
    if plans is None:
        return autotune.resolve_plans(
            vz_shard, spec.v_x, spec.max_queries, metric=spec.metric, device=axes.device
        )
    return plans


def _shard_ingest(state, z_idx, x_idx, *, spec, axes, vz_shard, histogram_impl,
                  onehot_dtype, plan, extra=None):
    """(state with the round's samples added, ``extra`` summed over the
    data group): this model shard's rows of the samples' histogram,
    from zeros (kernel B), and ONE all-reduce of the flat (delta, row
    sums, extra) buffer over the data group, added after the reduce."""
    z_local = z_idx - axes.model_rank * vz_shard
    z_local = torch.where((z_local >= 0) & (z_local < vz_shard), z_local, -1)
    h, rows = ops.histogram_with_rowsums(
        z_local, x_idx, v_z=vz_shard, v_x=spec.v_x, plan=plan,
        impl=histogram_impl, onehot_dtype=onehot_dtype,
    )
    if axes.data_groups:
        parts = (h.reshape(-1), rows) + ((extra,) if extra is not None else ())
        buf = torch.cat(parts)
        for group in axes.data_groups:
            all_reduce(buf, group)
        cells = h.numel()
        h = buf[:cells].view(h.shape)
        rows = buf[cells : cells + vz_shard]
        extra = buf[cells + vz_shard :] if extra is not None else None
    return state._replace(counts=state.counts + h, n=state.n + rows), extra


def _shard_stats(state, *, spec, axes, vz_shard, plan, closeness):
    """Kernel C on the shard's rows for every slot (unoccupied slots at
    1.0), the model all-reduce that gathers tau and n, then the shared
    `apply_stats` on the full arrays."""
    tau = ops.distance_multi(state.counts, state.q_hat, metric=spec.metric, plan=plan)
    tau = torch.where(state.occupied[:, None], tau, 1.0)
    n = state.n
    if axes.model_group is not None:
        q = spec.max_queries
        lo = axes.model_rank * vz_shard
        buf = torch.zeros((q + 1, spec.v_z), dtype=torch.float32, device=tau.device)
        buf[:q, lo : lo + vz_shard] = tau
        buf[q, lo : lo + vz_shard] = n
        all_reduce(buf, axes.model_group)
        tau, n = buf[:q], buf[q]
    return apply_stats(state, tau, n, spec=spec, closeness=closeness)


def _local_ids(wd: WindowData, axes: MeshAxes, blocks_per_worker: int) -> torch.Tensor:
    """The window's global ids as offsets into this worker's range."""
    return wd.indices - axes.worker * blocks_per_worker


def _increments(wd: WindowData, marks: torch.Tensor) -> torch.Tensor:
    """(blocks read, blocks considered, tuples read) of one worker's
    window as exact f32 integers, for the data all-reduce."""
    per_block = torch.sum(wd.z >= 0, dim=1)
    return torch.stack((
        torch.sum(marks), torch.sum(wd.valid), torch.sum(torch.where(marks, per_block, 0)),
    )).to(torch.float32)


def _advance_shard_cursor(cursor: SampleCursor, local_idx, marks, inc) -> SampleCursor:
    """Per-worker twin of `multiquery._advance_cursor`: the scatter hits
    this worker's read-mask slice (local ids; padding repeats an owned
    id with a zero mark), the counters add the mesh-wide increments."""
    read_mask = (
        cursor.read_mask.to(torch.int32).index_put_(
            (local_idx,), marks.to(torch.int32), accumulate=True
        )
        > 0
    )
    inc = inc.to(torch.int64)
    return SampleCursor(
        read_mask=read_mask,
        blocks_read=cursor.blocks_read + inc[0],
        blocks_considered=cursor.blocks_considered + inc[1],
        tuples_read=cursor.tuples_read + inc[2],
        rounds=cursor.rounds + 1,
    )


def _masked(wd: WindowData, marks: torch.Tensor) -> tuple:
    zw = torch.where(marks[:, None], wd.z, -1).reshape(-1)
    xw = torch.where(marks[:, None], wd.x, -1).reshape(-1)
    return zw, xw


def make_distributed_round(
    mesh,
    spec: MultiQuerySpec,
    *,
    data_axes=("data",),
    model_axis: str = "model",
    histogram_impl: str = "auto",
    onehot_dtype=torch.float32,
    plans=None,
):
    """The multi-query round over a mesh: (state, z_idx, x_idx) -> state,
    with ``state`` this rank's pieces per `multi_state_pspecs` and
    ``z_idx`` / ``x_idx`` the (N,) int32 samples this rank's worker read
    (padding -1). ``plans`` pins the kernel plans; None resolves them on
    the shard shapes."""
    axes = mesh_axes(mesh, data_axes, model_axis)
    vz_shard = _vz_shard(spec, axes)
    plans = _plans(spec, vz_shard, axes, plans)

    def round_fn(state, z_idx, x_idx, *, closeness: bool = True):
        state, _ = _shard_ingest(
            state, z_idx, x_idx, spec=spec, axes=axes, vz_shard=vz_shard,
            histogram_impl=histogram_impl, onehot_dtype=onehot_dtype, plan=plans.ingest,
        )
        return _shard_stats(state, spec=spec, axes=axes, vz_shard=vz_shard, plan=plans.tau,
                            closeness=closeness)

    round_fn.plans = plans
    return round_fn


def make_stats_step(mesh, spec: MultiQuerySpec, *, model_axis: str = "model", plans=None):
    """The statistics step over a mesh (admission, exact completion):
    state -> state, kernel C on the shard and the model gather."""
    axes = mesh_axes(mesh, (), model_axis)
    vz_shard = _vz_shard(spec, axes)
    plans = _plans(spec, vz_shard, axes, plans)

    def stats_fn(state, *, closeness: bool = True):
        return _shard_stats(state, spec=spec, axes=axes, vz_shard=vz_shard, plan=plans.tau,
                            closeness=closeness)

    return stats_fn


def make_pump_round(
    mesh,
    spec: MultiQuerySpec,
    *,
    blocks_per_worker: int,
    data_axes=("data",),
    model_axis: str = "model",
    policy: str = "anyactive",
    histogram_impl: str = "auto",
    onehot_dtype=torch.float32,
    plans=None,
):
    """The pump round: `multiquery.fused_round`'s mark + masked ingest +
    stats + read bookkeeping, each worker fed by its own window.
    (state, cursor, wd) -> (state, cursor): state per
    `multi_state_pspecs`, cursor per `cursor_pspecs` (this worker's
    read-mask slice of ``blocks_per_worker`` blocks), ``wd`` this
    worker's window in global ids.

    Kernel A marks the window against the replicated union words and the
    worker's read-mask slice; the counter increments ride the data
    all-reduce, and a round that marked nothing mesh-wide keeps the old
    statistics (``round_idx`` included) through a `torch.where` on the
    reduced count, with no host sync. Driven with the same global
    windows, the round equals `fused_round` on the union of the workers'
    windows, bit for bit where the shard resolves the full matrix's
    plan."""
    axes = mesh_axes(mesh, data_axes, model_axis)
    vz_shard = _vz_shard(spec, axes)
    plans = _plans(spec, vz_shard, axes, plans)

    def round_fn(state, cursor, wd, *, closeness: bool = True):
        local_idx = _local_ids(wd, axes, blocks_per_worker)
        local = wd._replace(indices=local_idx, id_base=0)
        mask = cursor.read_mask
        if local.bitmap_by_id:
            # the last worker's table may hold fewer rows than its padded slice
            mask = mask[: local.bitmap.shape[0]]
        marks = mark_window(local, state.union_words, mask, policy=policy)
        zw, xw = _masked(wd, marks)
        new, inc = _shard_ingest(
            state, zw, xw, spec=spec, axes=axes, vz_shard=vz_shard,
            histogram_impl=histogram_impl, onehot_dtype=onehot_dtype, plan=plans.ingest,
            extra=_increments(wd, marks),
        )
        new = _shard_stats(new, spec=spec, axes=axes, vz_shard=vz_shard, plan=plans.tau,
                           closeness=closeness)
        took = inc[0] > 0
        state = MultiQueryState(
            *(b if a is b else torch.where(took, a, b) for a, b in zip(new, state))
        )
        return state, _advance_shard_cursor(cursor, local_idx, marks, inc)

    round_fn.plans = plans
    return round_fn


def make_pump_ingest_round(
    mesh,
    spec: MultiQuerySpec,
    *,
    blocks_per_worker: int,
    data_axes=("data",),
    model_axis: str = "model",
    histogram_impl: str = "auto",
    onehot_dtype=torch.float32,
    plans=None,
):
    """The pump twin of `multiquery.ingest_round` (exact completion):
    every unread block of each worker's window into the shared counts,
    no marking by activity and no stats; the signature and placements of
    `make_pump_round`."""
    axes = mesh_axes(mesh, data_axes, model_axis)
    vz_shard = _vz_shard(spec, axes)
    plans = _plans(spec, vz_shard, axes, plans)

    def round_fn(state, cursor, wd):
        local_idx = _local_ids(wd, axes, blocks_per_worker)
        marks = ops.mark_blocks(local_idx, wd.valid, cursor.read_mask)
        zw, xw = _masked(wd, marks)
        state, inc = _shard_ingest(
            state, zw, xw, spec=spec, axes=axes, vz_shard=vz_shard,
            histogram_impl=histogram_impl, onehot_dtype=onehot_dtype, plan=plans.ingest,
            extra=_increments(wd, marks),
        )
        return state, _advance_shard_cursor(cursor, local_idx, marks, inc)

    round_fn.plans = plans
    return round_fn


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# When this process's rank started (wall clock): entered, its device set,
# its process group ready (`run_ranks`; a rank's ``fn`` may report them).
RANK_STARTUP: dict = {}


def _rank_main(fn, rank, world, port, backend, device_type, args, results) -> None:
    import traceback

    try:
        RANK_STARTUP["entered"] = time.time()
        if device_type == "cuda":
            torch.cuda.set_device(0 if torch.cuda.device_count() == 1 else rank)
        RANK_STARTUP["device_set"] = time.time()
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank
        )
        RANK_STARTUP["group_ready"] = time.time()
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, backend: str = "gloo", device_type: str = "cpu",
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    with the default process group initialised (``backend`` over
    ``tcp://localhost``; on "cuda" each rank's current device set, all on
    device 0 when the host has one), and return their results in rank
    order. ``fn`` and ``args`` must pickle (a CPU tensor in shared memory
    passes by handle, not by value); return numpy arrays and plain
    values, not tensors, whose handles die with their rank. A rank that raises, dies or outlives
    ``timeout`` seconds raises here, after every rank is stopped."""
    import queue as _queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main,
                    args=(fn, r, world, port, backend, device_type, args, results))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out, failed = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failed is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    failed = f"ranks {sorted(set(range(world)) - set(out))} timed out"
                elif any(p.exitcode not in (None, 0) for p in procs):
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    failed = f"ranks {dead} died (exit codes {[procs[r].exitcode for r in dead]})"
                continue
            if ok:
                out[rank] = value
            else:
                failed = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=30.0 if failed is None else 1.0)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [out[r] for r in range(world)]
