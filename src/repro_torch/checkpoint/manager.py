"""Crash-atomic, checksummed, auto-resuming snapshots on disk.

Port of `repro.checkpoint.manager`, with the reference's layout byte for
byte, so a snapshot written by either package restores in the other:

    <dir>/step_<N>/
        META.json            {step, time, config_hash, leaves: [{name, dtype, shape}]}
        arr_<i>.npy          one file per leaf, in flattening order
        CHECKSUMS.json       sha256 of each file's bytes, written last
    <dir>/LATEST             "step_<N>", committed by rename

A bf16 leaf is stored as its bits in a uint16 ``.npy`` with ``"dtype":
"bfloat16"`` in its metadata, and restores as bf16, as in the reference.
Leaves are named as the reference's ``jax.tree_util`` paths name them:
a dict key as itself (keys sorted), a list or tuple index as its
number, a `NamedTuple` field as ``.field`` (so a `CacheSnapshot` is
``.counts``, ``.n``, ``.read_mask``, ...), joined with "/".

The contract, as the reference's: a save writes ``step_<N>.tmp.<pid>``
and commits with two renames (the step dir, then LATEST); re-saving a
step moves the old dir aside first; keep-last GC runs after a commit
and sweeps ``*.tmp.<pid>`` leftovers whose owner is dead; restore picks
the newest step whose checksums verify (an older one, with a warning,
when the newest does not), an explicitly named step that fails
verification raises, a snapshot without a sidecar is accepted, and a
structure or config-hash mismatch raises. ``gc_swept``,
``save_failures`` and ``corrupt_steps`` count what happened; with
``telemetry=`` (a `repro_torch.obs.Telemetry`) so do the ``checkpoint_*``
metrics, with the ``checkpoint_save``, ``checkpoint_gc`` and
``checkpoint_corrupt`` events. `restore_resharded` restores onto a
`torch.distributed` mesh of any shape: each rank reads the verified step
and keeps its pieces (`repro_torch.core.distributed.cache_pspecs`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib
import shutil
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "config_hash"]

logger = logging.getLogger(__name__)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OverflowError):
        return True  # exists but is not ours (or out of kill's range): leave it
    return True


def _flatten_with_names(tree, prefix: Tuple[str, ...] = ()) -> Tuple[List[str], list, Callable]:
    """(leaf names, leaves, rebuild) of a tree of dicts, lists, tuples
    and NamedTuples, in the reference's order and naming."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten_with_names(tree[k], prefix + (str(k),)) for k in keys]
        kind = type(tree)

        def rebuild(leaves):
            return kind(zip(keys, _rebuild_parts(parts, leaves)))

    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_flatten_with_names(getattr(tree, f), prefix + ("." + f,)) for f in tree._fields]
        kind = type(tree)

        def rebuild(leaves):
            return kind(*_rebuild_parts(parts, leaves))

    elif isinstance(tree, (list, tuple)):
        parts = [_flatten_with_names(v, prefix + (str(i),)) for i, v in enumerate(tree)]
        kind = type(tree)

        def rebuild(leaves):
            return kind(_rebuild_parts(parts, leaves))

    else:
        return ["/".join(prefix)], [tree], lambda leaves: leaves[0]
    names = [n for p in parts for n in p[0]]
    leaves = [v for p in parts for v in p[1]]
    return names, leaves, rebuild


def _rebuild_parts(parts, leaves) -> list:
    out, i = [], 0
    for names, _, rebuild in parts:
        out.append(rebuild(leaves[i : i + len(names)]))
        i += len(names)
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array a leaf's file holds, the leaf's logical dtype): a bf16
    tensor goes as its bits in a uint16 array (npy has no bf16), as the
    reference stores it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf's file back as a tensor of its logical dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3, config_hash: str = "",
                 telemetry=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.config_hash = config_hash
        self.telemetry = telemetry
        self.gc_swept = 0
        self.save_failures = 0
        self.corrupt_steps = 0  # snapshots rejected by checksum verification
        if telemetry is not None:
            reg = telemetry.registry
            self._c_saves = reg.counter("checkpoint_saves_total", "successful committed snapshots")
            self._c_save_bytes = reg.counter(
                "checkpoint_save_bytes_total", "bytes written by committed saves")
            self._c_failures = reg.counter(
                "checkpoint_save_failures_total", "saves that raised before commit")
            self._c_gc_swept = reg.counter(
                "checkpoint_gc_swept_total",
                "orphaned tmp leftovers removed (dead-pid crashed saves)")
            self._c_corrupt = reg.counter(
                "checkpoint_corrupt_steps_total",
                "snapshots rejected by checksum verification at restore")
            self._h_save = reg.histogram("checkpoint_save_seconds",
                                         help="wall time of a committed save")

    # ------------------------------------------------------------------ save
    def save(self, state: Any, step: int) -> pathlib.Path:
        t0 = time.perf_counter()
        try:
            final, nbytes = self._save(state, step)
        except BaseException:
            self.save_failures += 1
            if self.telemetry is not None:
                self._c_failures.inc(1)
            raise
        if self.telemetry is not None:
            dur = time.perf_counter() - t0
            self._c_saves.inc(1)
            self._c_save_bytes.inc(nbytes)
            self._h_save.observe(dur)
            self.telemetry.tracer.emit("checkpoint_save", step=int(step), bytes=nbytes, save_s=dur)
        return final

    def _save(self, state: Any, step: int):
        names, leaves, _ = _flatten_with_names(state)
        tmp = self.dir / f"step_{step}.tmp.{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {"step": int(step), "time": time.time(), "config_hash": self.config_hash,
                "leaves": []}
        nbytes = 0  # the arrays' bytes, headers left out (the reference's count)
        sums = {}
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            arr, dtype = _to_numpy(leaf)
            fname = f"arr_{i}.npy"
            np.save(tmp / fname, arr)
            # the file's bytes, header included: restore must catch a
            # truncated or bit-rotted file
            sums[fname] = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()
            nbytes += int(arr.nbytes)
            meta["leaves"].append({"name": name, "dtype": dtype,
                                   "shape": list(arr.shape)})
        meta_bytes = json.dumps(meta).encode()
        (tmp / "META.json").write_bytes(meta_bytes)
        sums["META.json"] = hashlib.sha256(meta_bytes).hexdigest()
        # the sidecar goes in last: a step dir holding it is fully written
        (tmp / "CHECKSUMS.json").write_text(json.dumps(sums))
        final = self.dir / f"step_{step}"
        if final.exists():
            # re-saving a step: move the old dir aside (a rename) rather
            # than delete it, so a crash here leaves the old snapshot; the
            # .tmp.<pid> name lets a later GC sweep it
            aside = self.dir / f"step_{step}.old.tmp.{os.getpid()}"
            if aside.exists():
                shutil.rmtree(aside)
            final.rename(aside)
        else:
            aside = None
        tmp.rename(final)  # commit 1: the step dir
        latest_tmp = self.dir / f"LATEST.tmp.{os.getpid()}"
        latest_tmp.write_text(f"step_{step}")
        latest_tmp.rename(self.dir / "LATEST")  # commit 2: the pointer
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        self._gc()
        return final, nbytes

    def _gc(self):
        self._sweep_stale_tmp()
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def _sweep_stale_tmp(self):
        """Remove ``*.tmp.<pid>`` leftovers whose owning process is dead
        (a killed save cannot clean up after itself); ours and those of
        live savers stay."""
        swept = 0
        for p in self.dir.glob("*.tmp.*"):
            pid_s = p.name.rsplit(".", 1)[-1]
            if pid_s.isdigit() and (int(pid_s) == os.getpid() or _pid_alive(int(pid_s))):
                continue
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
            swept += 1
        if swept:
            self.gc_swept += swept
            if self.telemetry is not None:
                self._c_gc_swept.inc(swept)
                self.telemetry.tracer.emit("checkpoint_gc", swept=swept)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and ".tmp." not in p.name and (p / "META.json").exists():
                steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            p = self.dir / name
            if (p / "META.json").exists():
                return int(name.split("_")[1])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> bool:
        """True iff ``step_<step>``'s bytes match its checksum sidecar (or
        the snapshot has no sidecar, which is accepted as it is)."""
        path = self.dir / f"step_{step}"
        sidecar = path / "CHECKSUMS.json"
        if not sidecar.exists():
            return True
        try:
            sums = json.loads(sidecar.read_text())
        except (json.JSONDecodeError, OSError):
            return False
        for name, want in sums.items():
            try:
                got = hashlib.sha256((path / name).read_bytes()).hexdigest()
            except OSError:
                return False
            if got != want:
                return False
        return True

    def _note_corrupt(self, step: int) -> None:
        self.corrupt_steps += 1
        logger.warning(
            "checkpoint %s/step_%d failed checksum verification "
            "(truncated or corrupt); falling back to an older snapshot",
            self.dir, step,
        )
        if self.telemetry is not None:
            self._c_corrupt.inc(1)
            self.telemetry.tracer.emit("checkpoint_corrupt", step=int(step))

    def _pick_verified_step(self) -> int:
        """The newest step whose bytes verify, warning per rejected step."""
        newest = self.latest_step()
        if newest is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        candidates = [newest] + [s for s in sorted(self.all_steps(), reverse=True) if s != newest]
        for s in candidates:
            if self.verify_step(s):
                return s
            self._note_corrupt(s)
        raise FileNotFoundError(f"no checkpoint in {self.dir} passed checksum verification")

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``like``: each leaf a tensor of
        its saved dtype (bf16 where the leaf's metadata says so) and shape, on the device of ``like``'s leaf when
        that is a tensor, else on the CPU.

        ``step=None`` resumes from the newest step whose checksums verify;
        an explicit ``step`` that fails verification raises ValueError.
        """
        if step is None:
            step = self._pick_verified_step()
        elif not self.verify_step(step):
            raise ValueError(f"checkpoint {self.dir}/step_{step} failed checksum verification")
        path = self.dir / f"step_{step}"
        meta = json.loads((path / "META.json").read_text())
        if self.config_hash and meta["config_hash"] and meta["config_hash"] != self.config_hash:
            raise ValueError(
                f"checkpoint config hash {meta['config_hash']} != expected {self.config_hash}"
            )
        names, leaves, rebuild = _flatten_with_names(like)
        saved_names = [leaf["name"] for leaf in meta["leaves"]]
        if names != saved_names:
            raise ValueError(
                "checkpoint structure mismatch: "
                f"{set(saved_names) ^ set(names) or 'ordering differs'}"
            )
        out = []
        for i, (want, saved) in enumerate(zip(leaves, meta["leaves"])):
            t = _from_numpy(np.load(path / f"arr_{i}.npy"), saved["dtype"])
            out.append(t.to(want.device) if isinstance(want, torch.Tensor) else t)
        return rebuild(out)

    def restore_resharded(self, like: Any, mesh, pspecs, step: Optional[int] = None) -> Any:
        """`restore` onto a mesh (elastic restart): every rank reads the
        verified step and keeps its pieces per ``pspecs``, a tree of the
        structure of ``like`` whose leaves are
        `repro_torch.core.distributed.WHOLE` or a `DimSplit`, on the mesh's
        device. The mesh that wrote the snapshot does not matter: files
        hold whole leaves."""
        from repro_torch.core.distributed import place_leaf

        whole = self.restore(like, step)
        _, leaves, rebuild = _flatten_with_names(whole)
        _, placements, _ = _flatten_with_names(pspecs)
        if len(placements) != len(leaves):
            raise ValueError(
                f"pspecs has {len(placements)} leaves, the snapshot {len(leaves)}"
            )
        return rebuild([place_leaf(v, p, mesh) for v, p in zip(leaves, placements)])


def config_hash(obj: Any) -> str:
    """sha256 of ``repr(obj)``, 16 hex digits (the reference's)."""
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]
