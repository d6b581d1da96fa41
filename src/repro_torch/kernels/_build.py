"""Build the CUDA kernels under `csrc/` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
repository root. The library's file name carries the SHA-256 of its
source and of the headers under ``csrc/`` (``*.cuh``), so an edited
source or header is rebuilt and an unchanged one is loaded from an
earlier build. The first kernel call builds every source, one
nvcc process each, all started together. A build that fails raises; no
caller falls back to a plain version.

Every C entry point takes its device pointers and the CUDA stream as
``void *``, launches on that stream without synchronising, and returns
``cudaGetLastError()``. `CudaKernel.launch` raises when that is not 0
and counts the launches it made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "CudaKernel", "build_all", "check_cuda_tensor", "library_path", "BUILD_DIR", "CSRC", "SOURCES",
]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("anyactive", "histogram", "distance")
# No --use_fast_math: the kernels' divides, square roots and absolute
# values must be IEEE to agree with the plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its and the headers' hash."""
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict:
    """Build (where needed, in parallel) and load every kernel library.

    Returns {source name: ctypes.CDLL}. nvcc's report of each kernel's
    registers and shared memory is kept beside the library as ``.log``.
    """
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        missing = [name for name in SOURCES if not library_path(name).exists()]
        nvcc = _nvcc() if missing else None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        for name in missing:
            out = library_path(name)
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in pending.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` grows by one for each launch that was accepted, and
    nowhere else, so a run can show that its path went through the
    kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: tuple):
        if source not in SOURCES:
            raise ValueError(f"unknown kernel source {source!r}")
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        fn = getattr(build_all()[self.source], self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]  # the stream comes last
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream; raise if CUDA refused it."""
        fn = self._fn or self._bind()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given type
    and rank on the current device (what a kernel may be handed)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} lies on {t.device}, not the current CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
