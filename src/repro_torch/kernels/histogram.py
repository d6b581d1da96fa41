"""CUDA kernel B: the fused ingest of (z, x) sample pairs.

Port of `repro.kernels.histogram` and of the two adds around it in the
reference's `ingest`. The reference expresses the histogram as a one-hot
contraction on the TPU's matrix unit; on Hopper one C call counts the
samples and flushes them into fresh counts and row sums
(``csrc/histogram.cu``), in one of two forms that `form_for` picks from
(V_Z, V_X) alone:

- "global": f32 atomics into a scratch that stays in L2, then a row
  flush after a grid-wide barrier (counts too large for a block's
  shared memory, such as the main path's 7548 x 24);
- "private": each block counts its chunk of the samples in shared
  memory and adds its nonzero bins into the scratch, then every block
  flushes rows after the barrier; a one-block grid flushes from shared
  memory (up to `PRIVATE_MAX_BINS` counts: the drift monitor's and the
  registry's V_Z = 1 rows, the corpus selection's 64 x 128).

`ingest_counts` is functional: it returns ``(counts + hist, n +
rowsum(hist))`` in new tensors and leaves its inputs as they were.
`histogram` and `histogram_with_rowsums` are the same launch with no
input counts, so they return fresh outputs like the reference's
functions; at V_Z = 1 `histogram` takes ``z_idx=None`` and reads only
the x ids. Each call is one launch; none fills or adds around it.

The scratch is a (V_Z, V_X) float32 tensor kept per (device, stream,
V_Z, V_X): zeroed once when first made, and left all zero by every
call. The plain versions are `ingest_counts_ref` here and
`repro_torch.kernels.ref.histogram_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

__all__ = [
    "delta_scratch",
    "form_for",
    "histogram",
    "histogram_with_rowsums",
    "ingest_counts",
    "ingest_counts_ref",
    "check_z_less",
    "FORMS",
    "FORM_LAUNCHES",
    "KERNEL",
    "PRIVATE_MAX_BINS",
]

KERNEL = CudaKernel(
    "histogram",
    "fm_ingest",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int),
)

# The C entry's `form` code of each form (csrc/histogram.cu).
FORMS = {"global": 0, "private": 1}
# The most counts (V_Z * V_X) the private form takes: on 262,144 uniform
# ids it beat the global form at 64 x 128 and lost at 64 x 256 (H100,
# tools/torch_hist_forms.py).
PRIVATE_MAX_BINS = 8_192
# Launches of each form, beside KERNEL.launches (which counts both).
FORM_LAUNCHES = {name: 0 for name in FORMS}

_scratch: dict = {}


def form_for(v_z: int, v_x: int) -> str:
    """The form kernel B takes at (V_Z, V_X): "private" where the counts
    fit a block's shared memory, else "global"."""
    return "private" if v_z * v_x <= PRIVATE_MAX_BINS else "global"


def delta_scratch(v_z: int, v_x: int, device: torch.device) -> torch.Tensor:
    """The kernel's (V_Z, V_X) scratch for ``device`` and its current
    stream: all zero between calls."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream, v_z, v_x)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = torch.zeros((v_z, v_x), dtype=torch.float32, device=device)
        _scratch[key] = scratch
    return scratch


def check_z_less(v_z: int) -> None:
    """`histogram`'s ``z_idx=None`` stands for zeros: V_Z = 1 only."""
    if v_z != 1:
        raise ValueError(f"z_idx=None needs v_z == 1, got v_z={v_z}")


def _launch(z_idx, x_idx, counts, n, *, v_z: int, v_x: int, with_rowsums: bool) -> tuple:
    check_cuda_tensor(x_idx, "x_idx", torch.int32, 1)
    if z_idx is None:  # `histogram`'s z-less call, the only one without z
        if with_rowsums:
            raise TypeError("z_idx=None: only histogram reads the x ids alone")
        check_z_less(v_z)
    else:
        check_cuda_tensor(z_idx, "z_idx", torch.int32, 1)
        if z_idx.shape != x_idx.shape:
            raise ValueError(f"z_idx {tuple(z_idx.shape)} and x_idx {tuple(x_idx.shape)} differ")
    if v_z < 1 or v_x < 1:
        raise ValueError(f"need v_z, v_x >= 1, got {v_z}, {v_x}")
    dev = x_idx.device
    form = form_for(v_z, v_x)
    counts_out = torch.empty((v_z, v_x), dtype=torch.float32, device=dev)
    n_out = torch.empty((v_z,), dtype=torch.float32, device=dev) if with_rowsums else None
    KERNEL.launch(
        z_idx.data_ptr() if z_idx is not None else None, x_idx.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        n.data_ptr() if n is not None else None,
        counts_out.data_ptr(), n_out.data_ptr() if n_out is not None else None,
        delta_scratch(v_z, v_x, dev).data_ptr(), x_idx.numel(), v_z, v_x, FORMS[form],
    )
    FORM_LAUNCHES[form] += 1
    return counts_out, n_out


def ingest_counts(
    counts: torch.Tensor, n: torch.Tensor, z_idx: torch.Tensor, x_idx: torch.Tensor,
    *, v_z: int, v_x: int,
) -> tuple:
    """(counts + hist(z, x), n + rowsum(hist)) in new tensors, one launch.

    counts: (V_Z, V_X) float32, n: (V_Z,) float32, z_idx / x_idx: (S,)
    int32, all contiguous on the current CUDA device; ids outside
    [0, V_Z) or [0, V_X) are dropped. Launches on the current stream.
    """
    check_cuda_tensor(counts, "counts", torch.float32, 2)
    check_cuda_tensor(n, "n", torch.float32, 1)
    if tuple(counts.shape) != (v_z, v_x) or tuple(n.shape) != (v_z,):
        raise ValueError(
            f"counts {tuple(counts.shape)} / n {tuple(n.shape)} do not match V_Z={v_z}, V_X={v_x}"
        )
    return _launch(z_idx, x_idx, counts, n, v_z=v_z, v_x=v_x, with_rowsums=True)


def ingest_counts_ref(
    counts: torch.Tensor, n: torch.Tensor, z_idx: torch.Tensor, x_idx: torch.Tensor,
    *, v_z: int, v_x: int,
) -> tuple:
    """Plain version of `ingest_counts`: the reference's ingest, the
    histogram with its row sums followed by the two adds."""
    delta_counts, delta_n = ref.histogram_with_rowsums_ref(z_idx, x_idx, v_z=v_z, v_x=v_x)
    return counts + delta_counts, n + delta_n


def histogram(
    z_idx: Optional[torch.Tensor], x_idx: torch.Tensor, *, v_z: int, v_x: int
) -> torch.Tensor:
    """(V_Z, V_X) float32 histogram; ids < 0 or >= their bound dropped.
    ``z_idx=None`` (V_Z = 1 only) reads every sample's row as 0."""
    return _launch(z_idx, x_idx, None, None, v_z=v_z, v_x=v_x, with_rowsums=False)[0]


def histogram_with_rowsums(
    z_idx: torch.Tensor, x_idx: torch.Tensor, *, v_z: int, v_x: int
) -> tuple:
    """((V_Z, V_X), (V_Z,)) histogram + its row sums, one launch. rows[i]
    == counts[i].sum() exactly (integer-valued f32 below 2^24)."""
    return _launch(z_idx, x_idx, None, None, v_z=v_z, v_x=v_x, with_rowsums=True)
