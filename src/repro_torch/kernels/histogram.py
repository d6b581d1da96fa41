"""CUDA kernel B: per-candidate histogram of (z, x) sample pairs.

Port of `repro.kernels.histogram`. The reference expresses the histogram
as a one-hot contraction on the TPU's matrix unit; on Hopper each sample
is one f32 atomic add into the counts (and into the row sums, in the
fused form) — see the note in ``csrc/histogram.cu``. Both wrappers
return fresh, zero-initialised outputs, like the reference's functions.
The plain version is `repro_torch.kernels.ref.histogram_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

__all__ = ["histogram", "histogram_with_rowsums", "KERNEL"]

KERNEL = CudaKernel(
    "histogram",
    "fm_histogram",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int),
)


def _launch(z_idx, x_idx, *, v_z: int, v_x: int, with_rowsums: bool):
    check_cuda_tensor(z_idx, "z_idx", torch.int32, 1)
    check_cuda_tensor(x_idx, "x_idx", torch.int32, 1)
    if z_idx.shape != x_idx.shape:
        raise ValueError(f"z_idx {tuple(z_idx.shape)} and x_idx {tuple(x_idx.shape)} differ")
    if v_z < 1 or v_x < 1:
        raise ValueError(f"need v_z, v_x >= 1, got {v_z}, {v_x}")
    dev = z_idx.device
    counts = torch.zeros((v_z, v_x), dtype=torch.float32, device=dev)
    rows = torch.zeros((v_z,), dtype=torch.float32, device=dev) if with_rowsums else None
    n = z_idx.numel()
    if n:
        KERNEL.launch(
            z_idx.data_ptr(), x_idx.data_ptr(), counts.data_ptr(),
            rows.data_ptr() if rows is not None else None, n, v_z, v_x,
        )
    return counts, rows


def histogram(z_idx: torch.Tensor, x_idx: torch.Tensor, *, v_z: int, v_x: int) -> torch.Tensor:
    """(V_Z, V_X) float32 histogram; ids < 0 or >= their bound dropped."""
    return _launch(z_idx, x_idx, v_z=v_z, v_x=v_x, with_rowsums=False)[0]


def histogram_with_rowsums(
    z_idx: torch.Tensor, x_idx: torch.Tensor, *, v_z: int, v_x: int
) -> tuple:
    """((V_Z, V_X), (V_Z,)) histogram + its row sums, one pass. rows[i]
    == counts[i].sum() exactly (integer-valued f32 below 2^24)."""
    return _launch(z_idx, x_idx, v_z=v_z, v_x=v_x, with_rowsums=True)
