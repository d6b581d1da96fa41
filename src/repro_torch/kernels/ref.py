"""Plain PyTorch versions of the histogram and marking kernels.

Port of `repro.kernels.ref`: the semantics of record. On CPU tensors
`repro_torch.kernels.ops` runs these; on the card `chip_smoke.py`
holds each CUDA kernel against them on the same inputs. The distance
versions live in `repro_torch.kernels.metrics`; the l1 aliases here
delegate to them, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import metrics


__all__ = [
    "histogram_ref",
    "histogram_matmul",
    "histogram_with_rowsums_ref",
    "l1_distance_ref",
    "l1_distance_multi_ref",
    "anyactive_ref",
    "mark_blocks_ref",
]


def histogram_ref(
    z_idx: torch.Tensor,
    x_idx: torch.Tensor,
    *,
    v_z: int,
    v_x: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """(V_Z, V_X) counts with counts[z, x] = #{samples with ids (z, x)}.

    Samples with an id < 0 or >= its bound are dropped: they add a zero
    weight at a clamped index, so the scatter has a fixed shape.
    """
    valid = (z_idx >= 0) & (x_idx >= 0) & (z_idx < v_z) & (x_idx < v_x)
    w = valid.to(dtype)
    zc = torch.where(valid, z_idx, 0).to(torch.int64)
    xc = torch.where(valid, x_idx, 0).to(torch.int64)
    counts = torch.zeros((v_z, v_x), dtype=dtype, device=z_idx.device)
    return counts.index_put_((zc, xc), w, accumulate=True)


def histogram_matmul(
    z_idx: torch.Tensor,
    x_idx: torch.Tensor,
    *,
    v_z: int,
    v_x: int,
    chunk: int = 32_768,
    onehot_dtype=torch.float32,
) -> torch.Tensor:
    """The one-hot contraction form of `histogram_ref`: counts =
    onehot(z)^T @ onehot(x), in sample chunks of ``chunk`` so the one-hot
    buffers stay bounded; out-of-range ids drop. The counts accumulate
    and return in f32 for any ``onehot_dtype``: a bf16 or f16 product
    rounds a count past 256 (2048 in f16), so a low-precision product
    covers at most 256 samples and is added into the f32 sum, where it
    is exact. Counts are exact up to 2^24 a cell."""
    if onehot_dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"onehot_dtype must be float32, bfloat16 or float16, got {onehot_dtype}")
    z = z_idx.reshape(-1).to(torch.int64)
    x = x_idx.reshape(-1).to(torch.int64)
    keep = (z >= 0) & (z < v_z) & (x >= 0) & (x < v_x)
    # a dropped sample selects the all-zero last row of the one-hot table
    z = torch.where(keep, z, v_z)
    x = torch.where(keep, x, v_x)
    dev = z_idx.device
    eye_z = torch.eye(v_z + 1, v_z, dtype=onehot_dtype, device=dev)
    eye_x = torch.eye(v_x + 1, v_x, dtype=onehot_dtype, device=dev)
    step = chunk if onehot_dtype == torch.float32 else min(chunk, 256)
    acc = torch.zeros((v_z, v_x), dtype=torch.float32, device=dev)
    for c in range(0, z.shape[0], step):
        part = eye_z[z[c : c + step]].T @ eye_x[x[c : c + step]]
        acc += part.to(torch.float32)
    return acc


def histogram_with_rowsums_ref(
    z_idx: torch.Tensor,
    x_idx: torch.Tensor,
    *,
    v_z: int,
    v_x: int,
    dtype=torch.float32,
) -> tuple:
    """((V_Z, V_X), (V_Z,)) histogram + per-candidate row sums
    (rows == counts.sum(1), exact on integer-valued counts)."""
    counts = histogram_ref(z_idx, x_idx, v_z=v_z, v_x=v_x, dtype=dtype)
    return counts, torch.sum(counts, dim=1)


def l1_distance_ref(counts: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
    """(V_Z,) tau_i = || counts_i / sum(counts_i) - q_hat ||_1."""
    return metrics.distance_ref(counts, q_hat, metric="l1")


def l1_distance_multi_ref(counts: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
    """(Q, V_Z) tau[q, i] = || normalize(counts_i) - q_hat_q ||_1."""
    return metrics.distance_multi_ref(counts, q_hat, metric="l1")


def anyactive_ref(bitmap: torch.Tensor, active_words: torch.Tensor) -> torch.Tensor:
    """(num_blocks,) bool AnyActive marks (paper Alg. 3): True = :read.

    bitmap: (num_blocks, W) int32 holding the uint32 bit pattern, bit
    (b, 32w + j) set iff block b holds a tuple of candidate 32w + j;
    active_words: (W,) int32, the packed active-candidate mask.
    """
    hits = torch.bitwise_and(bitmap, active_words[None, :])
    return torch.any(hits != 0, dim=1)


def mark_blocks_ref(
    indices: torch.Tensor,
    valid: torch.Tensor,
    read_mask: torch.Tensor,
    bitmap: Optional[torch.Tensor] = None,
    active_words: Optional[torch.Tensor] = None,
    *,
    by_id: bool = False,
) -> torch.Tensor:
    """(L,) bool final read-marks of a window:
    ``valid & ~read_mask[indices] & anyactive(row_i, active_words)``.

    ``row_i`` is ``bitmap[indices[i]]`` when ``by_id`` (``bitmap`` is
    the whole table) and ``bitmap[i]`` otherwise (a gathered window).
    With no bitmap and no active words: ``valid & ~read_mask[indices]``.
    """
    if (bitmap is None) != (active_words is None):
        raise ValueError("give both bitmap and active_words, or neither")
    marks = valid & ~read_mask[indices]
    if bitmap is None:
        return marks
    rows = bitmap[indices] if by_id else bitmap
    return marks & anyactive_ref(rows, active_words)
