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
