"""Packed per-block candidate-presence bitmaps (paper Sec 4.1).

Port of `repro.core.bitmap`. A (num_blocks, W) matrix of 32-bit words,
W = ceil(V_Z / 32): bit j of word (b, w) says whether data block b holds
at least one tuple of candidate 32w + j.

`build_block_bitmap` is host-side numpy and returns uint32, bit for bit
the reference's. On the device the words are int32 tensors carrying the
same bit pattern (``.view(np.int32)`` at the numpy boundary), because
PyTorch does not shift uint32 tensors; candidate 31 of a word is then
the sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["words_for", "build_block_bitmap", "pack_active_mask", "unpack_mask"]

# Blocks per chunk of the bitmap build: the (chunk, V_Z) presence matrix
# is the build's only large temporary (about 31 MB at V_Z = 7548).
DEFAULT_CHUNK_BLOCKS = 4096


def words_for(v_z: int) -> int:
    return -(-v_z // 32)


def build_block_bitmap(
    z_blocks: np.ndarray, v_z: int, *, chunk_blocks: int = DEFAULT_CHUNK_BLOCKS
) -> np.ndarray:
    """(num_blocks, W) uint32 packed presence bitmap of blocked candidate
    ids (ids < 0 or >= v_z are ignored).

    Built ``chunk_blocks`` blocks at a time, so the peak memory is one
    chunk's presence matrix whatever the dataset size. Candidate c is bit
    c % 32 of word c // 32, as in the reference.
    """
    if chunk_blocks < 1:
        raise ValueError(f"need chunk_blocks >= 1, got {chunk_blocks}")
    z_blocks = np.asarray(z_blocks)
    nb, bs = z_blocks.shape
    w = words_for(v_z)
    out = np.zeros((nb, w), dtype=np.uint32)
    for lo in range(0, nb, chunk_blocks):
        chunk = z_blocks[lo : lo + chunk_blocks]
        n = chunk.shape[0]
        present = np.zeros((n, w * 32), dtype=bool)
        rows = np.repeat(np.arange(n), bs)
        vals = chunk.reshape(-1)
        ok = (vals >= 0) & (vals < v_z)
        present[rows[ok], vals[ok]] = True
        # little-endian bit order: candidate 8m + j is bit j of byte m,
        # so byte m of a row is byte m % 4 of word m // 4
        packed = np.packbits(present, axis=1, bitorder="little")
        out[lo : lo + n] = packed.view("<u4")
    return out


def pack_active_mask(active: torch.Tensor) -> torch.Tensor:
    """Pack (..., V_Z) bool active masks into (..., W) int32 words.

    The words are summed in int64 and wrapped into int32, so no uint32
    shift is needed; bit 31 lands in the sign.
    """
    v_z = active.shape[-1]
    w = words_for(v_z)
    lead = active.shape[:-1]
    padded = torch.zeros((*lead, w * 32), dtype=torch.int64, device=active.device)
    padded[..., :v_z] = active.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=active.device) << torch.arange(
        32, dtype=torch.int64, device=active.device
    )
    words = torch.sum(padded.reshape(*lead, w, 32) * weights, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_mask(words: torch.Tensor, v_z: int) -> torch.Tensor:
    """Inverse of `pack_active_mask` for a (W,) word vector."""
    w = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)[None, :]
    bits = torch.bitwise_right_shift(words[:, None], shifts) & 1
    return bits.reshape(w * 32)[:v_z].to(torch.bool)
