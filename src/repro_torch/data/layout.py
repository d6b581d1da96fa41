"""Randomized block layout (paper Sec 4.2, Challenge 1).

Port of `repro.data.layout`: a random permutation of the tuples, cut
into fixed-size blocks, plus the packed presence bitmap for AnyActive.
The arrays stay host-side numpy, bit for bit the reference's for the
same seed (the bitmap is uint32 here; block sources reinterpret it as
int32 when they move it to a device). The bitmap is built in chunks of
blocks, so its peak memory does not grow with the dataset.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitmap import build_block_bitmap

__all__ = ["BlockedDataset", "block_layout", "DEFAULT_BLOCK_TUPLES"]

# 4 KiB disk blocks at 8 bytes per (z, x) tuple, as in the reference.
DEFAULT_BLOCK_TUPLES = 512


@dataclasses.dataclass
class BlockedDataset:
    z_blocks: np.ndarray  # (num_blocks, block_size) int32, -1 padded
    x_blocks: np.ndarray  # (num_blocks, block_size) int32, -1 padded
    bitmap: np.ndarray  # (num_blocks, W) uint32
    v_z: int
    v_x: int

    @property
    def num_blocks(self) -> int:
        return self.z_blocks.shape[0]

    @property
    def block_size(self) -> int:
        return self.z_blocks.shape[1]

    @property
    def num_tuples(self) -> int:
        return int((self.z_blocks >= 0).sum())

    def shard(self, num_shards: int, shard_id: int) -> "BlockedDataset":
        """Contiguous block range owned by one data-parallel worker."""
        nb = self.num_blocks
        per = -(-nb // num_shards)
        lo, hi = shard_id * per, min((shard_id + 1) * per, nb)
        return BlockedDataset(
            z_blocks=self.z_blocks[lo:hi],
            x_blocks=self.x_blocks[lo:hi],
            bitmap=self.bitmap[lo:hi],
            v_z=self.v_z,
            v_x=self.v_x,
        )


def block_layout(
    z: np.ndarray,
    x: np.ndarray,
    *,
    v_z: int,
    v_x: int,
    block_size: int = DEFAULT_BLOCK_TUPLES,
    seed: int = 0,
    shuffle: bool = True,
) -> BlockedDataset:
    """Random permutation + blocking + chunked bitmap build."""
    n = len(z)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    z = np.asarray(z, np.int32)[order]
    x = np.asarray(x, np.int32)[order]
    del order

    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        z = np.concatenate([z, np.full(pad, -1, np.int32)])
        x = np.concatenate([x, np.full(pad, -1, np.int32)])
    z_blocks = z.reshape(nb, block_size)
    x_blocks = x.reshape(nb, block_size)
    bitmap = build_block_bitmap(z_blocks, v_z)
    return BlockedDataset(z_blocks=z_blocks, x_blocks=x_blocks, bitmap=bitmap, v_z=v_z, v_x=v_x)
