"""Block-selection policies (paper Sec 4.2 & 5.2).

Port of `repro.core.policies`. Given the packed active words and a
lookahead window of blocks, a policy decides which blocks to read; the
window's padding rows and the blocks already read are never marked:

  * scan      — read every block (ScanMatch / SlowMatch / Scan)
  * anyactive — read a block iff it holds a tuple of an active candidate,
                over the whole window against the packed bitmap (Alg. 3)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["mark_window"]


def mark_window(
    wd, active_words: torch.Tensor, read_mask: torch.Tensor, *, policy: str
) -> torch.Tensor:
    """(L,) bool final read-marks for a lookahead window of L blocks
    (a `WindowData`): the valid blocks not yet in ``read_mask`` that the
    policy reads. One kernel-A launch on the card."""
    if policy == "scan":
        return ops.mark_blocks(wd.indices, wd.valid, read_mask)
    if policy == "anyactive":
        return ops.mark_blocks(
            wd.indices, wd.valid, read_mask, wd.bitmap, active_words, by_id=wd.bitmap_by_id
        )
    raise ValueError(f"unknown policy {policy!r}")
