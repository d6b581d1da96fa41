"""Block-selection policies (paper Sec 4.2 & 5.2).

Port of `repro.core.policies`. Given the packed active words and a
lookahead window of blocks, a policy decides which blocks to read:

  * scan      — read every block (ScanMatch / SlowMatch / Scan)
  * anyactive — read a block iff it holds a tuple of an active candidate,
                over the whole window against the packed bitmap (Alg. 3)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["mark_window"]


def mark_window(
    bitmap_window: torch.Tensor, active_words: torch.Tensor, *, policy: str
) -> torch.Tensor:
    """(L,) bool read-marks for a lookahead window of L blocks."""
    if policy == "scan":
        return torch.ones((bitmap_window.shape[0],), dtype=torch.bool, device=bitmap_window.device)
    if policy == "anyactive":
        return ops.anyactive(bitmap_window, active_words)
    raise ValueError(f"unknown policy {policy!r}")
