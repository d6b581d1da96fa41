"""Activation-distribution drift monitoring — the paper's matcher applied
to the training loop itself.

Candidates Z = monitored tensors (per-layer activations / gradients),
groups X = histogram bins over a fixed range, target Q = the reference
distribution captured from a known-good step. Each monitoring tick
histograms the current tensors (kernel B at V_Z = 1 on the card, one
launch a tensor), and Theorem 1 turns the distance into a calibrated
drift test: we flag a tensor only when its empirical distribution is
PROVABLY (at confidence 1 - delta) further than `drift_eps` from the
reference — i.e. the tensor's deviation bound eps(n) plus drift_eps is
exceeded.

Port of `repro.train.monitor`. Bin ids follow XLA's saturating
float-to-int conversion on every device: NaN lands in bin 0, +inf and
values at or past ``hi`` in bin ``bins - 1``, -inf in bin 0. The
clamping happens in float, before the cast, because PyTorch's cast of
NaN, inf or a huge value to int32 is not saturating on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.kernels import ops

__all__ = ["ActivationMonitor"]


def _bin_ids(x: torch.Tensor, lo: float, hi: float, bins: int) -> torch.Tensor:
    """(N,) int32 bin ids of ``x`` flattened: ``floor((x - lo) / (hi -
    lo) * bins)`` in f32, clipped to [0, bins - 1], NaN to 0."""
    xf = x.reshape(-1).to(torch.float32)
    # a tensor divisor keeps the division a true division on every device
    width = torch.tensor(hi - lo, dtype=torch.float32, device=xf.device)
    t = torch.floor((xf - lo) / width * bins)
    t = torch.clamp(torch.nan_to_num(t, nan=0.0), 0, bins - 1)
    return t.to(torch.int32)


@dataclasses.dataclass
class ActivationMonitor:
    names: List[str]
    bins: int = 64
    lo: float = -8.0
    hi: float = 8.0
    delta: float = 0.01
    drift_eps: float = 0.15
    reference: Optional[np.ndarray] = None  # (num_tensors, bins)

    def _histogram(self, tensors: Dict[str, torch.Tensor]) -> np.ndarray:
        rows = []
        for name in self.names:
            ids = _bin_ids(tensors[name], self.lo, self.hi, self.bins)
            h = ops.histogram(None, ids, v_z=1, v_x=self.bins)[0]
            rows.append(h.cpu().numpy())
        return np.stack(rows)

    def capture_reference(self, tensors: Dict[str, torch.Tensor]) -> None:
        h = self._histogram(tensors)
        self.reference = h / np.maximum(h.sum(axis=1, keepdims=True), 1.0)

    def check(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, dict]:
        """Returns per-tensor {distance, bound, drifted}. `drifted` is a
        calibrated decision: true iff d(emp, ref) - eps(n) > drift_eps,
        which by Theorem 1 holds with prob < delta under no-drift."""
        if self.reference is None:
            raise RuntimeError("capture_reference first")
        h = self._histogram(tensors)
        out = {}
        per_tensor_delta = self.delta / max(len(self.names), 1)
        for i, name in enumerate(self.names):
            n = h[i].sum()
            emp = h[i] / max(n, 1.0)
            d = float(np.abs(emp - self.reference[i]).sum())
            eps_n = float(bounds.theorem1_epsilon(n, per_tensor_delta, self.bins))
            out[name] = {
                "distance": d,
                "sampling_bound": eps_n,
                "drifted": d - eps_n > self.drift_eps,
            }
        return out
