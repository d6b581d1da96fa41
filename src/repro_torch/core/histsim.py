"""HistSim (Algorithm 1): round-based top-k histogram matching.

Port of `repro.core.histsim`. The state is a fixed-shape tuple of
tensors; each round is

    ingest   — add a (padded) batch of (z, x) samples into the
               per-candidate counts and their row sums (kernel B)
    stats    — distances tau_i (kernel C), deviations eps_i, failure
               bounds delta_i, delta_upper, active set (Sec 3.2-3.4)

Termination (``delta_upper < delta``) is decided on the host. The
counts are target-independent, which is what lets
`repro_torch.core.multiquery` share them across query slots.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import deviations as dev
from repro_torch.core.bitmap import pack_active_mask
from repro_torch.kernels import ops

__all__ = [
    "HistSimParams",
    "HistSimState",
    "init_state",
    "ingest",
    "stats_step",
    "run_round",
    "top_k_ids",
]


@dataclasses.dataclass(frozen=True)
class HistSimParams:
    """Static configuration of Problem 1 (k, eps, delta) plus dimensions."""

    v_z: int  # number of candidates |V_Z|
    v_x: int  # histogram support |V_X|
    k: int  # matches to return
    eps: float = 0.06  # paper default
    delta: float = 0.01  # paper default
    criterion: str = "histsim"  # "histsim" (sum delta_i) | "slowmatch" (max delta_i)

    def __post_init__(self):
        if not (0 < self.k <= self.v_z):
            raise ValueError(f"need 0 < k <= V_Z, got k={self.k} V_Z={self.v_z}")
        if self.criterion not in ("histsim", "slowmatch"):
            raise ValueError(self.criterion)


class HistSimState(NamedTuple):
    counts: torch.Tensor  # (V_Z, V_X) f32 empirical counts r_i
    n: torch.Tensor  # (V_Z,) f32 samples per candidate n_i
    q_hat: torch.Tensor  # (V_X,) f32 normalized target
    tau: torch.Tensor  # (V_Z,) f32 distance estimates
    eps_i: torch.Tensor  # (V_Z,) f32 assigned deviations
    log_delta_i: torch.Tensor  # (V_Z,) f32
    delta_upper: torch.Tensor  # () f32
    active: torch.Tensor  # (V_Z,) bool — AnyActive candidates
    active_words: torch.Tensor  # (W,) int32 — packed active mask (uint32 bits)
    in_top_k: torch.Tensor  # (V_Z,) bool — current matching set M
    round_idx: torch.Tensor  # () int64


def init_state(params: HistSimParams, target, *, device=None) -> HistSimState:
    """Fresh state from an (unnormalized or normalized) target histogram."""
    device = resolve_device(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    q_hat = target / torch.clamp_min(torch.sum(target), 1e-30)
    v_z, v_x = params.v_z, params.v_x
    ones = torch.ones((v_z,), dtype=torch.bool, device=device)
    return HistSimState(
        counts=torch.zeros((v_z, v_x), dtype=torch.float32, device=device),
        n=torch.zeros((v_z,), dtype=torch.float32, device=device),
        q_hat=q_hat,
        tau=torch.full((v_z,), float(torch.sum(q_hat)), dtype=torch.float32, device=device),
        eps_i=torch.zeros((v_z,), dtype=torch.float32, device=device),
        log_delta_i=torch.zeros((v_z,), dtype=torch.float32, device=device),
        delta_upper=torch.tensor(float(v_z), dtype=torch.float32, device=device),
        active=ones,
        active_words=pack_active_mask(ones),
        in_top_k=torch.zeros((v_z,), dtype=torch.bool, device=device),
        round_idx=torch.zeros((), dtype=torch.int64, device=device),
    )


def ingest(state: HistSimState, z_idx, x_idx, *, params: HistSimParams) -> HistSimState:
    """Accumulate a padded batch of samples (lines 7-8 of Alg. 1): one
    kernel-B launch adds the counts and their row sums."""
    counts, n = ops.ingest_counts(
        state.counts, state.n, z_idx, x_idx, v_z=params.v_z, v_x=params.v_x
    )
    return state._replace(counts=counts, n=n)


def stats_step(state: HistSimState, *, params: HistSimParams) -> HistSimState:
    """One statistics-engine iteration (lines 8-14 of Alg. 1): the Q = 1
    case of the batched tau kernel, then the deviation assignment."""
    tau = ops.l1_distance_multi(state.counts, state.q_hat[None, :])[0]
    assign = dev.assign_deviations if params.criterion == "histsim" else dev.slowmatch_deviations
    d = assign(tau, state.n, k=params.k, eps=params.eps, delta=params.delta, v_x=params.v_x)
    return state._replace(
        tau=d.tau,
        eps_i=d.eps_i,
        log_delta_i=d.log_delta_i,
        delta_upper=d.delta_upper,
        active=d.active,
        active_words=pack_active_mask(d.active),
        in_top_k=d.in_top_k,
        round_idx=state.round_idx + 1,
    )


def run_round(state: HistSimState, z_idx, x_idx, *, params: HistSimParams) -> HistSimState:
    """ingest + stats in sequence: one full HistSim round."""
    return stats_step(ingest(state, z_idx, x_idx, params=params), params=params)


def should_terminate(state: HistSimState, params: HistSimParams) -> bool:
    """delta_upper < delta (line 6 of Alg. 1), decided on the host."""
    return bool(state.delta_upper < params.delta)


def top_k_ids(state: HistSimState, k: int) -> torch.Tensor:
    """The k candidate ids of M, closest first; ties lower index first."""
    return torch.sort(state.tau, stable=True).indices[:k]
