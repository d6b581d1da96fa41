"""Entry points of the kernels package, dispatched by the tensor's device.

Port of `repro.kernels.ops`. A CUDA tensor launches the hand-written
kernel, or raises: there is no fallback to the plain version. A CPU
tensor runs the plain PyTorch version (`ref` / `metrics`), which is how
the tests hold the port against the JAX reference on a machine without
a GPU.

The ingest and tau entry points take a ``plan`` with the reference's
meaning (`repro_torch.kernels.autotune`): "auto" (the default) looks up
the plan registered for the shape in the tensor's backend's plan file
(a lookup cached by shape), "default" or None pins `autotune.DEFAULT_TAU`
/ `DEFAULT_INGEST` (one batched kernel-C launch, the fused ingest: what
ran before plans existed), and a plan instance passes through.

  op                      CUDA                         CPU
  ----------------------  ---------------------------  ---------------------------
  ingest_counts           kernel B (plan: or its       histogram.ingest_counts_ref
                          histogram form + adds)       (or its two-step form)
  histogram               kernel B, no input counts    ref.histogram_ref
  histogram_with_rowsums  kernel B, no input counts    ref.histogram_with_rowsums_ref
                          (impl="matmul": ref.histogram_matmul on either device)
  distance_multi          kernel C (plan: branch,      metrics.distance_multi_ref
                          uint16 form, Q launches      (plan: unrolled, xla,
                          at Q = 1)                    uint16 counts)
  l1_distance_multi       distance_multi, metric l1    the same
  l1_distance             kernel C, Q = 1              ref.l1_distance_ref
  mark_blocks             kernel A                     ref.mark_blocks_ref
  anyactive               kernel A, no ids or masks    ref.anyactive_ref
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import anyactive as _anyactive
from repro_torch.kernels import autotune
from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import metrics, ref

__all__ = [
    "ingest_counts",
    "histogram",
    "histogram_with_rowsums",
    "distance_multi",
    "l1_distance",
    "l1_distance_multi",
    "mark_blocks",
    "anyactive",
    "KERNELS",
]

# Every CUDA kernel of the package, with its launch count: kernel C
# counts its narrow and wide branches and its f32 and uint16 forms apart.
KERNELS = {
    "anyactive": _anyactive.KERNEL,
    "histogram": _histogram.KERNEL,
    "distance_multi": metrics.KERNEL,
    "distance_multi_u16": metrics.KERNEL_U16,
    "distance_wide": metrics.KERNEL_WIDE,
    "distance_wide_u16": metrics.KERNEL_WIDE_U16,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}; use 'cuda' or 'cpu'")


def ingest_counts(
    counts: torch.Tensor, n: torch.Tensor, z_idx: torch.Tensor, x_idx: torch.Tensor,
    *, v_z: int, v_x: int, plan="auto",
) -> tuple:
    """(counts + hist(z, x), n + rowsum(hist)) in new tensors; the inputs
    are left as they were and out-of-range ids are dropped. ``plan``
    picks the fused or the two-step form (an `autotune.IngestPlan`)."""
    ingest_plan = autotune.coerce_ingest_plan(plan, v_z, v_x, autotune.backend_of(counts))
    return autotune.run_ingest(
        z_idx, x_idx, v_z=v_z, v_x=v_x, plan=ingest_plan, counts=counts, n=n
    )


def histogram(z_idx: torch.Tensor, x_idx: torch.Tensor, *, v_z: int, v_x: int) -> torch.Tensor:
    """(V_Z, V_X) f32 histogram of (z, x) pairs; out-of-range ids dropped."""
    if _on_cuda(z_idx):
        return _histogram.histogram(z_idx, x_idx, v_z=v_z, v_x=v_x)
    return ref.histogram_ref(z_idx, x_idx, v_z=v_z, v_x=v_x)


def histogram_with_rowsums(
    z_idx: torch.Tensor, x_idx: torch.Tensor, *, v_z: int, v_x: int, plan="auto",
    impl: str = "auto", onehot_dtype=torch.float32,
) -> tuple:
    """((V_Z, V_X), (V_Z,)) histogram + row-sum delta: one pass, or the
    histogram and a row reduction under an unfused ``plan``.
    ``impl="matmul"`` is the plain one-hot product
    (`ref.histogram_matmul`, ``onehot_dtype`` its one-hots, f32 counts) on
    either device and bypasses the plan; "auto" dispatches by device."""
    if impl == "matmul":
        counts = ref.histogram_matmul(z_idx, x_idx, v_z=v_z, v_x=v_x, onehot_dtype=onehot_dtype)
        return counts, torch.sum(counts, dim=1)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'matmul', got {impl!r}")
    ingest_plan = autotune.coerce_ingest_plan(plan, v_z, v_x, autotune.backend_of(z_idx))
    return autotune.run_ingest(z_idx, x_idx, v_z=v_z, v_x=v_x, plan=ingest_plan)


def distance_multi(
    counts: torch.Tensor, q_hat: torch.Tensor, *, metric: str = "l1", plan="auto"
) -> torch.Tensor:
    """(Q, V_Z) f32 batched distances for a (Q, V_X) target matrix, in
    the launches ``plan`` (an `autotune.TauPlan`) picks; every plan gives
    the same tau on integer-valued counts (the wide branch within 3e-6)."""
    tau_plan = autotune.coerce_tau_plan(
        plan, counts.shape[0], counts.shape[1], q_hat.shape[0], metric,
        autotune.backend_of(counts),
    )
    return autotune.run_tau(counts, q_hat, plan=tau_plan, metric=metric)


def l1_distance_multi(counts: torch.Tensor, q_hat: torch.Tensor, *, plan="auto") -> torch.Tensor:
    """`distance_multi` pinned to metric="l1"."""
    return distance_multi(counts, q_hat, metric="l1", plan=plan)


def l1_distance(counts: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
    """(V_Z,) f32 tau_i = ||normalize(counts_i) - q_hat||_1 (Q = 1)."""
    if _on_cuda(counts):
        return metrics.distance(counts, q_hat, metric="l1")
    return ref.l1_distance_ref(counts, q_hat)


def mark_blocks(
    indices: torch.Tensor,
    valid: torch.Tensor,
    read_mask: torch.Tensor,
    bitmap: Optional[torch.Tensor] = None,
    active_words: Optional[torch.Tensor] = None,
    *,
    by_id: bool = False,
) -> torch.Tensor:
    """(L,) bool final read-marks of a window, ``valid &
    ~read_mask[indices] & AnyActive(row_i)``: row_i is
    ``bitmap[indices[i]]`` when ``by_id`` (the whole table) and
    ``bitmap[i]`` otherwise (a gathered window); no bitmap and no active
    words leaves ``valid & ~read_mask[indices]`` (scan)."""
    if _on_cuda(indices):
        return _anyactive.mark_blocks(
            indices, valid, read_mask, bitmap, active_words, by_id=by_id
        )
    return ref.mark_blocks_ref(indices, valid, read_mask, bitmap, active_words, by_id=by_id)


def anyactive(bitmap: torch.Tensor, active_words: torch.Tensor) -> torch.Tensor:
    """(num_blocks,) bool AnyActive marks from a packed bitmap."""
    if _on_cuda(bitmap):
        return _anyactive.anyactive(bitmap, active_words)
    return ref.anyactive_ref(bitmap, active_words)
