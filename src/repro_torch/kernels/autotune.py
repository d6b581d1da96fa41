"""Kernel plans: every launch choice of the kernels package, picked by
measured wall time.

Port of `repro.kernels.autotune`. Each dispatch decision of
`repro_torch.kernels.ops` is a *plan*, looked up per shape key in a
per-backend plan file and made by measurement:

  tau    — per ``(V_Z, V_X, Q, dtype, metric)``:
             * variant: "batched" (one kernel-C launch scores all Q
               targets), "unrolled" (Q launches at Q = 1, through
               `metrics.distance`) or "xla" (the one-broadcast PyTorch
               form, `metrics.distance_multi_xla`);
             * sweeps / x_tile: the branch. 0 takes the narrow branch
               while V_X <= min(x_tile, 1024), 1 forces it, 2 forces the
               wide branch (a block per row), the form that replaced the
               reference's forced two-sweep layout;
             * lowprec: kernel C's uint16 form behind the overflow gate.
               The counts are integer-valued f32; where max(counts) <=
               65535 the kernel reads their uint16 cast, else the f32
               counts. On the card the max, the compare and the cast are
               PyTorch ops and the kernel reads the flag itself, so the
               gate never reads back to the host; the plain version (CPU)
               branches on the host.
           ``z_tile`` is the reference's Pallas row tile. Kernel C picks
           its own grid (about one wave of row tiles, or a block per
           row), so the field steers nothing here and stays at the
           reference's default only so that plan files read alike.
  ingest — per ``(V_Z, V_X, dtype)``: fused (kernel B's one launch,
           histogram, row sums and both adds) or not (kernel B's
           histogram form, then ``torch.sum(delta, 1)`` and the two
           adds). ``s_tile`` and ``z_tile`` are the reference's Pallas
           one-hot-matmul tiles; kernel B is a scatter and has nothing
           they could steer, so they stay at the reference's defaults
           only so that plan files read alike.

Every candidate gives bitwise the same counts, and on integer-valued
counts the same tau bit for bit, except the wide branch and the xla
form on the card (within 3e-6, the reference's bar for its tiled
candidates). The "xla" variant is plain PyTorch, which the card's path
never runs: on CUDA it is unusable (`run_tau` warns and runs
`DEFAULT_TAU`) and `tau_candidates("cuda", ...)` leaves it out.
Selection is noise-robust as in the reference: the fastest candidate
wins only if it beats the comparator by ``margin``. For tau the
comparator is `DEFAULT_TAU` on the card, the launch made before plans
existed, and the reference's "unrolled" plan on the CPU; for ingest it
is the fused plan on both.

Backends are "cuda" and "cpu", each with its own registry (one process,
the tests, uses both); a tensor's device names its backend, and the
engine that runs there ("cuda": the kernels, "ref": the plain versions).
Plans live in ``benchmarks/results/tuned_torch/<backend>.json``, never
in the reference's ``tuned/``, whose plans mean other things. A missing
file gives the defaults silently; a stale schema, corrupt JSON, another
backend's file or a malformed entry give them with a warning.
``FASTMATCH_TORCH_PLANS_DIR`` points the registries elsewhere and
``FASTMATCH_TORCH_AUTOTUNE=1`` makes `resolve_plans` tune a missing key
and save it. `reload()` swaps the registries; eager code keeps no
compiled program, and a scheduler keeps the plans it resolved when it
was made.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import metrics, ref

__all__ = [
    "DEFAULT_INGEST",
    "DEFAULT_TAU",
    "IngestPlan",
    "PlanPair",
    "PlanRegistry",
    "TauPlan",
    "backend_of",
    "coerce_ingest_plan",
    "coerce_tau_plan",
    "default_backend",
    "get_ingest_plan",
    "get_tau_plan",
    "ingest_candidates",
    "ingest_key",
    "plan_path",
    "plans_dir",
    "registry",
    "reload",
    "resolve_plans",
    "run_ingest",
    "run_tau",
    "tau_bytes",
    "tau_candidates",
    "tau_key",
    "tau_launches",
    "tune_ingest",
    "tune_tau",
]

# Schema 2, as the reference's: tau keys carry the metric.
PLAN_SCHEMA = 2
TAU_VARIANTS = ("batched", "unrolled", "xla")
# 2**16 - 1: every integer-valued f32 at or below it round-trips uint16.
_U16_MAX = 65535.0
# Single-block V_X bound of the Q = 1 launch the "unrolled" variant stacks.
_UNROLLED_MAX_VX = metrics.MAX_SINGLE_BLOCK_VX
# A non-comparator candidate must beat the comparator by this fraction.
DEFAULT_MARGIN = 0.07


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TauPlan:
    """One tau (distance) dispatch decision. Hashable."""

    variant: str = "batched"  # "batched" | "unrolled" | "xla"
    z_tile: int = 256  # the reference's Pallas row tile; steers nothing here
    x_tile: int = 4096  # single-sweep bound, with the narrow branch's 1024
    sweeps: int = 0  # 0 = auto, 1 = narrow branch, 2 = wide branch
    lowprec: bool = False  # uint16 counts behind the overflow gate

    def validate(self) -> None:
        if self.variant not in TAU_VARIANTS:
            raise ValueError(f"unknown tau variant {self.variant!r}; have {TAU_VARIANTS}")
        if self.z_tile < 8:
            raise ValueError(f"need z_tile >= 8, got {self.z_tile}")
        if self.x_tile % 128 != 0 or self.x_tile <= 0:
            raise ValueError(f"x_tile must be a positive lane multiple of 128, got {self.x_tile}")
        if self.sweeps not in (0, 1, 2):
            raise ValueError(f"sweeps must be 0 (auto), 1 or 2, got {self.sweeps}")


@dataclasses.dataclass(frozen=True)
class IngestPlan:
    """One ingest (histogram + row sums + adds) dispatch decision."""

    fused: bool = True  # kernel B's one launch vs its histogram + a row reduction
    s_tile: int = 512  # the reference's Pallas sample tile; steers nothing here
    z_tile: int = 256  # the reference's Pallas row tile; steers nothing here

    def validate(self) -> None:
        if self.s_tile < 8:
            raise ValueError(f"need s_tile >= 8, got {self.s_tile}")
        if self.z_tile < 8:
            raise ValueError(f"need z_tile >= 8, got {self.z_tile}")


@dataclasses.dataclass(frozen=True)
class PlanPair:
    """The (tau, ingest) pair one serving round consumes."""

    tau: TauPlan = dataclasses.field(default_factory=lambda: DEFAULT_TAU)
    ingest: IngestPlan = dataclasses.field(default_factory=lambda: DEFAULT_INGEST)


# The defaults are the launches made before plans existed: one batched
# kernel-C launch with its own tile choice, the fused ingest.
DEFAULT_TAU = TauPlan()
DEFAULT_INGEST = IngestPlan()


def tau_key(v_z: int, v_x: int, q: int, dtype: str = "float32", metric: str = "l1") -> str:
    return f"vz={v_z},vx={v_x},q={q},dtype={dtype},metric={metric}"


def ingest_key(v_z: int, v_x: int, dtype: str = "float32") -> str:
    return f"vz={v_z},vx={v_x},dtype={dtype}"


def tau_bytes(v_z: int, v_x: int, q: int, plan: TauPlan, metric: str = "l1") -> int:
    """The reference's analytic device bytes per tau round under
    ``plan``: one counts pass (batched single-sweep, xla), two (a
    two-sweep layout) or Q (unrolled), plus targets in and taus out;
    lowprec halves the counts term."""
    vx_pad = max(128, -(-v_x // 128) * 128)
    if plan.variant == "unrolled":
        passes = q
    elif plan.variant == "xla":
        passes = 1
    else:
        passes = 2 if plan.sweeps == 2 or (plan.sweeps == 0 and vx_pad > plan.x_tile) else 1
    return metrics.coerce_metric(metric).bytes_model(
        v_z, v_x, q, passes=passes, counts_itemsize=(2 if plan.lowprec else 4)
    )


# ---------------------------------------------------------------------------
# Executors: the only code plans dispatch to, and what the tuner measures
# ---------------------------------------------------------------------------


def backend_of(t: torch.Tensor) -> str:
    """"cuda" or "cpu", the backend of the device ``t`` lies on; "meta"
    (the dry run's shapes-only tensors) takes the CPU's plain executors."""
    if t.device.type == "meta":
        return "cpu"
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}; use 'cuda' or 'cpu'")
    return t.device.type


def _engine_of(t: torch.Tensor, engine: Optional[str]) -> str:
    """The engine a tensor's device runs: the kernels on CUDA, the plain
    versions on the CPU. An engine named for the other device raises."""
    own = "cuda" if backend_of(t) == "cuda" else "ref"
    if engine is not None and engine != own:
        raise ValueError(f"engine {engine!r} does not run on {t.device} (its engine is {own!r})")
    return own


def _tau_inner(plan: TauPlan, *, engine: str, metric: str = "l1") -> Callable:
    """(counts, q_hat, gate) -> (Q, V_Z) tau for one variant. ``gate`` is
    kernel C's overflow gate for uint16 counts on the card, else None."""
    if plan.variant == "xla":
        return lambda c, q, gate=None: metrics.distance_multi_xla(c, q, metric=metric)
    if engine == "cuda":
        launch = dict(metric=metric, x_tile=plan.x_tile, sweeps=plan.sweeps)
        if plan.variant == "unrolled":
            return lambda c, q, gate=None: torch.stack(
                [metrics.distance(c, q[i], gate=gate, **launch) for i in range(q.shape[0])]
            )
        return lambda c, q, gate=None: metrics.distance_multi(c, q, gate=gate, **launch)
    if plan.variant == "unrolled":
        return lambda c, q, gate=None: torch.stack(
            [metrics.distance_ref(c, q[i], metric=metric) for i in range(q.shape[0])]
        )
    return lambda c, q, gate=None: metrics.distance_multi_ref(c, q, metric=metric)


def _tau_usable(plan: TauPlan, *, engine: str, v_x: int) -> bool:
    """Whether ``plan`` can run at all for this engine and V_X."""
    if engine == "cuda":
        if plan.variant == "xla":
            return False  # plain PyTorch: never on the card's path
        if plan.variant == "unrolled" and v_x > _UNROLLED_MAX_VX:
            return False  # the Q = 1 launch keeps the reference's single-block bound
        if plan.sweeps == 1 and v_x > metrics.NARROW_MAX_VX:
            return False  # the narrow branch cannot hold the row
    if plan.sweeps == 1 and max(128, -(-v_x // 128) * 128) > plan.x_tile:
        return False  # forced single-sweep cannot cover a lane-tiled V_X
    return True


def run_tau(
    counts: torch.Tensor,
    q_hat: torch.Tensor,
    *,
    plan: TauPlan,
    engine: Optional[str] = None,
    metric: str = "l1",
) -> torch.Tensor:
    """One (Q, V_Z) tau computation per ``plan`` and ``metric``, on the
    engine of the counts' device. An unusable plan falls back to
    `DEFAULT_TAU` with a warning: plans steer speed, never results or
    availability."""
    plan.validate()
    engine = _engine_of(counts, engine)
    if not _tau_usable(plan, engine=engine, v_x=counts.shape[1]):
        _warn_once(
            f"tau plan {plan} unusable for engine={engine} "
            f"V_X={counts.shape[1]}; falling back to defaults"
        )
        plan = DEFAULT_TAU
    inner = _tau_inner(plan, engine=engine, metric=metric)
    if not plan.lowprec or counts.numel() == 0:
        return inner(counts, q_hat)
    if engine == "ref":
        # the plain version's gate branches on the host, as lax.cond would
        if bool(torch.max(counts) <= _U16_MAX):
            return inner(counts.to(torch.uint16), q_hat)
        return inner(counts, q_hat)
    # on the card the flag stays there: kernel C's uint16 form reads it and
    # takes the f32 counts where the uint16 cast would have wrapped
    fits = torch.amax(counts) <= _U16_MAX
    return inner(counts.to(torch.uint16), q_hat, gate=(counts, fits))


def tau_launches(plan: TauPlan, v_x: int, q: int) -> Dict[str, int]:
    """The kernel-C launches, by `ops.KERNELS` name, that one `run_tau`
    call under a usable ``plan`` makes on the card at (Q, V_X)."""
    wide = metrics.wide_branch(v_x, x_tile=plan.x_tile, sweeps=plan.sweeps)
    name = ("distance_wide" if wide else "distance_multi") + ("_u16" if plan.lowprec else "")
    return {name: q if plan.variant == "unrolled" else 1}


def run_ingest(
    z_idx: torch.Tensor,
    x_idx: torch.Tensor,
    *,
    v_z: int,
    v_x: int,
    plan: IngestPlan,
    engine: Optional[str] = None,
    counts: Optional[torch.Tensor] = None,
    n: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((V_Z, V_X), (V_Z,)) histogram and row sums of the (z, x) pairs,
    per ``plan``; with ``counts`` and ``n``, the round's ingest,
    ``(counts + hist, n + rowsum)`` in new tensors. fused=True is kernel
    B's one launch (on the CPU the reference's one-pass form); False is
    the histogram, then a row reduction and the adds. Both are exact on
    integer counts."""
    plan.validate()
    if (counts is None) != (n is None):
        raise ValueError("pass counts and n together, or neither")
    on_card = _engine_of(z_idx, engine) == "cuda"
    if plan.fused:
        if counts is None:
            hist = _histogram.histogram_with_rowsums if on_card else ref.histogram_with_rowsums_ref
            return hist(z_idx, x_idx, v_z=v_z, v_x=v_x)
        ingest = _histogram.ingest_counts if on_card else _histogram.ingest_counts_ref
        return ingest(counts, n, z_idx, x_idx, v_z=v_z, v_x=v_x)
    hist = _histogram.histogram if on_card else ref.histogram_ref
    delta = hist(z_idx, x_idx, v_z=v_z, v_x=v_x)
    rows = torch.sum(delta, dim=1)
    if counts is None:
        return delta, rows
    return counts + delta, n + rows


_warned: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, stacklevel=3)


# ---------------------------------------------------------------------------
# Registry: the committed JSON artifact
# ---------------------------------------------------------------------------


def default_backend() -> str:
    """"cuda" where a card is present, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def plans_dir() -> pathlib.Path:
    """``FASTMATCH_TORCH_PLANS_DIR`` or the committed repo location."""
    env = os.environ.get("FASTMATCH_TORCH_PLANS_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/autotune.py -> repo root / benchmarks/results/tuned_torch
    return pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / "results" / "tuned_torch"


def plan_path(backend: Optional[str] = None) -> pathlib.Path:
    return plans_dir() / f"{backend or default_backend()}.json"


def _plan_from_entry(entry: dict, cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    plan = cls(**{k: v for k, v in entry.items() if k in fields})
    plan.validate()
    return plan


class PlanRegistry:
    """All tuned plans for one backend, plus their provenance.

    Lookup misses return the defaults silently (an untuned shape is
    normal); structural problems (stale schema, corrupt JSON, another
    backend's file, a malformed entry) fall back with a warning, never an
    exception.
    """

    def __init__(self, backend: Optional[str] = None):
        self.backend = backend or default_backend()
        self.tau: Dict[str, TauPlan] = {}
        self.ingest: Dict[str, IngestPlan] = {}
        self.meta: dict = {}
        self.path: Optional[pathlib.Path] = None

    # -- persistence -------------------------------------------------------

    @classmethod
    def load(cls, path: Optional[pathlib.Path] = None, backend: Optional[str] = None
             ) -> "PlanRegistry":
        reg = cls(backend=backend)
        reg.path = pathlib.Path(path) if path is not None else plan_path(reg.backend)
        if not reg.path.exists():
            return reg
        try:
            doc = json.loads(reg.path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            _warn_once(f"unreadable kernel-plan file {reg.path}: {e}; using default plans")
            return reg
        if not isinstance(doc, dict) or doc.get("schema") != PLAN_SCHEMA:
            _warn_once(
                f"kernel-plan file {reg.path} has schema "
                f"{doc.get('schema') if isinstance(doc, dict) else '<not a dict>'!r}, "
                f"expected {PLAN_SCHEMA}; using default plans"
            )
            return reg
        if doc.get("backend") not in (None, reg.backend):
            _warn_once(
                f"kernel-plan file {reg.path} was tuned for backend "
                f"{doc.get('backend')!r}, running on {reg.backend!r}; using default plans"
            )
            return reg
        reg.meta = {k: v for k, v in doc.items() if k not in ("tau", "ingest")}
        for key, entry in (doc.get("tau") or {}).items():
            try:
                reg.tau[key] = _plan_from_entry(entry, TauPlan)
            except (TypeError, ValueError, AttributeError) as e:
                _warn_once(f"dropping malformed tau plan {key!r} in {reg.path}: {e}")
        for key, entry in (doc.get("ingest") or {}).items():
            try:
                reg.ingest[key] = _plan_from_entry(entry, IngestPlan)
            except (TypeError, ValueError, AttributeError) as e:
                _warn_once(f"dropping malformed ingest plan {key!r} in {reg.path}: {e}")
        return reg

    def save(self, path: Optional[pathlib.Path] = None) -> pathlib.Path:
        path = pathlib.Path(path) if path is not None else (self.path or plan_path(self.backend))
        path.parent.mkdir(parents=True, exist_ok=True)
        doc = dict(schema=PLAN_SCHEMA, backend=self.backend, **{
            k: v for k, v in self.meta.items() if k not in ("schema", "backend")
        })
        doc["tau"] = {k: dataclasses.asdict(v) for k, v in sorted(self.tau.items())}
        doc["ingest"] = {k: dataclasses.asdict(v) for k, v in sorted(self.ingest.items())}
        path.write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")
        self.path = path
        return path

    # -- lookup ------------------------------------------------------------

    def tau_plan(self, v_z: int, v_x: int, q: int, dtype: str = "float32",
                 metric: str = "l1") -> TauPlan:
        return self.tau.get(tau_key(v_z, v_x, q, dtype, metric), DEFAULT_TAU)

    def ingest_plan(self, v_z: int, v_x: int, dtype: str = "float32") -> IngestPlan:
        return self.ingest.get(ingest_key(v_z, v_x, dtype), DEFAULT_INGEST)

    def decisions(self) -> str:
        """Canonical serialization of every dispatch decision (no timing
        metadata): the byte-stable artifact compared across loads and
        processes."""
        return json.dumps(
            dict(
                backend=self.backend,
                tau={k: dataclasses.asdict(v) for k, v in sorted(self.tau.items())},
                ingest={k: dataclasses.asdict(v) for k, v in sorted(self.ingest.items())},
            ),
            sort_keys=True,
        )


# One registry per backend, loaded lazily; "auto" lookups by shape, so a
# direct op call formats no key string. Both are emptied by `reload`.
_registries: Dict[str, PlanRegistry] = {}
_auto: Dict[tuple, object] = {}


def registry(backend: Optional[str] = None) -> PlanRegistry:
    """The process's plan registry for ``backend``, loaded lazily from
    `plan_path(backend)`."""
    backend = backend or default_backend()
    reg = _registries.get(backend)
    if reg is None:
        reg = _registries[backend] = PlanRegistry.load(backend=backend)
    return reg


def reload(path: Optional[pathlib.Path] = None, backend: Optional[str] = None) -> PlanRegistry:
    """Drop every registry and cached lookup, and load ``backend``'s
    afresh (from ``path`` if given). Schedulers made before keep the
    plans they resolved."""
    backend = backend or default_backend()
    _registries.clear()
    _auto.clear()
    reg = _registries[backend] = PlanRegistry.load(path=path, backend=backend)
    return reg


def get_tau_plan(v_z: int, v_x: int, q: int, dtype: str = "float32",
                 metric: str = "l1", backend: Optional[str] = None) -> TauPlan:
    return registry(backend).tau_plan(v_z, v_x, q, dtype, metric)


def get_ingest_plan(v_z: int, v_x: int, dtype: str = "float32",
                    backend: Optional[str] = None) -> IngestPlan:
    return registry(backend).ingest_plan(v_z, v_x, dtype)


def coerce_tau_plan(plan, v_z: int, v_x: int, q: int, metric: str = "l1",
                    backend: Optional[str] = None) -> TauPlan:
    """Resolve an ops-level ``plan`` argument: "auto" consults
    ``backend``'s registry, None/"default" pins `DEFAULT_TAU`, a
    `TauPlan` passes through."""
    if isinstance(plan, TauPlan):
        return plan
    if isinstance(plan, str) and plan == "auto":
        key = ("tau", backend or default_backend(), v_z, v_x, q, metric)
        hit = _auto.get(key)
        if hit is None:
            hit = _auto[key] = get_tau_plan(v_z, v_x, q, metric=metric, backend=key[1])
        return hit
    if plan is None or (isinstance(plan, str) and plan == "default"):
        return DEFAULT_TAU
    raise TypeError(f"plan must be 'auto', 'default', None or TauPlan, got {plan!r}")


def coerce_ingest_plan(plan, v_z: int, v_x: int, backend: Optional[str] = None) -> IngestPlan:
    if isinstance(plan, IngestPlan):
        return plan
    if isinstance(plan, str) and plan == "auto":
        key = ("ingest", backend or default_backend(), v_z, v_x)
        hit = _auto.get(key)
        if hit is None:
            hit = _auto[key] = get_ingest_plan(v_z, v_x, backend=key[1])
        return hit
    if plan is None or (isinstance(plan, str) and plan == "default"):
        return DEFAULT_INGEST
    raise TypeError(f"plan must be 'auto', 'default', None or IngestPlan, got {plan!r}")


def resolve_plans(
    v_z: int,
    v_x: int,
    q: int,
    *,
    n_samples: Optional[int] = None,
    dtype: str = "float32",
    metric: str = "l1",
    device=None,
) -> PlanPair:
    """The plans a scheduler resolves once, at construction, for the
    backend of ``device`` (the default backend when None): a registry
    lookup, and under ``FASTMATCH_TORCH_AUTOTUNE=1`` a tuning of any
    missing key on that device, saved to the plan file."""
    device = _tune_device(None, device)
    reg = registry(backend=device.type)
    tkey, ikey = tau_key(v_z, v_x, q, dtype, metric), ingest_key(v_z, v_x, dtype)
    if os.environ.get("FASTMATCH_TORCH_AUTOTUNE") == "1":
        dirty = False
        if tkey not in reg.tau:
            reg.tau[tkey], _ = tune_tau(v_z, v_x, q, metric=metric, device=device)
            dirty = True
        if ikey not in reg.ingest:
            reg.ingest[ikey], _ = tune_ingest(
                v_z, v_x, n_samples=n_samples or _default_ingest_samples(v_z, v_x),
                device=device,
            )
            dirty = True
        if dirty:
            _auto.clear()
            reg.save()
    return PlanPair(tau=reg.tau.get(tkey, DEFAULT_TAU), ingest=reg.ingest.get(ikey, DEFAULT_INGEST))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _default_ingest_samples(v_z: int, v_x: int) -> int:
    # lookahead-window-sized batches dominate production ingest; scale
    # with the matrix so tiny test shapes stay fast to tune.
    return int(min(65_536, max(4_096, v_z * v_x // 16)))


def _tune_device(engine: Optional[str], device) -> torch.device:
    if device is not None:
        device = torch.device(device)
    elif engine is not None:
        device = torch.device("cuda" if engine == "cuda" else "cpu")
    else:
        device = torch.device(default_backend())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def _measure(fns: Dict, *, reps: int, device: torch.device) -> Dict:
    """Median seconds per call of each of ``fns`` (candidate -> thunk)
    after one warm call each, every call ended by a device
    synchronisation: on a host-bound path the enqueue is part of what a
    plan costs. The candidates take turns, rep by rep, so a drift of the
    host's or the card's clocks while tuning weighs on all alike."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for fn in fns.values():
        fn()
        sync()
    t: Dict = {cand: [] for cand in fns}
    for _ in range(reps):
        for cand, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            sync()
            t[cand].append(time.perf_counter() - t0)
    return {cand: float(np.median(ts)) for cand, ts in t.items()}


def tau_candidates(engine: str, v_z: int, v_x: int, q: int) -> list:
    """The candidate space for one tau key. "ref" (the plain versions):
    the reference's variants x lowprec. "cuda": batched and unrolled x
    lowprec, and the batched launch forced onto the wide branch, in
    both forms."""
    cands = []
    for variant in TAU_VARIANTS:
        base = TauPlan(variant=variant)
        if not _tau_usable(base, engine=engine, v_x=v_x):
            continue
        cands.append(base)
        cands.append(dataclasses.replace(base, lowprec=True))
        if engine == "cuda" and variant == "batched":
            cands.append(TauPlan(variant="batched", sweeps=2))
            cands.append(TauPlan(variant="batched", sweeps=2, lowprec=True))
    return cands


def ingest_candidates(engine: str, v_z: int, v_x: int) -> list:
    """Fused or not; kernel B has no tile to tune."""
    return [IngestPlan(fused=True), IngestPlan(fused=False)]


def _tau_comparator(engine: str) -> TauPlan:
    """The plan `tune_tau` keeps unless another beats it by the margin:
    on the card `DEFAULT_TAU`, the launch made before plans existed; on
    the plain versions the reference's, the "unrolled" plan."""
    return DEFAULT_TAU if engine == "cuda" else TauPlan(variant="unrolled")


def _pick(timed: Dict, comparator, *, margin: float):
    """Fastest candidate, unless the comparator is within ``margin`` of it."""
    best = min(timed, key=timed.get)
    if comparator in timed and timed[comparator] <= timed[best] * (1.0 + margin):
        return comparator
    return best


def tune_tau(
    v_z: int,
    v_x: int,
    q: int,
    *,
    engine: Optional[str] = None,
    device=None,
    reps: int = 15,
    seed: int = 0,
    margin: float = DEFAULT_MARGIN,
    metric: str = "l1",
) -> Tuple[TauPlan, Dict[TauPlan, float]]:
    """Measure every tau candidate for one (key, metric) on ``device``
    (the engine's, or the default backend's); return (winner, timings).
    The reference's inputs and seed. `_tau_comparator` keeps its place
    unless beaten by ``margin``, so on the card a winner inside the
    measurement's noise never changes the main path's launch."""
    device = _tune_device(engine, device)
    engine = "cuda" if device.type == "cuda" else "ref"
    rng = np.random.default_rng(seed)
    counts = torch.from_numpy(rng.integers(0, 50, size=(v_z, v_x)).astype(np.float32))
    q_hat = torch.from_numpy(
        np.stack([rng.dirichlet(np.ones(v_x)).astype(np.float32) for _ in range(q)])
    )
    counts, q_hat = counts.to(device), q_hat.to(device)
    timed: Dict[TauPlan, float] = _measure(
        {c: (lambda c=c: run_tau(counts, q_hat, plan=c, engine=engine, metric=metric))
         for c in tau_candidates(engine, v_z, v_x, q)},
        reps=reps, device=device,
    )
    return _pick(timed, _tau_comparator(engine), margin=margin), timed


def tune_ingest(
    v_z: int,
    v_x: int,
    *,
    n_samples: Optional[int] = None,
    engine: Optional[str] = None,
    device=None,
    reps: int = 15,
    seed: int = 0,
    margin: float = DEFAULT_MARGIN,
) -> Tuple[IngestPlan, Dict[IngestPlan, float]]:
    """Measure every ingest candidate for one key as the round runs it
    (into counts and row sums); the comparator is the fused plan."""
    device = _tune_device(engine, device)
    engine = "cuda" if device.type == "cuda" else "ref"
    n = n_samples or _default_ingest_samples(v_z, v_x)
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.integers(-1, v_z, size=n).astype(np.int32)).to(device)
    x = torch.from_numpy(rng.integers(-1, v_x, size=n).astype(np.int32)).to(device)
    counts = torch.zeros((v_z, v_x), dtype=torch.float32, device=device)
    rows = torch.zeros((v_z,), dtype=torch.float32, device=device)
    timed: Dict[IngestPlan, float] = _measure(
        {c: (lambda c=c: run_ingest(z, x, v_z=v_z, v_x=v_x, plan=c, engine=engine,
                                    counts=counts, n=rows))
         for c in ingest_candidates(engine, v_z, v_x)},
        reps=reps, device=device,
    )
    return _pick(timed, IngestPlan(fused=True), margin=margin), timed
