"""Multi-pod dry run on the meta device: one rank's real step of every
(arch × shape × mesh) cell, its costs and its roofline on an H100.

Port of `repro.launch.dryrun`. The reference lowers and compiles each
cell with XLA on 512 placeholder host devices and reads the compiled
program's ``cost_analysis``, ``memory_analysis`` and post-SPMD HLO. The
port has no compiler: it runs the step itself, the port's own
`make_train_step`, ``prefill`` or ``decode_step`` (`launch.specs.
build_case`), for one rank of the production mesh
(`launch.mesh.make_virtual_mesh`: (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model")) on the "meta" device, where every
op propagates shapes and allocates nothing, and counts what the rank
would do:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the step (the
    matrix products, attention and convolutions, forward, backward and
    rematerialised: XLA's count adds the elementwise ops);
  * bytes accessed: every op's tensor arguments and results counted
    whole, views moving nothing (`_Accounting`). This is the unfused
    op-by-op count, so it is an upper bound on what XLA's fused program
    reads and writes;
  * collectives: the mesh's groups record each all-reduce
    (`core.distributed.Recorder`), by op and axis, with the reference's
    wire bytes (2 x the result for an all-reduce), in place of the
    reference's HLO parse (`hlo_parse` is not carried over);
  * memory: ``argument_bytes`` the rank's parameters, optimizer state,
    input rows and cache; ``temp_bytes`` the peak of the bytes held by
    storages the step allocated, each released when its last tensor
    dies (`_Accounting`); ``alias_bytes`` the results that are arguments
    updated in place (the train state, a transformer's decode cache: the
    reference's donated buffers); ``output_bytes`` the other results.

The meta run executes every layer, so the reference's 1- and 2-layer
unrolled compiles and their linear extrapolation (its ``cost_analysis``
counts a scanned loop body once) have no counterpart here: a stacked
(``scan_layers``) train cell reads each layer's slice in turn and is
counted as run. Train cells of the dense, MoE and vlm families run
stacked, as the reference compiles them.

The roofline's denominators are one NVIDIA H100 SXM's (named constants
below). Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fastmatch_round --mesh pod

Each cell writes one JSON under ``--out`` (``build/dryrun`` by default).
Nothing here needs a GPU or a process group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ALIASES, SHAPES, get_config, list_archs
from repro_torch.core.distributed import WIRE_FACTOR
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.launch.specs import build_case
from repro_torch.models import layers as Lyr

__all__ = ["cell_supported", "main", "measure", "run_cell", "run_fastmatch_cell"]

# Roofline denominators: one NVIDIA H100 SXM 80GB at its full power limit
# of 700 W (NVIDIA's data sheet; a card set below 700 W runs slower under
# load), dense rates without sparsity
CARD = "NVIDIA H100 SXM 80GB, 700 W power limit (data sheet)"
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way a GPU: NVLink 4 within an 8-GPU node
IB_BW = 400e9 / 8  # bytes/s: one 400 Gb/s InfiniBand link a GPU across nodes
NODE_GPUS = 8

SCANNABLE = ("dense", "moe", "vlm")
RESULTS = pathlib.Path("build/dryrun")
COST_METHOD = ("meta-device run of one rank's step: FlopCounterMode FLOPs; unfused op-by-op "
               "bytes (an upper bound on a fused program's); recorded all-reduces")
MEMORY_METHOD = ("arguments: the rank's parameters, optimizer state, input rows and cache; "
                 "temp: peak bytes of the storages the meta step allocated while alive")


def cell_supported(arch: str, shape_name: str) -> tuple:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: full-attention arch (see DESIGN.md)"
    return True, ""


def _axis_bandwidth(mesh, axis: str) -> float:
    """Bytes/s a rank moves over a group of ``axis`` ("+"-joined axes: the
    group over all of them). Ranks are numbered row-major over the mesh
    and a node holds NODE_GPUS consecutive ranks, so a group whose ranks
    span more than a node (the product of its axis's size and the sizes
    of the axes inside it) crosses InfiniBand, else NVLink."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    outer = min(names.index(a) for a in axis.split("+"))
    span = 1
    for a in names[outer:]:
        span *= sizes[a]
    return NVLINK_BW if span <= NODE_GPUS else IB_BW


class _Accounting(TorchDispatchMode):
    """Over one step on the meta device: ``bytes``, what each op reads and
    writes (every tensor argument and result counted whole; a view op
    moves nothing), and ``peak``, the most bytes held at once by the
    storages the step allocated (each from its first result until its
    last tensor dies; storages of ``outside`` tensors are not the
    step's)."""

    def __init__(self, outside=()):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = 0
        self._held = {t.untyped_storage()._cdata for t in outside}

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in self._held:
                self._held.add(st._cdata)
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, st._cdata, st.nbytes())
        return out


def _tensors(tree) -> list:
    """The tensors of a tree (dicts, lists, tuples, NamedTuples), once each."""
    seen, out = set(), []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def measure(fn, args, mesh, *, params=(), state=()) -> dict:
    """Run ``fn(*args)`` once on the meta device under ``mesh``'s recorder
    and the counters: FLOPs, bytes accessed, the collectives (payload by
    op and axis, wire bytes in the reference's form, the roofline's
    collective seconds), the memory terms (see the module docstring),
    and the elements of ``params`` and ``state`` the rank holds."""
    rec = mesh.recorder
    rec.reset()
    arguments = _tensors(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, _Accounting(arguments) as acc:
        out = fn(*args)
    run_s = time.perf_counter() - t0
    held = {t.untyped_storage()._cdata for t in arguments}
    results = _tensors(out)
    fresh = [t for t in results if t.untyped_storage()._cdata not in held]
    aliased = [t for t in results if t.untyped_storage()._cdata in held]
    coll_s = sum(WIRE_FACTOR.get(kind, 1) * e["bytes"] / _axis_bandwidth(mesh, axis)
                 for (kind, axis), e in rec.by_axis.items())
    return dict(
        flops=float(flops.get_total_flops()), bytes=float(acc.bytes),
        colls=rec.hlo_form(), coll_s=coll_s, totals=rec.totals(),
        by_axis={f"{kind}/{axis}": dict(e) for (kind, axis), e in sorted(rec.by_axis.items())},
        memory=dict(argument_bytes=_nbytes(arguments), output_bytes=_nbytes(fresh),
                    temp_bytes=acc.peak, alias_bytes=_nbytes(aliased)),
        params_held=sum(t.numel() for t in _tensors(params)),
        state_held=sum(t.numel() for t in _tensors(state)),
        run_s=run_s)


def _roofline(m: dict) -> dict:
    terms = {"compute": m["flops"] / PEAK_FLOPS, "memory": m["bytes"] / HBM_BW,
             "collective": m["coll_s"]}
    return {"t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"], "bottleneck": max(terms, key=terms.get)}


def _hardware() -> dict:
    return dict(card=CARD, peak_flops=PEAK_FLOPS, hbm_bytes_per_s=HBM_BW,
                nvlink_bytes_per_s=NVLINK_BW, ib_bytes_per_s=IB_BW, node_gpus=NODE_GPUS)


def _result(arch, shape, mesh_kind, mesh, profile, m, model_flops) -> dict:
    chips = int(mesh.mesh.numel())
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": chips, "profile": profile,
        "ok": True, "cost_method": COST_METHOD, "memory_method": MEMORY_METHOD,
        "coordinate": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
        "run_s": m["run_s"],
        "flops_per_device": m["flops"],
        "bytes_per_device": m["bytes"],
        "collective_bytes_per_device": float(sum(v["bytes"] for v in m["colls"].values())),
        "collectives": m["colls"],
        "collectives_by_axis": m["by_axis"],
        "memory": m["memory"],
        "params_held": m["params_held"], "state_held": m["state_held"],
        "roofline": _roofline(m),
        "hardware": _hardware(),
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / max(m["flops"], 1.0),
    }


def _print(res: dict) -> None:
    r, mem = res["roofline"], res["memory"]
    print(f"== {res['arch']} x {res['shape']} x {res['mesh']} ({res['chips']} chips, rank "
          f"{res['coordinate']}) [{res['cost_method']}] ==")
    print(f"memory: arguments {mem['argument_bytes'] / 1e9:.3f} GB, temp "
          f"{mem['temp_bytes'] / 1e9:.3f} GB, outputs {mem['output_bytes'] / 1e9:.3f} GB, "
          f"updated in place {mem['alias_bytes'] / 1e9:.3f} GB")
    print(f"costs: flops/dev={res['flops_per_device']:.4g} bytes/dev={res['bytes_per_device']:.4g} "
          f"coll_bytes/dev={res['collective_bytes_per_device']:.4g} "
          f"({sum(v['count'] for v in res['collectives'].values())} collectives)")
    print(f"roofline ({CARD}): compute={r['t_compute_s'] * 1e3:.3f}ms "
          f"memory={r['t_memory_s'] * 1e3:.3f}ms collective={r['t_collective_s'] * 1e3:.3f}ms "
          f"-> {r['bottleneck']}-bound; useful-FLOPs ratio {res['useful_flops_ratio']:.3f}; "
          f"meta run {res['run_s']:.1f}s")


def run_cell(arch: str, shape_name: str, mesh_kind: str, verbose: bool = True,
             profile: str = "baseline", coordinate=None) -> dict:
    """One (arch × shape) cell on the first rank of the production mesh
    ``mesh_kind`` ("pod" or "multipod"), or on the rank at
    ``coordinate`` (one index an axis: ranks whose heads are uneven do
    unequal work). Train cells of the dense, MoE and vlm families run
    under ``scan_layers``, as the reference compiles them."""
    mesh = make_virtual_mesh(multi_pod=mesh_kind == "multipod", coordinate=coordinate)
    try:
        cfg = get_config(arch)
        if SHAPES[shape_name].kind == "train" and cfg.family in SCANNABLE:
            cfg = dataclasses.replace(cfg, scan_layers=True)
        case = build_case(arch, shape_name, mesh, cfg=cfg, profile=profile)
        state = case.state
        m = measure(case.fn, case.args, mesh, params=list(case.model.parameters()),
                    state=state.opt_state if state is not None else ())
    finally:
        Lyr.set_tp_reduce_dtype(None)
    res = _result(arch, shape_name, mesh_kind, mesh, profile, m, case.model_flops)
    if verbose:
        _print(res)
    return res


def run_fastmatch_cell(mesh_kind: str, profile: str = "baseline", verbose: bool = True) -> dict:
    """The paper's own hot loop: one distributed HistSim round
    (`core.distributed.make_distributed_round`, its histogram the one-hot
    product, ``histogram_impl="matmul"``) at the reference's production
    query: |V_Z| = 7552 (TAXI's 7548 padded to /16), |V_X| = 128, a
    lookahead window of 512 blocks x 512 tuples a data shard, the counts
    split over "model". The kernel plans are the card's (`autotune`'s
    "cuda" plan file); on meta each kernel's plain version propagates
    the shapes."""
    from repro_torch.core.distributed import (
        make_distributed_round, multi_state_pspecs, place_leaf,
    )
    from repro_torch.core.multiquery import MultiQuerySpec, MultiQueryState, init_multi_state
    from repro_torch.kernels import autotune

    multi_pod = mesh_kind == "multipod"
    mesh = make_virtual_mesh(multi_pod=multi_pod)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    n_data_shards = 1
    for a in data_axes:
        n_data_shards *= sizes[a]
    v_z, v_x, per_shard = 7552, 128, 512 * 512
    n_samples = per_shard * n_data_shards
    spec = MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=1)
    plans = autotune.resolve_plans(v_z // sizes["model"], v_x, 1, device="cuda")
    rnd = make_distributed_round(
        mesh, spec, data_axes=data_axes, histogram_impl="matmul",
        onehot_dtype=torch.bfloat16 if profile == "opt" else torch.float32, plans=plans)
    whole = init_multi_state(spec, device="meta")
    state = MultiQueryState(*(place_leaf(v, p, mesh)
                              for v, p in zip(whole, multi_state_pspecs())))
    z = torch.empty((per_shard,), dtype=torch.int32, device="meta")
    x = torch.empty((per_shard,), dtype=torch.int32, device="meta")
    m = measure(rnd, (state, z, x), mesh, state=tuple(state))
    res = _result("fastmatch_round", f"taxi_vz{v_z}_n{n_samples}", mesh_kind, mesh, profile, m,
                  0.0)
    if verbose:
        _print(res)
    return res


def _tag(*parts, profile: str) -> str:
    tag = "_".join(parts)
    return tag if profile == "baseline" else f"{tag}_{profile}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", type=str, default="pod", choices=("pod", "multipod", "both"))
    ap.add_argument("--all", action="store_true", help="run every supported cell")
    ap.add_argument("--out", type=str, default=str(RESULTS))
    ap.add_argument("--profile", type=str, default="baseline", choices=("baseline", "opt"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)

    if args.arch == "fastmatch_round":
        for mesh_kind in meshes:
            res = run_fastmatch_cell(mesh_kind, args.profile)
            path = outdir / f"{_tag('fastmatch_round', mesh_kind, profile=args.profile)}.json"
            path.write_text(json.dumps(res, indent=1))
        return 0

    if args.all:
        archs, shapes = list_archs(), list(SHAPES)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        archs, shapes = [ALIASES.get(args.arch, args.arch)], [args.shape]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            ok, why = cell_supported(arch, shape_name)
            for mesh_kind in meshes:
                tag = _tag(arch, shape_name, mesh_kind, profile=args.profile)
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    try:
                        if json.loads(path.read_text()).get("ok"):
                            print(f"-- {tag}: cached OK")
                            continue
                    except (OSError, ValueError):
                        pass
                if not ok:
                    path.write_text(json.dumps({"arch": arch, "shape": shape_name,
                                                "mesh": mesh_kind, "ok": False,
                                                "skipped": True, "reason": why}))
                    print(f"-- {tag}: SKIP ({why})")
                    continue
                try:
                    res = run_cell(arch, shape_name, mesh_kind, profile=args.profile)
                    path.write_text(json.dumps(res, indent=1))
                except Exception as e:  # noqa: BLE001 — record the cell and go on
                    traceback.print_exc()
                    failures.append(tag)
                    path.write_text(json.dumps({"arch": arch, "shape": shape_name,
                                                "mesh": mesh_kind, "ok": False,
                                                "error": repr(e)}))
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all requested cells ran on the meta device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
