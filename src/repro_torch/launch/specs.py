"""Optimizer-state placement for the FSDP × TP training layout.

Port of `opt_state_pspecs` of `repro.launch.specs`: the optimizer state
is sharded congruent with its parameters, so a rank holds the moments of
exactly the blocks it holds of the parameters (`distributed.sharding.
param_pspecs`). The mesh is an argument here, a `DeviceMesh` or any mesh
description `sharding.mesh_spec` takes, where the reference reads a
module global its ``build_case`` sets.

The rest of the reference's module (``input_specs``, ``DryRunCase``,
``build_case``: the dry-run launcher's compile-only cases) belongs with
the launcher and is not ported here (ROADMAP A12f).
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.distributed.sharding import PSpec, _names, _shape, guard_pspec, mesh_spec

__all__ = ["opt_state_pspecs"]


def _spec_index(pspecs) -> dict:
    """{path names: PSpec} of a tree of specs: a nested dict / list tree
    (`param_pspecs` of a parameter tree) or a module's flat ``{dotted
    name: PSpec}`` dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, PSpec):
            out[path] = node
        elif isinstance(node, Mapping):
            for k, v in node.items():
                flat = not path and isinstance(v, PSpec)  # a module's dotted name
                walk(v, tuple(_names(str(k))) if flat else path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (f"[{i}]",))

    walk(pspecs, ())
    return out


def opt_state_pspecs(opt_shapes, params_pspecs, mesh):
    """Specs of the optimizer state tree ``opt_shapes`` (leaves with a
    ``shape``), congruent with ``params_pspecs`` on ``mesh``:

      AdamW, ``state['mu'|'nu'][<param path>]``: the parameter's spec;
      Adafactor, ``state[<param path>]['row'|'col'|'nu']``: ``row`` drops
      the spec's last entry (the mean over the last dim), ``col`` its
      second to last, ``nu`` keeps it.

    Each result is guarded on the state leaf's own shape (`guard_pspec`);
    a leaf that matches no parameter is replicated. The result has the
    structure of ``opt_shapes``."""
    ms = mesh_spec(mesh)
    index = _spec_index(params_pspecs)

    def per_leaf(names: tuple, leaf):
        shape = _shape(leaf)
        if names and names[0] in ("mu", "nu") and names[1:] in index:
            return guard_pspec(shape, index[names[1:]], ms)
        if names and names[-1] in ("row", "col", "nu") and names[:-1] in index:
            entries = list(index[names[:-1]])
            if names[-1] == "row":
                entries = entries[:-1]
            elif names[-1] == "col":
                entries = entries[:-2] + entries[-1:]
            return guard_pspec(shape, PSpec(*entries), ms)
        return PSpec(*([None] * len(shape)))

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(walk(v, path + (f"[{i}]",)) for i, v in enumerate(node))
        return per_leaf(path, node)

    return walk(opt_shapes, ())
