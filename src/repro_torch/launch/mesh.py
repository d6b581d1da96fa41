"""Mesh construction over the initialised `torch.distributed` world.

Port of `repro.launch.mesh`. `make_production_mesh` is a function (not a
module-level constant), so importing this module touches no process
group. The production topology is a pod of 256 devices arranged
(16, 16) = ("data", "model"), and the 2-pod job (2, 16, 16) =
("pod", "data", "model"). Every rank calls these. Unlike the
reference, which takes a prefix of a larger device list, a mesh here
spans the whole world: a rank outside it would hold no coordinate.
`make_virtual_mesh` is one rank's place on the production mesh with no
world at all (`core.distributed.VirtualMesh`: the meta device, groups
that record their collectives), what the dry run compiles against in
place of the reference's 512 placeholder host devices.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.core.distributed import VirtualMesh, init_mesh

__all__ = ["PRODUCTION", "make_mesh_for", "make_production_mesh", "make_virtual_mesh"]

# (shape, axis names) of the pod and of the 2-pod job
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape: tuple, axes: tuple, device_type: str):
    ndev = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if world != ndev:
        raise RuntimeError(f"need {ndev} ranks for mesh {tuple(shape)}, have {world}")
    return init_mesh(shape, axes, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over a world of exactly 256 (512) ranks."""
    return _mesh(*PRODUCTION[multi_pod], device_type)


def make_virtual_mesh(*, multi_pod: bool = False, coordinate=None) -> VirtualMesh:
    """The production mesh as its rank at ``coordinate`` (one index an
    axis; the first rank by default) sees it, with no process group: a
    `VirtualMesh` on "meta"."""
    shape, names = PRODUCTION[multi_pod]
    return VirtualMesh(shape, names, tuple(coordinate or (0,) * len(shape)))


def make_mesh_for(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of ``shape`` with the axis names ``axes`` over the whole
    world (tests, elastic restarts)."""
    return _mesh(tuple(shape), tuple(axes), device_type)
