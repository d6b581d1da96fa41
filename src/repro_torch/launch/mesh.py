"""Mesh construction over the initialised `torch.distributed` world.

Port of `repro.launch.mesh`. `make_production_mesh` is a function (not a
module-level constant), so importing this module touches no process
group. The production topology is a pod of 256 devices arranged
(16, 16) = ("data", "model"), and the 2-pod job (2, 16, 16) =
("pod", "data", "model"). Every rank calls these. Unlike the
reference, which takes a prefix of a larger device list, a mesh here
spans the whole world: a rank outside it would hold no coordinate.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.core.distributed import init_mesh

__all__ = ["make_production_mesh", "make_mesh_for"]


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
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_mesh_for(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of ``shape`` with the axis names ``axes`` over the whole
    world (tests, elastic restarts)."""
    return _mesh(tuple(shape), tuple(axes), device_type)
