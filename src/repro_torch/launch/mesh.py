"""Production meshes of the port, as values: ordered axis names and sizes.

The port's counterpart of ``repro.launch.mesh``. A :class:`Mesh` holds no
devices; it has the contract that the sharding rules read from a mesh,
``.axis_names`` and ``.shape[name]`` (that of ``jax.sharding.AbstractMesh``
too). :func:`device_mesh` turns one into a
``torch.distributed.device_mesh.DeviceMesh`` over a live process group.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``axis_names`` with ``axis_sizes``, major to
    minor."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 256-device pod mesh ('data', 'model') 16x16, or ('pod', 'data',
    'model') 2x16x16 with ``multi_pod``."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ('data', 'model') mesh (tests, one card)."""
    return Mesh((data, model), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (includes 'pod' when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name) -> int:
    """Total extent of ``name`` — an axis name, or a tuple/list of
    names (product of extents); absent axes count as 1."""
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.axis_names else 1


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh`` over the live default process group,
    with the same dim names, through ``init_device_mesh``.

    The group must be initialised and its world size must be the mesh's
    size; otherwise this raises (it makes no group of its own)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"the process group has {world} ranks, the mesh "
                         f"{dict(mesh.shape)} needs {mesh.size}")
    return init_device_mesh(device_type, tuple(mesh.axis_sizes),
                            mesh_dim_names=tuple(mesh.axis_names))


def mesh_of(dmesh) -> Mesh:
    """The :class:`Mesh` (names and sizes) of a ``DeviceMesh``."""
    return Mesh(tuple(dmesh.mesh.shape), tuple(dmesh.mesh_dim_names))
