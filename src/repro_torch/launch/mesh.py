"""The production meshes: the port of ``repro.launch.mesh``.

The reference's target: single pod = 16×16 (256 chips, axes data×model);
multi-pod = 2×16×16 (512 chips, axes pod×data×model) where the pod axis is
an outer data-parallel / replica axis (gradient all-reduce across pods in
training; independent serving replicas — the resource pools InfAdapter's
solver allocates variants into).

``make_production_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` of
that geometry. It needs a default process group of world 256 (512 with
``multi_pod``); on one host the fake backend
(``torch.testing._internal.distributed.fake_pg``), which runs no
collective, gives one. ``AbstractMesh`` carries the geometry alone, as
JAX's ``AbstractMesh`` does in the reference's tests: the sharding policy,
the activation context and the dry run run on it with no process group.

Functions, not module constants: importing this module touches no
process-group state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, major to minor."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


def production_geometry(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """A ``DeviceMesh`` of the production geometry over the default process
    group, whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    geo = production_geometry(multi_pod=multi_pod)
    return init_device_mesh(device_type, geo.sizes,
                            mesh_dim_names=geo.axis_names)


def abstract_mesh(mesh) -> AbstractMesh:
    """The geometry of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = abstract_mesh(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return abstract_mesh(mesh).shape["model"]


def batch_axis_size(mesh) -> int:
    shape = abstract_mesh(mesh).shape
    out = 1
    for a in batch_axes(mesh):
        out *= shape[a]
    return out
