"""Activation-sharding context: the port of ``repro.sharding.context``.

Lets the (mesh-agnostic) model pin the batch axis of its activations when
it runs under a mesh: the reference pins ``P(batch_axes, None, ...)`` on
layer boundaries, the q-block attention output, the loss and the MoE
dispatch, where GSPMD's propagation would otherwise drop the batch
sharding (its §Perf hillclimb A).

The context is process-global and set only by launch-time code (the dry
run); models behave identically when it is unset. The mesh is a
``launch.mesh.AbstractMesh`` (axis geometry only) or a ``DeviceMesh``.

  * On a plain tensor ``constrain`` and ``constrain_batch`` return it
    unchanged, context or not: a plain tensor is whole on its device and
    has nothing to pin. They run on the host and launch nothing, so a
    captured CUDA graph holds none of them.
  * On a ``DTensor`` under a context they redistribute it to the pinned
    placements over its own device mesh (``sharding.policy.to_placements``
    of the spec the reference would pin).
  * ``batch_shard_size`` is the product of the batch axes' sizes (1 with
    no context): ``models.moe.apply_moe`` splits its tokens into that many
    dispatch groups, as the reference does.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import abstract_mesh
from repro_torch.sharding.policy import to_placements

_STATE = {"mesh": None, "batch_axes": None}


def set_activation_sharding(mesh, batch_axes: Optional[Tuple[str, ...]]):
    _STATE["mesh"] = mesh
    _STATE["batch_axes"] = tuple(batch_axes) if batch_axes else None


def clear_activation_sharding():
    _STATE["mesh"] = None
    _STATE["batch_axes"] = None


@contextmanager
def activation_sharding(mesh, batch_axes: Optional[Tuple[str, ...]]):
    set_activation_sharding(mesh, batch_axes)
    try:
        yield
    finally:
        clear_activation_sharding()


def _sizes(mesh):
    return abstract_mesh(mesh).shape


def _pin(x: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """``x`` redistributed to ``spec`` where it is a DTensor; else ``x``
    (with no import: a DTensor exists only once its module is loaded, and
    loading it takes seconds)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to the batch axes (no-op when no context or indivisible)."""
    mesh, bats = _STATE["mesh"], _STATE["batch_axes"]
    if mesh is None or bats is None or x.dim() == 0:
        return x
    shape = _sizes(mesh)
    size = 1
    for a in bats:
        size *= shape[a]
    if x.shape[0] % size:
        return x
    return _pin(x, (bats,) + (None,) * (x.dim() - 1))


def batch_shard_size() -> int:
    """Number of shards the batch axes provide (1 when no context)."""
    mesh, bats = _STATE["mesh"], _STATE["batch_axes"]
    if mesh is None or bats is None:
        return 1
    shape = _sizes(mesh)
    size = 1
    for a in bats:
        size *= shape[a]
    return size


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Generic pin: axes entries are None, "batch" (-> the batch mesh axes),
    or a mesh axis name. Silently no-ops on indivisible dims / no context."""
    mesh, bats = _STATE["mesh"], _STATE["batch_axes"]
    if mesh is None:
        return x
    shape = _sizes(mesh)
    spec = []
    for dim, ax in enumerate(axes):
        if ax is None:
            spec.append(None)
            continue
        if ax == "batch":
            if bats is None:
                spec.append(None)
                continue
            size = 1
            for a in bats:
                size *= shape[a]
            spec.append(bats if x.shape[dim] % size == 0 else None)
        else:
            spec.append(ax if x.shape[dim] % shape[ax] == 0 else None)
    spec += [None] * (x.dim() - len(spec))
    return _pin(x, tuple(spec))
