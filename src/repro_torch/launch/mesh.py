"""Meshes: the port of the JAX package's `repro/launch/mesh.py`.

Functions, never module-level constants: importing this module touches no
process state.  `AbstractMesh` has no devices and no process group; the
sharding rules and the dry-run's bookkeeping take it.  `make_mesh` and
`make_host_mesh` build a torch `DeviceMesh` over the process group that is
already initialised (they raise when there is none, rather than start one).
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only (jax's `AbstractMesh`)."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 per pod (256 chips); 2 pods stack a leading 'pod' axis."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_mesh(axis_names, axis_sizes, device=None):
    """A `DeviceMesh` of `axis_sizes` over the initialised world, on the
    card unless `device` says otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    return init_device_mesh(resolve(device).type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def make_host_mesh(data: int | None = None, model: int = 1, device=None):
    """A (data, model) `DeviceMesh` over every rank of the initialised world
    (data = world size // model by default)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    data = data or dist.get_world_size() // model
    return make_mesh(("data", "model"), (data, model), device)
