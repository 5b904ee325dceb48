"""Device meshes on ``torch.distributed`` — the JAX package's
``launch/mesh.py``.

Functions, never module-level constants, so importing this module touches
no process group: callers decide when the group and the mesh exist.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group; each rank owns one device (its
``torch.cuda.current_device()``, or the CPU). Axes, as in the reference:

  - single-pod: (data=16, model=16)          — 256 ranks
  - multi-pod:  (pod=2, data=16, model=16)   — 512 ranks
  - host:       (data=world,)                — tests, one host

Rows are sharded over the data axes, ``pod`` composed with ``data``
(:func:`data_axes`); a rank's row shard is its index along them
(:func:`data_rank`) and the collectives of ``core.distributed`` run over
the ranks that share its other coordinates (:func:`data_group`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ranks 0..prod(shape)−1 of the default group,
    named ``axes``; the world must hold exactly that many ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The (data=16, model=16) mesh, or (pod=2, data=16, model=16) with
    ``multi_pod``: a world of 256 or 512 ranks."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(*, device_type: Optional[str] = None) -> DeviceMesh:
    """Every rank of the default group as a 1-D data mesh."""
    return make_mesh((dist.get_world_size(),), ("data",),
                     device_type=device_type)


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes rows are sharded over, in nesting order: ``pod``
    composed with ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def data_shards(mesh: DeviceMesh) -> int:
    """Row shards: the product of the data axes' sizes."""
    names = mesh.mesh_dim_names
    return math.prod(mesh.mesh.shape[names.index(a)]
                     for a in data_axes(mesh))


def _data_columns(mesh: DeviceMesh) -> torch.Tensor:
    """The mesh's ranks as (data shards, other coordinates): column j holds
    the ranks of one data group, in row-shard order."""
    names = mesh.mesh_dim_names
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh axes {names} hold no data axis")
    order = [names.index(a) for a in axes] + [
        i for i, n in enumerate(names) if n not in axes]
    return mesh.mesh.permute(order).reshape(data_shards(mesh), -1)


def data_group(mesh: DeviceMesh):
    """The process group of this rank's data group: the ranks that share
    its non-data coordinates. One data axis: the mesh's own group of it;
    ``pod`` × ``data``: groups built once, collectively (every rank must
    call this the first time), and kept on the mesh."""
    axes = data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cached = getattr(mesh, "_repro_data_group", None)
    if cached is None:
        me = dist.get_rank()
        for members in _data_columns(mesh).T.tolist():
            group = dist.new_group(members)
            if me in members:
                cached = group
        mesh._repro_data_group = cached
    return cached


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's row shard: its index along the data axes."""
    cols = _data_columns(mesh)
    hit = (cols == dist.get_rank()).nonzero()
    if hit.shape[0] != 1:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(hit[0, 0])


def partition_devices(mesh: DeviceMesh) -> Tuple[int, ...]:
    """One rank per data-axis shard (model-axis index 0): the ranks the
    partitioned fit (``placement="partitioned"``) gives partition i to,
    ``i mod`` their count, so partitions spread over the same axes that
    carry N in the SPMD plans. Each rank runs its partitions on its own
    device."""
    return tuple(int(r) for r in _data_columns(mesh)[:, 0])
