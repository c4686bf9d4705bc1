"""Meshes: the data mesh of the sharded manage loop, and the logical meshes
of the dry run (the JAX package's ``launch/mesh.py``).

JAX lays the reservoir shards over devices along the ``data`` mesh axis.
The port's data mesh (:func:`make_data_mesh`) lays them along a shard axis
(:mod:`repro_torch.core.distributed`): a leading dimension of one device's
state (no group), or one shard a rank of a ``torch.distributed`` process
group. The sharded builders keep JAX's ``(sampler, model, mesh, ...)``
signature and read the axis and the device from it.

:func:`make_mesh`, :func:`make_production_mesh` and :func:`make_host_mesh`
build a :class:`Mesh`: axis names and sizes with no devices behind them,
which is what :func:`repro_torch.sharding.mesh_info` reads and what the dry
run (:mod:`repro_torch.launch.dryrun`) divides its counts by. The shapes are
JAX's, (16, 16) over ``data`` x ``model`` and (2, 16, 16) with ``pod``, so
every per-device number compares 1:1 with JAX's sharding. On H100 nodes of
8 cards a ``model`` (TP) axis of 16 spans two NVLink domains: half of each
tensor-parallel group's partners sit behind the NIC (``hw.DCN_BW``), not on
NVLink (``hw.ICI_BW``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from typing import Any

from repro_torch import _device
from repro_torch.core.distributed import AXIS, GroupAxis, StackedAxis


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``num_shards`` reservoir shards along the ``axis`` dimension: of one
    device's state (``group`` None), or one a rank of ``group``.
    ``shard_axis`` is the :mod:`repro_torch.core.distributed` axis the
    sharded loops run over."""

    num_shards: int
    device: torch.device
    axis: str = AXIS
    group: Any = None

    def __post_init__(self):
        ax = StackedAxis(self.num_shards) if self.group is None else GroupAxis(self.group)
        object.__setattr__(self, "shard_axis", ax)

    @property
    def local_shards(self) -> int:
        """The shards this process holds: all of them, or its rank's one."""
        return self.shard_axis.local

    @property
    def rank(self) -> int:
        """This process's rank in ``group`` (0 without one)."""
        return self.shard_axis.rank


def make_data_mesh(shards: int | None, device=None, group=None) -> ShardMesh:
    """A 1-D mesh of ``shards`` reservoir shards on ``device`` (``None``:
    the CUDA card, raising without one). With ``group`` (a
    ``torch.distributed`` process group, e.g. ``dist.group.WORLD``) the
    mesh runs over its ranks, one shard each: ``shards`` must be the
    group's size, or None."""
    if group is not None:
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if shards is not None and int(shards) != size:
            raise ValueError(f"make_data_mesh: {shards} shards over a group of {size} "
                             "ranks; one shard a rank")
        shards = size
    if shards is None or int(shards) < 1:
        raise ValueError(f"make_data_mesh: shards must be at least 1; got {shards}")
    return ShardMesh(num_shards=int(shards), device=_device.resolve(device), group=group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape[i]`` devices along ``axis_names[i]``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape, axes) -> Mesh:
    """A logical mesh of ``shape`` over the axes ``axes`` (one name a dim)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"make_mesh: one size >= 1 an axis expected, got {shape}, {axes}")
    return Mesh(shape=shape, axis_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 cards over (data = DP/FSDP, model = TP/EP); multi-pod
    adds a leading ``pod`` axis of 2 (512 cards), crossed only by the
    gradients."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``data`` x ``model`` mesh (tests; ``1 x 1`` is one card)."""
    return make_mesh((data, model), ("data", "model"))
