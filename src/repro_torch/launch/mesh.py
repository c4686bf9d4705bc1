"""The data mesh of the sharded manage loop (the JAX package's
``launch/mesh.py:make_data_mesh``).

JAX lays the reservoir shards over devices along the ``data`` mesh axis.
The port keeps the S shards as a leading dimension of one device's state
(:mod:`repro_torch.core.distributed`), so its mesh is only the shard count
and the device: the sharded builders keep JAX's ``(sampler, model, mesh,
...)`` signature and read both from it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import _device
from repro_torch.core.distributed import AXIS


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``num_shards`` reservoir shards along the ``axis`` dimension of one
    device's state."""

    num_shards: int
    device: torch.device
    axis: str = AXIS


def make_data_mesh(shards: int, device=None) -> ShardMesh:
    """A 1-D mesh of ``shards`` reservoir shards on ``device`` (``None``:
    the CUDA card, raising without one)."""
    if int(shards) < 1:
        raise ValueError(f"make_data_mesh: shards must be at least 1; got {shards}")
    return ShardMesh(num_shards=int(shards), device=_device.resolve(device))
