"""Checks and views shared by the kernel wrappers."""
from __future__ import annotations

import torch


def check_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous [..., D] tensor of any dtype as its raw bytes [..., D * size]."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype != torch.uint8 else x


def vector_width(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy word (16, 8, 4, 2 or 1 bytes) dividing the row and
    every base pointer."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1
