"""Wrapper of the delete-complement loop (H1) of the R-TBS downsample map.

On a CUDA tensor it launches the hand-written kernel (``csrc/swap_delete.cu``),
which reads the trip count on the device, so a tick never syncs to learn
it; the masked loop in :mod:`.ref` runs only for CPU tensors.
``swap_delete.launches`` counts launches.
"""
from __future__ import annotations

import torch

from .. import _common
from . import kernel, ref


def swap_delete(L: int, trips: torch.Tensor, k: torch.Tensor,
                bits: torch.Tensor, D: int) -> torch.Tensor:
    """The identity map [..., L] after ``trips`` [...] swap-with-last
    deletions from the prefix [0, k) driven by ``bits`` [..., >= D] (int64
    words in [0, 2^32)); ``trips`` must not exceed ``D``. Returns int64."""
    if trips.device.type == "cpu":
        return ref.swap_delete_ref(L, trips, k, bits, D)
    _common.check_cuda("swap_delete", trips, k, bits)
    batch = trips.shape
    T = trips.numel()
    src = torch.arange(L, dtype=torch.int64, device=trips.device).expand(
        (T, L)).contiguous()
    kernel.swap_delete(src, trips.to(torch.int64).reshape(T).contiguous(),
                       k.to(torch.int64).reshape(T).contiguous(),
                       bits.to(torch.int64).reshape(T, -1).contiguous(), D)
    swap_delete.launches += 1
    return src.reshape(batch + (L,))


swap_delete.launches = 0
