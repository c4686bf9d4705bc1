"""Wrapper of reservoir compaction (B2): stable pack of the masked rows to the
buffer head, zeros past the count, the count left on the device.

On a CUDA tensor it launches the hand-written kernels
(``csrc/reservoir_compact.cu``) or raises; the plain version in :mod:`.ref`
runs only for CPU tensors. ``reservoir_compact.launches`` counts launches.
"""
from __future__ import annotations

import torch

from .. import _common
from . import kernel, ref


def reservoir_compact(items: torch.Tensor, mask: torch.Tensor):
    """items [cap, ...]; mask [cap] bool -> (compacted [cap, ...], count
    int32 0-d tensor). Any dtype and trailing shape; bit-exact."""
    cap = items.shape[0]
    flat = items.reshape(cap, -1)
    if items.device.type == "cpu":
        out, cnt = ref.compact_ref(flat, mask)
        return out.reshape(items.shape), cnt
    _common.check_cuda("reservoir_compact", items, mask)
    if mask.dtype != torch.bool or mask.shape != (cap,):
        raise ValueError(f"reservoir_compact: mask must be bool [{cap}], "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    items_b = _common.as_bytes(flat)
    out = torch.empty_like(items_b)
    count = torch.empty((), dtype=torch.int32, device=items.device)
    vec = _common.vector_width(items_b.shape[1], items_b, out)
    kernel.compact(items_b, mask.contiguous(), out, count, vec)
    reservoir_compact.launches += 1
    return out.view(items.dtype).reshape(items.shape), count


reservoir_compact.launches = 0
