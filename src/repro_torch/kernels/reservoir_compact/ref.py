"""Plain PyTorch version of reservoir compaction (B2)."""
from __future__ import annotations

import torch


def compact_ref(items: torch.Tensor, mask: torch.Tensor):
    """items [cap, D]; mask [cap] bool -> (compacted [cap, D] zero-padded,
    count int32). Stable: surviving rows keep their order. Any dtype; rows
    are moved, not added, so the result is bit-exact."""
    cap = items.shape[0]
    mask_i = mask.to(torch.int64)
    pos = torch.cumsum(mask_i, 0) - mask_i
    dest = torch.where(mask, pos, cap)             # cap => dropped
    out = torch.zeros((cap + 1,) + items.shape[1:], dtype=items.dtype,
                      device=items.device)
    out.index_copy_(0, dest, items)
    return out[:cap], mask_i.sum().to(torch.int32)
