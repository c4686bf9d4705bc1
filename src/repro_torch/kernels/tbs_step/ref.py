"""Plain PyTorch version of the fused TBS-step payload pass (B1)."""
from __future__ import annotations

import torch


def apply_ref(items: torch.Tensor, batch: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """items [T, cap, D]; batch [T, bcap, D]; src [T, rows] with values in
    [0, cap + bcap) -> out [T, rows, D] with out[t, i] = items[t, src[t, i]]
    when src[t, i] < cap, else batch[t, src[t, i] - cap]. Out-of-range
    entries are clamped, as JAX clamps its gathers. Any dtype."""
    cap, bcap, D = items.shape[1], batch.shape[1], items.shape[2]
    src = src.to(torch.int64)
    shape = src.shape + (D,)
    gi = torch.gather(items, 1, src.clamp(0, cap - 1).unsqueeze(-1).expand(shape))
    gb = torch.gather(batch, 1, (src - cap).clamp(0, bcap - 1).unsqueeze(-1)
                      .expand(shape))
    return torch.where((src >= cap).unsqueeze(-1), gb, gi)
