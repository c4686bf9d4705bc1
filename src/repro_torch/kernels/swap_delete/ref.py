"""Plain PyTorch version of the delete-complement loop (H1)."""
from __future__ import annotations

import torch


def swap_delete_ref(L: int, trips: torch.Tensor, k: torch.Tensor,
                    bits: torch.Tensor, D: int) -> torch.Tensor:
    """Start from the identity map [..., L] and run ``trips`` [...] deletions:
    iteration i sets src[v] = src[m - 1] with m = k - i and
    v = bits[..., min(i, D - 1)] mod max(m, 1). ``trips`` <= D. A loop of D
    masked iterations (each a no-op where i >= trips), in the JAX order."""
    batch = trips.shape
    src = torch.arange(L, dtype=torch.int64, device=trips.device).expand(
        batch + (L,)).clone()
    for i in range(D):
        active = i < trips
        m = k - i
        v = (bits[..., min(i, D - 1)] % torch.clamp(m, min=1)).clamp(0, L - 1)
        val = torch.gather(src, -1, (m - 1).clamp(0, L - 1).unsqueeze(-1))
        old = torch.gather(src, -1, v.unsqueeze(-1))
        src.scatter_(-1, v.unsqueeze(-1),
                     torch.where(active.unsqueeze(-1), val, old))
    return src
