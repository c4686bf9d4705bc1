"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without
a card the call raises instead of falling back to the CPU; CPU runs (the
tests, the plain reference versions) pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the requested CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU versions"
        )
    return dev
