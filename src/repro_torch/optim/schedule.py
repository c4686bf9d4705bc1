"""LR schedules: f32 functions of the step count (the JAX package's
``optim/schedule.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.latent import fma_f32

_F32 = torch.float32


def cosine_schedule(step, *, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_frac`` at ``total``; ``step`` is a tensor (an int32 count on the
    device) or a number, and the result an f32 0-d tensor on its device.

    JAX's operations as XLA compiles them inside the jitted train step:
    each division by a constant becomes a product with its f32 reciprocal,
    and ``min_frac + (1 - min_frac) * 0.5 * (1 + cos)`` one fused
    multiply-add. Only the f32 ``cos`` of the two libraries can differ
    (ROADMAP C.12 counts the steps)."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp(step * float(np.float32(1.0 / max(warmup, 1))), max=1.0)
    inv = float(np.float32(1.0 / max(total - warmup, 1)))
    prog = torch.clamp((step - warmup) * inv, 0.0, 1.0)
    half = torch.full((), (1 - min_frac) * 0.5, dtype=_F32, device=step.device)
    cos = fma_f32(half, 1 + torch.cos(math.pi * prog),
                  torch.full((), min_frac, dtype=_F32, device=step.device))
    return warm * cos
