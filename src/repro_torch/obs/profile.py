"""Profiler scopes: named ranges that ``torch.profiler`` attributes host and
device time to (the JAX package's ``jax.named_scope`` labels)."""
from __future__ import annotations

import torch


def scope(name: str):
    """A named profiler range around a phase of the loop or the tick."""
    return torch.profiler.record_function(name)
