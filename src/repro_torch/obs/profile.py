"""Profiler scopes: named ranges that ``torch.profiler`` attributes host and
device time to (the JAX package's ``jax.named_scope`` labels)."""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def scope(name: str):
    """A named profiler range around a phase of the loop, the tick or a
    layer; a no-op context while no profiler runs (the LM's decode step
    opens hundreds of them)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
