"""Activation checkpointing: the port of the JAX package's ``jax.checkpoint``
sites.

:func:`remat` runs ``fn(*args)`` through ``torch.utils.checkpoint``'s
non-reentrant checkpoint while gradients are recorded: the forward keeps
only what ``fn`` is given, and the backward runs ``fn`` again to rebuild the
tensors its own backward reads. Outside grad mode (prefill, decode, an eval
under ``torch.no_grad()``) it is the plain call. The recompute runs the same
ops on the same inputs, so values and gradients are bit for bit those of the
plain call. Checkpoints nest: a recomputed ``fn`` that holds checkpoints
of its own keeps only their inputs, and their insides run a third time.

Kernels and profiler scopes inside ``fn`` run again in the backward;
:func:`in_backward` tells a wrapper's counter that a launch is such a
recompute.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def remat(fn, *args, on: bool = True):
    """``fn(*args)``, checkpointed when ``on`` and grad mode is enabled."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    # no checkpointed function draws random numbers, so the generators'
    # states are not stashed: preserving them would read the CPU and CUDA
    # generators at every call and set them again around every recompute
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def in_backward() -> bool:
    """True while the calling thread runs a backward pass: a launch from a
    checkpoint's recompute."""
    return torch._C._current_graph_task_id() != -1
