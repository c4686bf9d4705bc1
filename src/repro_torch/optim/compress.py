"""Error-feedback int8 gradient compression (the JAX package's
``optim/compress.py``).

Before a gradient crosses a slow link between cards (the JAX package's
cross-pod hop), each leaf is quantised to int8 with one scale a leaf, and
the quantisation error is kept in an f32 accumulator and added back into
the next step's gradient, so the error does not build up. That cuts the
bytes sent 4x for f32 gradients and 2x for bf16.

Plain PyTorch, as JAX computes it outside any kernel: a leaf's scale is
``max(max |g + e|, 1e-12) / 127``, its values are rounded half to even
and clipped to [-127, 127]; all arithmetic is f32, and every division is
a true division on the card too, so the card's result is the CPU's bit for
bit.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

_F32 = torch.float32


def ef_init(grads_like: Any) -> Any:
    """The zero error-feedback accumulator: an f32 zero leaf per gradient
    leaf, on its device."""
    return pytree.tree_map(lambda g: torch.zeros(g.shape, dtype=_F32, device=g.device),
                           grads_like)


def compress_grads(grads: Any, ef: Any):
    """Quantise ``grads + ef`` to int8 with a scale a leaf. Returns ``((q,
    scales), new_ef)``: int8 leaves, f32 0-d scales and the f32 residuals
    ``(g + e) - q * scale``, each tree shaped like ``grads``."""
    flat, spec = pytree.tree_flatten(grads)
    flat_e, spec_e = pytree.tree_flatten(ef)
    if spec != spec_e:
        raise ValueError(f"compress_grads: grads {spec} and ef {spec_e} differ")
    qs, scales, es = [], [], []
    for g, e in zip(flat, flat_e):
        x = g.to(_F32) + e
        # a 0-d device tensor as the divisor: a Python float would make the
        # card multiply by its rounded reciprocal instead of dividing
        scale = torch.clamp(x.abs().max(), min=1e-12) / x.new_full((), 127.0)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        es.append(x - q.to(_F32) * scale)
    unflat = lambda leaves: pytree.tree_unflatten(leaves, spec)  # noqa: E731
    return (unflat(qs), unflat(scales)), unflat(es)


def decompress_grads(q_tree: Any, scale_tree: Any, dtype=_F32) -> Any:
    """``q * scale`` a leaf, in ``dtype``."""
    return pytree.tree_map(lambda q, s: (q.to(_F32) * s).to(dtype), q_tree, scale_tree)
