"""Wrapper of the fused TBS-step payload pass (B1): one two-source row gather
per item leaf.

On a CUDA tensor it launches the hand-written kernel (``csrc/tbs_step.cu``)
or raises; there is no fallback. The plain version in :mod:`.ref` runs only
for CPU tensors. ``tbs_step_apply.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import _common
from . import kernel, ref


def _apply_leaf(leaf: torch.Tensor, bleaf: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    T, cap = src.shape[0], leaf.shape[1]
    flat = leaf.reshape(T, cap, -1)
    bflat = bleaf.reshape(T, bleaf.shape[1], -1)
    if leaf.device.type == "cpu":
        return ref.apply_ref(flat, bflat, src).reshape(leaf.shape)
    _common.check_cuda("tbs_step_apply", leaf, bleaf, src)
    if bleaf.dtype != leaf.dtype:
        raise TypeError(f"tbs_step_apply: items {leaf.dtype} vs batch {bleaf.dtype}")
    items_b = _common.as_bytes(flat)
    batch_b = _common.as_bytes(bflat)
    out = torch.empty((T, src.shape[1], items_b.shape[2]), dtype=torch.uint8,
                      device=leaf.device)
    vec = _common.vector_width(items_b.shape[2], items_b, batch_b, out)
    kernel.apply(items_b, batch_b, src, out, vec)
    tbs_step_apply.launches += 1
    return out.view(leaf.dtype).reshape(leaf.shape)


def tbs_step_apply(items, batch_items, src: torch.Tensor):
    """Apply the composed tick map ``src`` (values in [0, cap + bcap): a
    reservoir row, or ``cap +`` a batch row) to an item pytree. ``src`` is
    [cap] for one reservoir (leaves [cap, ...] / [bcap, ...]) or [T, cap]
    for T stacked reservoirs (leaves [T, cap, ...] / [T, bcap, ...]).
    The kernel reads int32 ``src`` (what :func:`repro_torch.core.rtbs.tick_map`
    emits); another index dtype is cast once here, not once per leaf.
    Returns new leaves; the inputs are not modified."""
    single = src.dim() == 1
    s2 = src.unsqueeze(0) if single else src
    s2 = s2.to(torch.int32).contiguous()

    def one(leaf, bleaf):
        if single:
            return _apply_leaf(leaf.unsqueeze(0), bleaf.unsqueeze(0), s2)[0]
        return _apply_leaf(leaf, bleaf, s2)

    return pytree.tree_map(one, items, batch_items)


tbs_step_apply.launches = 0
