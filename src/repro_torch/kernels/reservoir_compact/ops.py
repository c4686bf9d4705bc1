"""Wrapper of reservoir compaction (B2): stable pack of the masked rows to the
buffer head, zeros past the count, the count left on the device.

On a CUDA tensor it launches the hand-written kernel
(``csrc/reservoir_compact.cu``) or raises; the plain version in :mod:`.ref`
runs only for CPU tensors. Every item leaf of a sample moves in one launch
against the one mask (one for each group of
:data:`~.._common.MAX_LEAVES` leaves past that), so a materialization is
one launch. ``reservoir_compact.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import _common
from . import kernel, ref


def reservoir_compact(items, mask: torch.Tensor, *, rows: int | None = None):
    """items: a tensor [cap, ...] or a pytree of them (any dtypes and
    trailing shapes); mask [cap] bool -> (the same structure compacted:
    each leaf's kept rows packed in order to [0, count), zeros after;
    count, an int32 0-d tensor on the mask's device). Bit-exact; the count
    is never read on the host. ``rows`` (at least ``cap``) gives the
    outputs that many rows, those past ``cap`` zero: room for rows a caller
    appends after the count without copying the packed buffer."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"reservoir_compact: mask must be bool [cap], "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    cap = mask.shape[0]
    leaves, spec = pytree.tree_flatten(items)
    rows = cap if rows is None else int(rows)
    if rows < cap:
        raise ValueError(f"reservoir_compact: rows = {rows} is below cap = {cap}")
    row_bytes = _common.check_leaves("reservoir_compact", leaves, leaves, (cap,), (cap,))
    if all(t.device.type == "cpu" for t in (mask, *leaves)):
        outs = [ref.compact_ref(x.reshape(cap, rb // x.element_size()), mask)[0]
                .reshape(x.shape) for x, rb in zip(leaves, row_bytes)]
        if rows > cap:
            outs = [torch.cat([o, o.new_zeros((rows - cap,) + o.shape[1:])]) for o in outs]
        return pytree.tree_unflatten(outs, spec), mask.sum(dtype=torch.int32)
    _common.check_cuda("reservoir_compact", mask, *leaves)
    if cap >= 2**31:
        raise ValueError(f"reservoir_compact: cap = {cap} must be below 2^31 "
                         f"(the count is an int32)")
    # the kernel reads and writes raw bytes: contiguous leaves, the outputs
    # made in the leaves' own dtypes and shapes
    xs = [x.contiguous() for x in leaves]
    outs = [torch.empty((rows,) + x.shape[1:], dtype=x.dtype, device=x.device) for x in xs]
    if rows > cap:
        for o in outs:
            o[cap:].zero_()
    if cap == 0:
        return pytree.tree_unflatten(outs, spec), torch.zeros((), dtype=torch.int32,
                                                              device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    m = mask.contiguous()
    # leaves of 0 bytes a row move nothing; with none left, one launch
    # still writes the count
    groups = plan(row_bytes, [(x.data_ptr(), o.data_ptr()) for x, o in zip(xs, outs)]) or [[]]
    for g in groups:
        kernel.compact([xs[i] for i, _ in g], [outs[i] for i, _ in g],
                       [row_bytes[i] for i, _ in g], [v for _, v in g], m, count)
        reservoir_compact.launches += 1
    return pytree.tree_unflatten(outs, spec), count


reservoir_compact.launches = 0


def plan(row_bytes: list[int], ptrs: list[tuple[int, ...]]) -> list[list[tuple[int, int]]]:
    """The launches' leaf tables (:func:`.._common.plan`), after refusing
    a leaf of :data:`.kernel.MAX_ROW_WORDS` copy words a row or more, which
    the kernel cannot index (a row of 512 KiB at 1-byte words, 8 MiB at
    16-byte words), with a ValueError."""
    groups = _common.plan(row_bytes, ptrs)
    for g in groups:
        for i, v in g:
            if row_bytes[i] // v >= kernel.MAX_ROW_WORDS:
                raise ValueError(f"reservoir_compact: leaf {i} has {row_bytes[i]} bytes a row "
                                 f"in {row_bytes[i] // v} words of {v}; the kernel takes "
                                 f"below {kernel.MAX_ROW_WORDS} words a row")
    return groups
