"""Checks and views shared by the kernel wrappers, and the leaf tables of
the payload kernels (B1, B2, B3): :func:`check_leaves` and :func:`plan`
are the wrappers' host-side decisions as pure functions, which leaves
agree and how they are grouped into tables with which copy widths."""
from __future__ import annotations

import math

import torch

# the leaf table the payload kernels take by value (csrc/tbs_step*.cu's and
# csrc/reservoir_compact.cu's MAX_LEAVES): past it, one launch a group
MAX_LEAVES = 8


def check_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous [..., D] tensor of any dtype as its raw bytes [..., D * size]."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype != torch.uint8 else x


def vector_width(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy word (16, 8, 4, 2 or 1 bytes) dividing the row and
    every base pointer."""
    return vector_width_of(row_bytes, [t.data_ptr() for t in tensors])


def vector_width_of(row_bytes: int, addrs) -> int:
    """:func:`vector_width` on addresses (ints)."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(a % v == 0 for a in addrs):
            return v
    return 1


def check_leaves(what: str, leaves, others, lead: tuple, other_lead: tuple) -> list[int]:
    """Each leaf's row bytes, after checking every pair agrees: ``leaves[l]``
    is ``lead + tail``, ``others[l]`` is ``other_lead + tail`` with the same
    tail, and both have one dtype. Raises ValueError (shapes) or TypeError
    (dtypes) naming ``what`` and the leaf."""
    if len(leaves) != len(others):
        raise ValueError(f"{what}: {len(leaves)} leaves against {len(others)}")
    out = []
    for i, (a, b) in enumerate(zip(leaves, others)):
        n, m = len(lead), len(other_lead)
        if (tuple(a.shape[:n]) != tuple(lead) or tuple(b.shape[:m]) != tuple(other_lead)
                or a.shape[n:] != b.shape[m:]):
            raise ValueError(f"{what}: leaf {i} of shape {tuple(a.shape)} and its "
                             f"partner {tuple(b.shape)} do not agree (want "
                             f"{list(lead)} + tail and {list(other_lead)} + tail)")
        if a.dtype != b.dtype:
            raise TypeError(f"{what}: leaf {i} is {a.dtype}, its partner {b.dtype}")
        out.append(math.prod(a.shape[n:]) * a.element_size())
    return out


def plan(row_bytes: list[int], ptrs: list[tuple[int, ...]],
         max_leaves: int = MAX_LEAVES) -> list[list[tuple[int, int]]]:
    """The leaf tables of the launches: groups of at most ``max_leaves``
    ``(leaf index, copy width)`` in leaf order, the width the widest of 16,
    8, 4, 2 and 1 bytes dividing the leaf's row bytes and each of its
    pointers (``ptrs[l]``, addresses). Leaves of 0 bytes a row move
    nothing and are left out."""
    table = [(i, vector_width_of(rb, p))
             for i, (rb, p) in enumerate(zip(row_bytes, ptrs)) if rb > 0]
    return [table[k:k + max_leaves] for k in range(0, len(table), max_leaves)]


# TMA's rules for a tensor map: a 16-byte-aligned base, and every stride a
# multiple of 16 bytes below 2^40
TMA_ALIGN, TMA_MAX_STRIDE = 16, 1 << 40


def check_tma(what: str, dtype: torch.dtype, names, dims, shapes, strides, bases) -> None:
    """Raise ValueError for a layout a tensor-core kernel's tensor maps cannot
    address: per tensor (``names``), its base (``bases``, bytes) and the
    strides (elements) of its three outer dims (named by ``dims``); a dim of
    extent 1 is never stepped, so its stride does not count."""
    for name, dn, shape, stride, base in zip(names, dims, shapes, strides, bases):
        if base % TMA_ALIGN:
            raise ValueError(f"{what}: bfloat16 {name} starts {base % TMA_ALIGN} bytes past "
                             f"a {TMA_ALIGN}-byte boundary; the tensor-core kernel's TMA "
                             f"loads need an aligned base")
        for dim, n, st in zip(dn, shape[:3], stride[:3]):
            nbytes = st * dtype.itemsize
            if n > 1 and (nbytes % TMA_ALIGN or not 0 < nbytes < TMA_MAX_STRIDE):
                raise ValueError(f"{what}: bfloat16 {name}'s {dim} stride of {st} elements "
                                 f"({nbytes} bytes) is not a positive multiple of "
                                 f"{TMA_ALIGN} bytes below 2^40, as TMA needs")


def tma_strides(shape, stride) -> tuple[int, int, int]:
    """The three outer strides of a 4-d tensor handed to its tensor map: the
    tensor's own, with a dim of extent 1 given its contiguous stride (a
    multiple of the last dim, so of 16 bytes for any admitted width), since
    it is never stepped."""
    _, d1, d2, d3 = shape
    dense = (d1 * d2 * d3, d2 * d3, d3)
    return tuple(st if n > 1 else d for n, st, d in zip(shape[:3], stride[:3], dense))
