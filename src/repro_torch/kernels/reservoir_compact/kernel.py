"""ctypes launch of the hand-written CUDA kernel ``csrc/reservoir_compact.cu``
(B2). Each call is one cooperative launch for up to
:data:`~.._common.MAX_LEAVES` leaves, whose pointers and row widths reach
the kernel by value, as a kernel parameter."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# a row's copy words must stay below this (csrc/reservoir_compact.cu's
# MAX_ROW_WORDS): a chunk of 4,096 rows is indexed by word in 32 bits
MAX_ROW_WORDS = 1 << 19
_PVP, _PLL, _PINT = (ctypes.POINTER(t) for t in (_VP, _LL, _INT))


@functools.cache
def _fn():
    fn = _build.lib("reservoir_compact").reservoir_compact
    fn.argtypes = [_INT, _PVP, _PVP, _PLL, _PINT, _VP, _VP, _VP, _LL, _LL, _VP]
    fn.restype = _INT
    return fn


@functools.cache
def _scratch(device: int, stream: int) -> torch.Tensor:
    """The kernel's scratch on one device and stream, made once: an int32 a
    CTA of the resident grid and the zero tail's piece counter, each
    written before it is read in the same launch (so it needs no reset),
    and a stream's launches run in order."""
    fn = _build.lib("reservoir_compact").reservoir_compact_scratch
    fn.argtypes = [_PLL]
    fn.restype = _INT
    n = _LL(0)
    with torch.cuda.device(device):
        _build.check(fn(ctypes.byref(n)), "reservoir_compact (scratch length)")
    return torch.empty((n.value,), dtype=torch.int32, device=f"cuda:{device}")


def _ptrs(tensors) -> ctypes.Array:
    return (_VP * len(tensors))(*(t.data_ptr() for t in tensors))


def compact(items: list[torch.Tensor], out: list[torch.Tensor], row_bytes: list[int],
            vec: list[int], mask: torch.Tensor, count: torch.Tensor) -> None:
    """Per leaf l, contiguous: items[l] and out[l] [cap, ...] of B_l =
    ``row_bytes[l]`` > 0 bytes a row, ``vec[l]`` a width dividing B_l and
    both pointers; mask [cap] bool, contiguous; count an int32 written on
    the device. CUDA tensors on one device; at most MAX_LEAVES leaves (none:
    the count alone). One launch."""
    n, cap = len(items), mask.shape[0]
    dev = mask.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev.index if dev.index is not None else torch.cuda.current_device(),
                       stream)
    err = _fn()(n, _ptrs(items), _ptrs(out), (_LL * n)(*row_bytes), (_INT * n)(*vec),
                mask.data_ptr(), count.data_ptr(), scratch.data_ptr(), scratch.shape[0], cap,
                stream)
    _build.check(err, "reservoir_compact")
