"""ctypes launch of the hand-written CUDA kernel ``csrc/swap_delete.cu`` (H1)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _fn():
    fn = _build.lib("swap_delete").swap_delete
    fn.argtypes = [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP]
    fn.restype = ctypes.c_int
    return fn


def swap_delete(src: torch.Tensor, trips: torch.Tensor, k: torch.Tensor,
                bits: torch.Tensor, D: int) -> None:
    """src [T, L] int64 (updated in place); trips, k [T] int64; bits [T, S]
    int64 with S >= D. Contiguous CUDA tensors."""
    T, L = src.shape
    err = _fn()(src.data_ptr(), trips.data_ptr(), k.data_ptr(), bits.data_ptr(),
                T, L, bits.shape[1], D, _build.stream_ptr(src.device))
    _build.check(err, "swap_delete")
