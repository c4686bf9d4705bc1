"""ctypes launch of the hand-written CUDA kernels ``csrc/reservoir_compact.cu`` (B2)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
BLOCK = 1024   # rows per CTA, BLK in the source


def _fn():
    fn = _build.lib("reservoir_compact").reservoir_compact
    fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _LL, _LL, ctypes.c_int, _VP]
    fn.restype = ctypes.c_int
    return fn


def compact(items: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
            count: torch.Tensor, vec: int) -> None:
    """items, out [cap, B] uint8 (B the row bytes); mask [cap] bool;
    count int32 (written on the device). Contiguous CUDA tensors."""
    cap, B = items.shape
    nb = (cap + BLOCK - 1) // BLOCK
    scratch = torch.empty((2 * max(nb, 1),), dtype=torch.int32,
                          device=items.device)
    err = _fn()(items.data_ptr(), mask.data_ptr(), out.data_ptr(),
                count.data_ptr(), scratch.data_ptr(), cap, B, vec,
                _build.stream_ptr(items.device))
    _build.check(err, "reservoir_compact")
