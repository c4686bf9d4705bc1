"""ctypes launch of the hand-written CUDA kernel ``csrc/tbs_step.cu`` (B1)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _fn():
    fn = _build.lib("tbs_step").tbs_step_apply
    fn.argtypes = [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _LL, ctypes.c_int, _VP]
    fn.restype = ctypes.c_int
    return fn


def apply(items: torch.Tensor, batch: torch.Tensor, src: torch.Tensor,
          out: torch.Tensor, vec: int) -> None:
    """items [T, cap, B], batch [T, bcap, B], out [T, rows, B] uint8 (B the
    row bytes, ``vec`` a width dividing B and the pointers); src [T, rows]
    int32. All contiguous CUDA tensors on one device."""
    T, cap, B = items.shape
    err = _fn()(items.data_ptr(), batch.data_ptr(), src.data_ptr(),
                out.data_ptr(), T, cap, batch.shape[1], src.shape[1], B, vec,
                _build.stream_ptr(items.device))
    _build.check(err, "tbs_step_apply")
