"""ctypes launches of the hand-written CUDA kernels ``csrc/tbs_step.cu`` (B1)
and ``csrc/tbs_step_banked.cu`` (B3)."""
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


def _banked_fn():
    fn = _build.lib("tbs_step_banked").tbs_step_banked
    fn.argtypes = [_VP] * 7 + [_LL] * 5 + [ctypes.c_int, _VP]
    fn.restype = ctypes.c_int
    return fn


_SMEM_LIMIT: dict[int, int] = {}


def banked_smem_limit(device: torch.device) -> int:
    """The shared memory (bytes) one CTA may opt into on ``device``: the
    most ``cap * row_bytes`` that B3 can stage."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    hit = _SMEM_LIMIT.get(idx)
    if hit is None:
        fn = _build.lib("tbs_step_banked").tbs_step_banked_smem_limit
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        hit = _SMEM_LIMIT[idx] = int(fn(idx))
        if hit <= 0:
            raise RuntimeError(f"tbs_step_banked: cannot read the shared-memory "
                               f"limit of cuda:{idx}")
    return hit


def apply_banked(bank: torch.Tensor, payload: torch.Tensor, order: torch.Tensor,
                 starts: torch.Tensor, touched: torch.Tensor,
                 ntouched: torch.Tensor, src: torch.Tensor, bcap: int,
                 vec: int) -> None:
    """bank [K, cap, B] uint8 (updated in place), payload [b, B] uint8 (B
    the row bytes, ``vec`` a width dividing B and both pointers); order,
    starts, touched [b], ntouched [] and src [b, cap] int32. All contiguous
    CUDA tensors on one device."""
    K, cap, B = bank.shape
    err = _banked_fn()(bank.data_ptr(), payload.data_ptr(), order.data_ptr(),
                       starts.data_ptr(), touched.data_ptr(), ntouched.data_ptr(),
                       src.data_ptr(), K, cap, bcap, payload.shape[0], B, vec,
                       _build.stream_ptr(bank.device))
    _build.check(err, "tbs_step_apply_banked")
