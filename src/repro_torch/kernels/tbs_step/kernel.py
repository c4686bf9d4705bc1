"""ctypes launches of the hand-written CUDA kernels ``csrc/tbs_step.cu`` (B1)
and ``csrc/tbs_step_banked.cu`` (B3). Each call is one launch for up to
:data:`MAX_LEAVES` leaves, whose pointers and row widths reach the kernel
by value, as a kernel parameter."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._common import MAX_LEAVES  # noqa: F401  (the leaf table, shared with B2)

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PVP, _PLL, _PINT = (ctypes.POINTER(t) for t in (_VP, _LL, _INT))

# the largest cap B3 gives to a group of 16 lanes (its WARP_CAP; larger caps
# take a CTA a key, staged in shared memory)
WARP_CAP = 128


@functools.cache
def _fn():
    fn = _build.lib("tbs_step").tbs_step_apply
    fn.argtypes = [_INT, _PVP, _PVP, _PVP, _PLL, _PINT, _VP, _LL, _LL, _LL, _LL, _VP]
    fn.restype = _INT
    return fn


def _ptrs(tensors) -> ctypes.Array:
    return (_VP * len(tensors))(*(t.data_ptr() for t in tensors))


def apply(items: list[torch.Tensor], batch: list[torch.Tensor], out: list[torch.Tensor],
          row_bytes: list[int], vec: list[int], src: torch.Tensor, cap: int,
          bcap: int) -> None:
    """Per leaf l, contiguous raw bytes: items[l] [T, cap, B_l], batch[l]
    [T, bcap, B_l], out[l] [T, rows, B_l] (B_l = ``row_bytes[l]`` > 0,
    ``vec[l]`` a width dividing B_l and the three pointers); src [T, rows]
    int32. CUDA tensors on one device; at most MAX_LEAVES leaves. One
    launch."""
    n = len(items)
    T, rows = src.shape
    err = _fn()(n, _ptrs(items), _ptrs(batch), _ptrs(out), (_LL * n)(*row_bytes),
                (_INT * n)(*vec), src.data_ptr(), T, cap, bcap, rows,
                _build.stream_ptr(src.device))
    _build.check(err, "tbs_step_apply")


@functools.cache
def _banked_fn():
    fn = _build.lib("tbs_step_banked").tbs_step_banked
    fn.argtypes = [_INT, _PVP, _PVP, _PLL, _PINT] + [_VP] * 5 + [_LL] * 4 + [_VP]
    fn.restype = _INT
    return fn


_SMEM_LIMIT: dict[int, int] = {}


def banked_smem_limit(device: torch.device) -> int:
    """The shared memory (bytes) one CTA may opt into on ``device``: the
    most ``cap * row_bytes`` that B3 can stage for a cap past WARP_CAP."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    hit = _SMEM_LIMIT.get(idx)
    if hit is None:
        fn = _build.lib("tbs_step_banked").tbs_step_banked_smem_limit
        fn.argtypes = [_INT]
        fn.restype = _INT
        hit = _SMEM_LIMIT[idx] = int(fn(idx))
        if hit <= 0:
            raise RuntimeError(f"tbs_step_banked: cannot read the shared-memory "
                               f"limit of cuda:{idx}")
    return hit


def apply_banked(bank: list[torch.Tensor], payload: list[torch.Tensor], vec: list[int],
                 order: torch.Tensor, starts: torch.Tensor, touched: torch.Tensor,
                 ntouched: torch.Tensor, src: torch.Tensor, bcap: int) -> None:
    """Per leaf l: bank[l] [K, cap, B_l] uint8 (updated in place), payload[l]
    [b, B_l] uint8 (B_l > 0 the row bytes, ``vec[l]`` a width dividing B_l
    and both pointers). order, starts, touched [b] and ntouched []
    int64, src [b, cap] int32. All contiguous CUDA tensors on one device; at most
    MAX_LEAVES leaves. One launch."""
    n = len(bank)
    K, cap = bank[0].shape[:2]
    rb = (_LL * n)(*(x.shape[2] for x in bank))
    err = _banked_fn()(n, _ptrs(bank), _ptrs(payload), rb, (_INT * n)(*vec), order.data_ptr(),
                       starts.data_ptr(), touched.data_ptr(), ntouched.data_ptr(),
                       src.data_ptr(), K, cap, bcap, payload[0].shape[0],
                       _build.stream_ptr(src.device))
    _build.check(err, "tbs_step_apply_banked")
