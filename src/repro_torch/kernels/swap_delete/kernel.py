"""ctypes launches of the hand-written CUDA kernels ``csrc/swap_delete.cu`` (H1)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
ROWS_MAX_LD = 760   # L + D whose int16 maps and victims fit the rows route's 48 KB


def _fn(name: str, nptr: int, nint: int):
    fn = getattr(_build.lib("swap_delete"), name)
    fn.argtypes = [_VP] * nptr + [_LL] * nint + [_VP]
    fn.restype = ctypes.c_int
    return fn


def _round4(n: int) -> int:
    return (max(n, 0) + 3) // 4 * 4


def forest(out: torch.Tensor, trips: torch.Tensor, k: torch.Tensor,
           bits: torch.Tensor, D: int) -> None:
    """The forest route: out [T, L] int64 (written whole); trips, k [T]
    int64; bits [T, S] int64 with S >= D. Contiguous CUDA tensors. Takes
    an int32 scratch of T x (L + D) entries (each rounded up to 4)."""
    T, L = out.shape
    Lp = _round4(L)
    R = Lp + _round4(D)
    ws = torch.empty((max(T * R, 4),), dtype=torch.int32, device=out.device)
    err = _fn("swap_delete_forest", 5, 6)(
        out.data_ptr(), ws.data_ptr(), trips.data_ptr(), k.data_ptr(),
        bits.data_ptr(), T, L, Lp, R, bits.stride(0), D,
        _build.stream_ptr(out.device))
    _build.check(err, "swap_delete (forest)")


def rows(out: torch.Tensor, trips: torch.Tensor, k: torch.Tensor,
         bits: torch.Tensor, D: int) -> None:
    """The rows route, one thread a row: as :func:`forest`, with
    ``32 * (16 + 2 * (L + D))`` bytes of shared memory a CTA of 32 rows (at
    most 48 KB, so L + D <= 760)."""
    T, L = out.shape
    if L + max(D, 0) > ROWS_MAX_LD:
        raise ValueError(f"swap_delete rows route: L + D = {L + max(D, 0)} exceeds "
                         f"the {ROWS_MAX_LD} int16 entries a row has in shared memory")
    err = _fn("swap_delete_rows", 4, 4)(
        out.data_ptr(), trips.data_ptr(), k.data_ptr(), bits.data_ptr(), T, L,
        bits.stride(0), D, _build.stream_ptr(out.device))
    _build.check(err, "swap_delete (rows)")
