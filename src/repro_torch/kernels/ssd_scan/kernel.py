"""ctypes launch of the hand-written CUDA kernel ``csrc/ssd_scan.cu`` (B5)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = _build.lib("ssd_scan").ssd_scan_fwd
    fn.argtypes = [_VP] * 8 + [_I] * 8 + [_LL] * 12 + [_VP]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, init_state: torch.Tensor | None, y: torch.Tensor,
             state: torch.Tensor, chunk: int) -> None:
    """x [B,S,H,P], Bm/Cm [B,S,G,N] (float32 or bfloat16, unit stride in the
    last dim), dt [B,S,H] f32, a [H] f32 contiguous, init_state [B,H,N,P] f32
    contiguous or None, y [B,S,H,P] and state [B,H,N,P] contiguous, all on
    one CUDA device; ``chunk`` divides S."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    err = _fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                None if init_state is None else init_state.data_ptr(), y.data_ptr(),
                state.data_ptr(), _DTYPES[x.dtype], B, S, H, G, N, P, chunk,
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
                _build.stream_ptr(x.device))
    _build.check(err, "ssd_scan")
