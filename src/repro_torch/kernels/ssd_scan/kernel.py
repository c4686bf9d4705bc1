"""ctypes launches of B5's hand-written CUDA kernels: ``csrc/ssd_scan.cu``
(CUDA cores, f32) and ``csrc/ssd_scan_tc.cu`` (tensor cores, bf16, TMA)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _fn(source: str):
    """The entry point ``<source>_fwd`` of ``csrc/<source>.cu``; both kernels
    take the same arguments."""
    fn = getattr(_build.lib(source), f"{source}_fwd")
    fn.argtypes = [_VP] * 8 + [_I] * 7 + [_LL] * 12 + [_VP]
    fn.restype = ctypes.c_int
    return fn


def _args(x, dt, a, Bm, Cm, init_state, y, state, chunk, strides):
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(), y.data_ptr(),
            state.data_ptr(), B, S, H, G, N, P, chunk, *strides[0], *dt.stride(),
            *strides[1], *strides[2], _build.stream_ptr(x.device))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, init_state: torch.Tensor | None, y: torch.Tensor,
             state: torch.Tensor, chunk: int) -> None:
    """The CUDA-core kernel. float32 x [B,S,H,P], Bm/Cm [B,S,G,N] (unit stride
    in the last dim), dt [B,S,H], a [H] contiguous, init_state [B,H,N,P]
    contiguous or None, y [B,S,H,P] and state [B,H,N,P] contiguous, all on
    one CUDA device; ``chunk`` divides S."""
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_scan: the CUDA-core kernel takes float32, got {x.dtype}")
    strides = tuple(t.stride()[:3] for t in (x, Bm, Cm))
    _build.check(_fn("ssd_scan")(*_args(x, dt, a, Bm, Cm, init_state, y, state, chunk,
                                         strides)), "ssd_scan")


def ssd_scan_tc(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, init_state: torch.Tensor | None, y: torch.Tensor,
                state: torch.Tensor, chunk: int,
                strides: tuple[tuple[int, ...], ...]) -> None:
    """The tensor-core kernel. bfloat16 x [B,S,H,P] and Bm/Cm [B,S,G,N] whose
    (b, s, h|g) ``strides`` (elements; one triple each) TMA can address; the
    rest as :func:`ssd_scan`, y bfloat16."""
    _build.check_tc(_fn("ssd_scan_tc")(*_args(x, dt, a, Bm, Cm, init_state, y, state, chunk,
                                               strides)), "ssd_scan (tensor cores)")
