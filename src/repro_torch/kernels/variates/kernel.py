"""ctypes launches of the hand-written CUDA kernels ``csrc/variates.cu``
(H2 binomial, H3 hypergeometric)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# H3's trips a block (kBlock in csrc/variates.cu): the unit its stages work
# in, and what the block-edge rows of ``cases.hypergeometric_edge_rows`` aim at
H3_BLOCK = 1024


@functools.cache
def _fn(name: str, nptr: int, nint: int):
    fn = getattr(_build.lib("variates"), name)
    fn.argtypes = [_VP] * nptr + [_LL] * nint + [_VP]
    fn.restype = _INT
    return fn


def binomial(out: torch.Tensor, keys: torch.Tensor, count: torch.Tensor,
             p: torch.Tensor) -> None:
    """H2: out [T] int64; keys [T, 2] int64 (32-bit words); count [T] int64;
    p [T] f32. Contiguous CUDA tensors on one device."""
    err = _fn("variates_binomial", 4, 1)(
        out.data_ptr(), keys.data_ptr(), count.data_ptr(), p.data_ptr(), out.numel(),
        _build.stream_ptr(out.device))
    _build.check(err, "binomial (H2)")


def hypergeometric(out: torch.Tensor, u: torch.Tensor, k: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, trips: int) -> None:
    """H3: out [T] int64; u [T] f32; k, a, b [T] int64; at most ``trips``
    trips a row; one CTA a row (T < 2^31). Contiguous CUDA tensors on one
    device."""
    err = _fn("variates_hypergeometric", 5, 2)(
        out.data_ptr(), u.data_ptr(), k.data_ptr(), a.data_ptr(), b.data_ptr(), trips,
        out.numel(), _build.stream_ptr(out.device))
    _build.check(err, "hypergeometric (H3)")
