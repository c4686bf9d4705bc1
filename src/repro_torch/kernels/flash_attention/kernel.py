"""ctypes launch of the hand-written CUDA kernel ``csrc/flash_attention.cu`` (B4)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = _build.lib("flash_attention").flash_attention_fwd
    fn.argtypes = ([_VP] * 4 + [_I] * 7 + [_LL] * 9
                   + [_I, _I, ctypes.c_float, _VP])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool, window: int) -> None:
    """q [B,S,H,hd], k and v [B,T,KV,hd] (float32 or bfloat16, unit stride
    in the head dim), out [B,S,H,hd] contiguous, all on one CUDA device."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, S, T, H, KV, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), int(window), 1.0 / hd ** 0.5,
                _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
