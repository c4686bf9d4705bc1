"""ctypes launches of B4's hand-written CUDA kernels: ``csrc/flash_attention.cu``
(CUDA cores, f32) and ``csrc/flash_attention_tc.cu`` (tensor cores, bf16,
TMA)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _fn(source: str):
    """The entry point ``<source>_fwd`` of ``csrc/<source>.cu``; both kernels
    take the same arguments."""
    fn = getattr(_build.lib(source), f"{source}_fwd")
    fn.argtypes = ([_VP] * 4 + [_I] * 6 + [_LL] * 9
                   + [_I, _I, ctypes.c_float, _VP])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool, window: int) -> None:
    """The CUDA-core kernel. float32 q [B,S,H,hd], k and v [B,T,KV,hd] (unit
    stride in the head dim), out [B,S,H,hd] contiguous, all on one CUDA
    device."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention: the CUDA-core kernel takes float32, "
                        f"got {q.dtype}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _fn("flash_attention")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), B, S, T, H, KV, hd,
                                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 int(causal), int(window), 1.0 / hd ** 0.5,
                                 _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, causal: bool, window: int,
                       strides: tuple[tuple[int, ...], ...]) -> None:
    """The tensor-core kernel. bfloat16 q [B,S,H,hd], k and v [B,T,KV,hd]
    whose (b, s, h) ``strides`` (elements; one triple each) TMA can address,
    out [B,S,H,hd] contiguous, all on one CUDA device."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _fn("flash_attention_tc")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), B, S, T, H, KV, hd, *strides[0],
                                    *strides[1], *strides[2], int(causal), int(window),
                                    1.0 / hd ** 0.5, _build.stream_ptr(q.device))
    _build.check_tc(err, "flash_attention (tensor cores)")
