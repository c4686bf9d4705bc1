"""Wrapper of B4, flash attention over the JAX layout [B, S, H, hd].

On CUDA tensors it launches the hand-written kernel
(``csrc/flash_attention.cu``), which reads q, k and v through their strides,
so no transposed copy is made; the plain version in :mod:`.ref` runs only
for CPU tensors. ``flash_attention.launches`` counts kernel launches.
Unlike the JAX wrapper it takes no ``block_q`` / ``block_k``: those were the
TPU's tile sizes, and the kernel's tiles are fixed by its design.
"""
from __future__ import annotations

import torch

from .. import _common
from . import kernel, ref

_MAX_GRID_YZ = 65_535


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [B,S,H,hd] and k, v [B,T,KV,hd] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} q heads are not a multiple of "
                         f"{KV} kv heads")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash_attention: head dim {hd} is not a multiple of 8 "
                         f"in [8, 256]")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q, k, v of one "
                        f"dtype expected, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,KV,hd] -> [B,S,H,hd] in q's dtype. q head h
    reads kv head h // (H // KV); causal keeps keys t <= s and ``window`` > 0
    keeps t > s - window, positions counted from 0 in both sequences."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    _common.check_cuda("flash_attention", q, k, v)
    if q.shape[0] > _MAX_GRID_YZ or q.shape[2] > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {q.shape[0]} and heads "
                         f"{q.shape[2]} must be at most {_MAX_GRID_YZ}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.flash_attention(q, k, v, out, causal, max(int(window), 0))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
