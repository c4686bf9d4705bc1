"""Wrapper of B4, flash attention over the JAX layout [B, S, H, hd].

On CUDA tensors it launches one of two hand-written kernels, chosen by dtype
alone (:func:`route`): bfloat16 goes to the tensor-core kernel
(``csrc/flash_attention_tc.cu``: wgmma fed by TMA), float32 to the CUDA-core
kernel (``csrc/flash_attention.cu``: full f32, no TF32). Both read q, k and
v through their strides, so no transposed copy is made; a bfloat16 layout
that TMA cannot address is refused before any launch. The plain version in
:mod:`.ref` runs only for CPU tensors. ``flash_attention.launches`` counts
the launches of both kernels, ``flash_attention.tensor_core_launches`` those
of the tensor-core kernel. Unlike the JAX wrapper it takes no ``block_q`` /
``block_k``: those were the TPU's tile sizes, and the kernels' tiles are
fixed by their designs.

B4 is forward-only, as in JAX (whose training never runs
``attention_impl="pallas"``): under grad mode a CUDA call whose q, k or v
requires grad raises rather than return an output cut off from the graph.
Training runs ``attention_impl="xla"``, the plain ``sdpa``.

The launch is the registered op ``torch.ops.repro_torch.flash_attention``
(:func:`attend`), so one call is counted the same on every device: its CUDA
implementation launches the kernel :func:`route` chose, its CPU
implementation is the plain version, its fake implementation gives the
output's shape on the meta device (the dry run), and its FLOP formula is
4 B H S T hd, the unmasked count that ``FlopCounterMode``'s SDPA formula
and JAX's dry run use (a causal kernel does about half: :func:`flops_masked`
counts the pairs its mask keeps). The checks, the
route and the launch counters stay here, around the op. A CPU call whose
q, k or v requires grad takes the plain version directly: the op has no
backward.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _common
from .._common import tma_strides
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


def route(dtype: torch.dtype, shapes, strides, bases) -> str:
    """Which kernel takes a CUDA call: ``"tensor_core"`` for bfloat16,
    ``"cuda_core"`` for float32. ``shapes`` and ``strides`` (elements) are
    q's, k's and v's, each with a unit last stride; ``bases`` their data
    pointers. Raises ValueError for a bfloat16 layout whose base or (b, s, h)
    strides TMA cannot address; a dim of extent 1 is never stepped, so its
    stride does not count."""
    if dtype == torch.float32:
        return "cuda_core"
    _common.check_tma("flash_attention", dtype, "qkv", ("bsh",) * 3, shapes, strides, bases)
    return "tensor_core"


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
           which: str) -> torch.Tensor:
    """The registered op: B4 on q [B,S,H,hd], k, v [B,T,KV,hd] as the
    wrapper checked them. On the CPU the plain version (``which`` unread)."""
    return ref.attention_ref(q, k, v, causal=causal, window=window)


@attend.register_kernel("cuda")
def _attend_cuda(q, k, v, causal, window, which):
    """The kernel ``which`` names (:func:`route`), into a new output."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if which == "tensor_core":
        kernel.flash_attention_tc(q, k, v, out, causal, window,
                                  tuple(tma_strides(x.shape, x.stride()) for x in (q, k, v)))
    elif which == "cuda_core":
        kernel.flash_attention(q, k, v, out, causal, window)
    else:
        raise ValueError(f"flash_attention: unknown route {which!r}")
    return out


@attend.register_fake
def _attend_fake(q, k, v, causal, window, which):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """4 B H S T hd: the two products over every (query, key) pair."""
    B, S, H, hd = q_shape
    return 4 * B * H * S * k_shape[1] * hd


@functools.lru_cache(maxsize=64)
def kept_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask of :func:`flash_attention` keeps:
    ``causal`` keeps t <= s, ``window`` > 0 keeps t > s - window."""
    n = 0
    for s in range(S):
        hi = min(s, T - 1) if causal else T - 1
        lo = max(s - window + 1, 0) if window > 0 else 0
        n += max(hi - lo + 1, 0)
    return n


def flops_masked(q_shape, k_shape, causal: bool, window: int) -> int:
    """4 B H hd x the pairs the mask keeps: the work a causal or windowed
    call needs, beside the registered unmasked count (the kernels skip the
    tiles past the mask, so their work lies between the two)."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * kept_pairs(S, k_shape[1], bool(causal), int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,KV,hd] -> [B,S,H,hd] in q's dtype. q head h
    reads kv head h // (H // KV); causal keeps keys t <= s and ``window`` > 0
    keeps t > s - window, positions counted from 0 in both sequences."""
    _check(q, k, v)
    window = max(int(window), 0)
    if q.device.type in ("cpu", "meta"):
        if q.device.type == "cpu" and torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            return ref.attention_ref(q, k, v, causal=causal, window=window)
        return attend(q, k, v, causal, window, "plain")
    _common.check_cuda("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention: kernel B4 has no backward; train with "
                           "attention_impl='xla' (the plain sdpa), as the JAX package does")
    if q.shape[0] > _MAX_GRID_YZ or q.shape[2] > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {q.shape[0]} and heads "
                         f"{q.shape[2]} must be at most {_MAX_GRID_YZ}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    qkv = (q, k, v)
    which = route(q.dtype, [x.shape for x in qkv], [x.stride() for x in qkv],
                  [x.data_ptr() for x in qkv])
    out = attend(q, k, v, causal, window, which)
    if which == "tensor_core":
        flash_attention.tensor_core_launches += 1
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
