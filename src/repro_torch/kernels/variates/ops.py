"""Wrappers of H2 (:func:`binomial`) and H3 (:func:`hypergeometric`), the
draws of T-TBS / B-TBS and B-RS.

On a CUDA tensor each launches its hand-written kernel
(``csrc/variates.cu``) or raises; there is no fallback. The plain versions
in :mod:`.ref` run only for CPU tensors. Either way a row's loop runs to
its end without the host: on the card H2 takes one thread a row and H3
one CTA a row, so neither trip counts nor results are read back.
``binomial.launches`` and ``hypergeometric.launches`` count kernel
launches.
"""
from __future__ import annotations

import torch

from .. import _common
from . import kernel, ref


def binomial(keys: torch.Tensor, count: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bin(count, clip(p, 0, 1)) for each row of ``keys`` ``[..., 2]``
    (int64 32-bit key words), ``count`` (int) and ``p`` (float) ``[...]``:
    int64 ``[...]``. One launch for all rows."""
    if keys.shape[-1:] != (2,) or count.shape != keys.shape[:-1] or p.shape != count.shape:
        raise ValueError(f"binomial: keys {tuple(keys.shape)} must be [..., 2] and count "
                         f"{tuple(count.shape)} and p {tuple(p.shape)} its rows")
    if keys.device.type == "cpu":
        return ref.binomial_ref(keys, count, p)
    _common.check_cuda("binomial", keys, count, p)
    shape = count.shape
    T = count.numel()
    out = torch.empty(T, dtype=torch.int64, device=keys.device)
    kernel.binomial(out, keys.to(torch.int64).reshape(T, 2).contiguous(),
                    count.to(torch.int64).reshape(T).contiguous(),
                    p.to(torch.float32).reshape(T).contiguous())
    binomial.launches += 1
    return out.reshape(shape)


def hypergeometric(u: torch.Tensor, k: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   trips: int) -> torch.Tensor:
    """HyperGeo(k, a, b) for each row, by inverse transform from the f32
    uniform ``u`` in at most ``trips`` trips (``u``, ``k``, ``a``, ``b``
    ``[...]``, the counts int): int64 ``[...]``. One launch for all rows."""
    if not (u.shape == k.shape == a.shape == b.shape):
        raise ValueError(f"hypergeometric: u {tuple(u.shape)}, k {tuple(k.shape)}, "
                         f"a {tuple(a.shape)} and b {tuple(b.shape)} must agree")
    if u.device.type == "cpu":
        return ref.hypergeometric_ref(u, k, a, b, trips)
    _common.check_cuda("hypergeometric", u, k, a, b)
    shape = u.shape
    T = u.numel()
    out = torch.empty(T, dtype=torch.int64, device=u.device)
    kernel.hypergeometric(out, u.to(torch.float32).reshape(T).contiguous(),
                          *(x.to(torch.int64).reshape(T).contiguous() for x in (k, a, b)),
                          int(trips))
    hypergeometric.launches += 1
    return out.reshape(shape)


binomial.launches = 0
hypergeometric.launches = 0
