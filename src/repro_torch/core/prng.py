"""Counter-based random numbers: the port's counterpart of ``jax.random``.

A :class:`Key` is a pair of 32-bit words held on the host. ``split`` and
``fold_in`` derive child keys on the host (one Philox block each), so the
key tree costs no device work and no sync. Draws (:func:`bits`,
:func:`uniform`, :func:`bernoulli`) evaluate Philox-4x32-10 on the device
over a counter range, written in int64 tensor ops masked to 32 bits: the
same key gives the same bits on the CPU and on the card, which
``torch.Generator`` cannot (its CPU and CUDA streams differ).

Uniforms are built from the bits exactly as ``jax.random.uniform`` builds
them (23 high bits into the mantissa of a float in [1, 2), minus 1), so a
test can feed JAX's bits and get JAX's floats. The bits themselves are not
JAX's: JAX uses threefry.
"""
from __future__ import annotations

import dataclasses
import math

import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
_ROUNDS = 10
# counter word 3 separates the three uses of one key: draws (0), split (1)
# and fold_in (2), so a child key never equals a block of its parent's bits
_DRAW, _SPLIT, _FOLD = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Key:
    """A Philox key: two 32-bit words, on the host."""

    k0: int
    k1: int


def key(seed: int) -> Key:
    seed = int(seed)
    return Key(seed & M32, (seed >> 32) & M32)


def philox_host(ctr: tuple[int, int, int, int], k: Key) -> tuple[int, ...]:
    """One Philox-4x32-10 block in Python ints (the host-side key tree)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = k.k0, k.k1
    for r in range(_ROUNDS):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
        if r < _ROUNDS - 1:
            k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return c0, c1, c2, c3


def split(k: Key, num: int = 2) -> tuple[Key, ...]:
    out = []
    for i in range(num):
        w = philox_host((i, 0, 0, _SPLIT), k)
        out.append(Key(w[0], w[1]))
    return tuple(out)


def fold_in(k: Key, data: int) -> Key:
    data = int(data)
    w = philox_host((data & M32, (data >> 32) & M32, 0, _FOLD), k)
    return Key(w[0], w[1])


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for ``a`` in [0, 2^32): the
    product is split at 16 bits so every partial stays below 2^49."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & M32


def philox(ctr0: torch.Tensor, k: Key, c1: int = 0, c2: int = 0,
           c3: int = _DRAW) -> torch.Tensor:
    """Philox-4x32-10 over the counters ``(ctr0[i], c1, c2, c3)``: int64
    tensor ``[N, 4]`` of 32-bit words, on ``ctr0``'s device."""
    z = torch.zeros_like(ctr0)
    c = [ctr0, z + c1, z + c2, z + c3]
    k0, k1 = k.k0, k.k1
    for r in range(_ROUNDS):
        hi0, lo0 = _mulhilo(c[0], _M0)
        hi1, lo1 = _mulhilo(c[2], _M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        if r < _ROUNDS - 1:
            k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return torch.stack(c, dim=-1)


def bits(k: Key, shape, device) -> torch.Tensor:
    """Uniform 32-bit words as an int64 tensor of ``shape`` (values in
    [0, 2^32)), the port's ``jax.random.bits(key, shape, uint32)``."""
    shape = tuple(shape)
    n = math.prod(shape)
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    return philox(ctr, k).reshape(-1)[:n].reshape(shape)


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) from 32-bit words, as ``jax.random.uniform``
    makes them: ``((b >> 9) | 0x3F800000)`` viewed as f32, minus 1."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: Key, shape, device) -> torch.Tensor:
    return uniform_from_bits(bits(k, shape, device))


def bernoulli(k: Key, p: torch.Tensor) -> torch.Tensor:
    """``uniform < p`` with one uniform per element of ``p``."""
    return uniform(k, p.shape, p.device) < p
