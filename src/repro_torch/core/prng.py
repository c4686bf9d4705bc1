"""Counter-based random numbers: the port's counterpart of ``jax.random``.

A :class:`Key` is a pair of 32-bit words held on the host. ``split`` and
``fold_in`` derive child keys on the host (one Philox block each), so the
key tree costs no device work and no sync. Draws (:func:`bits`,
:func:`uniform`, :func:`bernoulli`) evaluate Philox-4x32-10 on the device
over a counter range, written in int64 tensor ops masked to 32 bits: the
same key gives the same bits on the CPU and on the card, which
``torch.Generator`` cannot (its CPU and CUDA streams differ).

Keys may also live on the device, as an int64 tensor ``[..., 2]`` of 32-bit
words, one key per row: the keyed bank folds each touched key id (a device
value) into the tick key. ``fold_in`` and ``split`` take such a key tensor
(or a device tensor of data) and return key tensors, and ``bits`` /
``uniform`` draw row r from row r's key, with the rows as leading
dimensions. Row r's words equal, bit for bit, what the host path gives for
the host key with the same words: both evaluate the same Philox blocks at
the same counters.

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


def _is_host(k) -> bool:
    return isinstance(k, Key)


def split(k, num: int = 2) -> tuple:
    """``num`` child keys: host keys for a host key, int64 ``[..., 2]``
    tensors (one per child, rows as the parent's) for a key tensor."""
    if _is_host(k):
        out = []
        for i in range(num):
            w = philox_host((i, 0, 0, _SPLIT), k)
            out.append(Key(w[0], w[1]))
        return tuple(out)
    w = philox(torch.arange(num, dtype=torch.int64, device=k.device), k,
               c3=_SPLIT)                                      # [..., num, 4]
    return tuple(w[..., i, :2] for i in range(num))


def key_rows(k, num: int, device) -> torch.Tensor:
    """``split(k, num)`` as one int64 key tensor: ``[num, 2]`` for a host
    key, evaluated on ``device`` (no host-to-device copy), or ``[..., num,
    2]`` for a key tensor ``[..., 2]`` (on its device)."""
    dev = device if _is_host(k) else k.device
    ctr = torch.arange(num, dtype=torch.int64, device=dev)
    return philox(ctr, k, c3=_SPLIT)[..., :2]


def fold_in(k, data):
    """Fold ``data`` into ``k``. Host key and int data give a host
    :class:`Key`; a key tensor ``[..., 2]`` or an int64 data tensor gives a
    key tensor with their broadcast leading dimensions (a host key folds
    each element of a device data tensor, as the bank folds key ids)."""
    if _is_host(k) and not isinstance(data, torch.Tensor):
        data = int(data)
        w = philox_host((data & M32, (data >> 32) & M32, 0, _FOLD), k)
        return Key(w[0], w[1])
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64).unsqueeze(-1)                 # [..., 1]
        lo, hi = d & M32, (d >> 32) & M32
    else:
        data = int(data)
        lo = torch.full((1,), data & M32, dtype=torch.int64, device=k.device)
        hi = (data >> 32) & M32
    return philox(lo, k, hi, 0, _FOLD)[..., 0, :2]


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for ``a`` in [0, 2^32): the
    product is split at 16 bits so every partial stays below 2^49."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & M32


def _key_words(k):
    """(k0, k1): Python ints for a host key, int64 ``[..., 1]`` tensors for
    a key tensor (broadcast against the counter axis)."""
    if _is_host(k):
        return k.k0, k.k1
    return k[..., 0:1], k[..., 1:2]


def philox(ctr0: torch.Tensor, k, c1=0, c2: int = 0,
           c3: int = _DRAW) -> torch.Tensor:
    """Philox-4x32-10 over the counters ``(ctr0[i], c1, c2, c3)``: int64
    tensor ``[..., N, 4]`` of 32-bit words, on ``ctr0``'s device. ``k`` is
    a host key (output ``[N, 4]`` for ``ctr0`` [N]) or a key tensor
    ``[..., 2]`` (``ctr0`` [..., N] broadcasts against its rows); ``c1``
    may be a tensor broadcasting against ``ctr0``."""
    k0, k1 = _key_words(k)
    if not _is_host(k):
        ctr0 = ctr0.expand(torch.broadcast_shapes(ctr0.shape, k0.shape))
    z = torch.zeros_like(ctr0)
    c = [ctr0, z + c1, z + c2, z + c3]
    for r in range(_ROUNDS):
        hi0, lo0 = _mulhilo(c[0], _M0)
        hi1, lo1 = _mulhilo(c[2], _M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        if r < _ROUNDS - 1:
            k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return torch.stack(c, dim=-1)


def bits(k, shape, device=None) -> torch.Tensor:
    """Uniform 32-bit words as an int64 tensor (values in [0, 2^32)), the
    port's ``jax.random.bits(key, shape, uint32)``: ``shape`` for a host key
    (on ``device``), ``[..., *shape]`` for a key tensor ``[..., 2]``, row r
    drawn from row r's key (on the key's device)."""
    shape = tuple(shape)
    n = math.prod(shape)
    if _is_host(k):
        ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
        return philox(ctr, k).reshape(-1)[:n].reshape(shape)
    lead = tuple(k.shape[:-1])
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=k.device)
    return philox(ctr, k).reshape(lead + (-1,))[..., :n].reshape(lead + shape)


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) from 32-bit words, as ``jax.random.uniform``
    makes them: ``((b >> 9) | 0x3F800000)`` viewed as f32, minus 1."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k, shape, device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of :func:`bits`' shape."""
    return uniform_from_bits(bits(k, shape, device))


def uniform_for(k, x: torch.Tensor) -> torch.Tensor:
    """One f32 uniform per element of ``x``: ``x``'s shape from a host key,
    or one per row of a key tensor whose rows are ``x``'s elements (a
    Monte-Carlo farm's trials, each drawing from its own key)."""
    if _is_host(k):
        return uniform(k, x.shape, x.device)
    return uniform(k, ())


def bernoulli(k: Key, p: torch.Tensor) -> torch.Tensor:
    """``uniform < p`` with one uniform per element of ``p``."""
    return uniform(k, p.shape, p.device) < p
