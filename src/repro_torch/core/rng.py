"""Random-variate primitives of the R-TBS tick, with each draw split from its
evaluation.

Every function here takes its random bits or uniforms as an operand: the
evaluation is deterministic, so the tests feed it the bits the JAX package
drew and compare the results exactly. The ``draw_*`` helpers make those
operands from a :class:`repro_torch.core.prng.Key`.

All functions broadcast over leading batch dimensions (the Monte-Carlo trial
dimension of the statistical tests): scalars are tensors of shape ``[...]``
and arrays ``[..., L]``. 32-bit unsigned arithmetic is done in int64 and
masked to 32 bits (torch has no uint32 add, remainder or compare on the CPU).

The draws of the paper's other schemes run as kernels on the card:
``binomial`` (T-TBS, B-TBS) through H2 and ``hypergeometric`` (B-RS, and
each link of ``multivariate_hypergeometric``'s chain) through H3
(:mod:`repro_torch.kernels.variates`), so no trip count reaches the host;
on the CPU their plain versions run. The argsort ``prefix_permutation`` is
the exact reference draw of ``rtbs.step_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.variates import ops as va_ops

from . import prng

_SON_M1 = 0x85EBCA6B   # murmur3 mixing constant
_SON_BIT = 0x10000     # swap decision: bit 16 of the mixed hash
SON_ROUNDS = 16


def stochastic_round(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """StochRound(x) = floor(x) + [u < frac(x)], int64; ``u`` is one f32
    uniform per element of ``x`` (the Bernoulli draw of ``jax.random``)."""
    x = x.to(torch.float32)
    lo = torch.floor(x)
    up = u < torch.clamp(x - lo, 0.0, 1.0)
    return (lo + up.to(torch.float32)).to(torch.int64)


def draw_son_bits(key, batch, device,
                  rounds: int = SON_ROUNDS) -> torch.Tensor:
    """The swap-or-not round words ``[*batch, rounds, 2]``; for a key tensor
    ``[T, 2]`` (``batch`` empty) ``[T, rounds, 2]``, row t from key t."""
    return prng.bits(key, tuple(batch) + (rounds, 2), device)


def swap_or_not(rb: torch.Tensor, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Evaluate the keyed swap-or-not permutation of {0..n-1} at ``x``
    [..., L] (entries in [0, n)); ``rb`` [..., rounds, 2] are the round
    words, ``n`` [...] the domain size. Each round reflects x -> K_r - x
    (mod n) when bit 16 of a murmur hash of the {x, partner} pair is set."""
    nn = torch.clamp(n.to(torch.int64), min=1).unsqueeze(-1)      # [..., 1]
    k_all = rb[..., 0] % nn                                       # [..., rounds]
    for r in range(rb.shape[-2]):
        partner = k_all[..., r:r + 1] - x
        partner = torch.where(partner < 0, partner + nn, partner)
        # max(x, partner) < n <= 2^31, so the product stays inside int64
        h = (torch.maximum(x, partner) * _SON_M1 + rb[..., r:r + 1, 1]) & prng.M32
        x = torch.where((h & _SON_BIT) != 0, partner, x)
    return x


def prefix_permutation_fast(rb: torch.Tensor, cap: int, n: torch.Tensor, *,
                            k: int | None = None) -> torch.Tensor:
    """idx[..., k]: entries i < n are pi(i) for the swap-or-not permutation
    pi of {0..n-1}; entries above are the identity. ``cap`` is the domain
    bound and ``k`` (default ``cap``) the consumed prefix length."""
    k = cap if k is None else k
    n = n.to(torch.int64).unsqueeze(-1)                           # [..., 1]
    i = torch.arange(k, dtype=torch.int64, device=rb.device)
    x = swap_or_not(rb, torch.minimum(i, torch.clamp(n, min=1) - 1),
                    n.squeeze(-1))
    return torch.where(i < n, x, i)


def binomial(keys: torch.Tensor, count: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bin(count, clip(p, 0, 1)) per row, int64 ``[...]``: one draw for each
    key row of ``keys`` ``[..., 2]`` (int64 32-bit words), ``count`` (int)
    and ``p`` (f32) ``[...]``. The algorithm is ``jax.random.binomial``'s:
    with q = min(p, 1 - p), inversion (a sum of geometric gaps) where
    count * q <= 10 and BTRS rejection where not, reflected to count - x
    where p >= 0.5. Counter layout: trip i of a row takes Philox block
    (i, 0, 0, DRAW) of that row's key, whose word 0 is inversion's uniform
    and words 0 and 1 BTRS's u and v; the plain version and H2 follow it, so
    one key gives one draw on either. p = 0 or count = 0 give 0 and p = 1
    gives count, explicitly (JAX's results). The stream is not JAX's
    (threefry), so the draw is held to JAX by distribution. One H2 launch on
    the card."""
    return va_ops.binomial(keys, count, p)


def binomial_keys(key, batch, device) -> torch.Tensor:
    """Key rows ``[*batch, 2]`` for :func:`binomial`: row j is
    ``split(key, prod(batch))[j]``, made on ``device``. For a key tensor
    ``[T, 2]`` (``batch`` empty) row t is ``split(key[t], 1)[0]``, the row a
    host key with the same words gives with ``batch`` empty."""
    if isinstance(key, torch.Tensor):
        return prng.split(key, 1)[0]
    batch = tuple(batch)
    return prng.key_rows(key, math.prod(batch), device).reshape(batch + (2,))


def hypergeometric(u: torch.Tensor, k, a, b, *, max_support: int) -> torch.Tensor:
    """HyperGeo(k, a, b), int64 ``[...]``: the number of type-a items when
    ``k`` are drawn without replacement from ``a`` of type a and ``b`` of
    type b, by inverse transform from the f32 uniform ``u`` ``[...]``
    (``jax.random.uniform`` of the JAX function's key): JAX's sequential f32
    cdf over the pmf-ratio recurrence from max(0, k - b), at most
    ``max_support + 1`` trips, min(a, k) where the cdf never reached ``u``.
    It stops at the trip whose cdf reaches ``u``, after which JAX's loop
    changes nothing. ``k``, ``a``, ``b`` are int tensors broadcasting
    against ``u``. One H3 launch on the card."""
    k, a, b = (torch.as_tensor(x, device=u.device).expand(u.shape) for x in (k, a, b))
    return va_ops.hypergeometric(u, k, a, b, max_support + 1)


def draw_hypergeometric(key, batch, device) -> torch.Tensor:
    """The uniform ``[*batch]`` of :func:`hypergeometric` (and of
    :func:`categorical_from_counts`) from a key."""
    return prng.uniform(key, tuple(batch), device)


draw_categorical = draw_hypergeometric


def multivariate_hypergeometric(u: torch.Tensor, k, counts: torch.Tensor, *,
                                max_support: int) -> torch.Tensor:
    """The multivariate hypergeometric split of ``k`` draws over groups of
    ``counts`` ``[..., S]`` (int), int64 ``[..., S]``: JAX's chain of
    conditional draws, group s taking HyperGeo(remaining draws, counts[s],
    the groups after s) from ``u[..., s]``, the uniform of
    ``split(key, S)[s]`` (:func:`draw_multivariate_hypergeometric`). S
    launches of H3 on the card, each reading the last one's remainder on
    the device."""
    counts = counts.to(torch.int64)
    rem_draws = torch.as_tensor(k, device=counts.device).to(torch.int64).expand(
        counts.shape[:-1])
    rem_total = counts.sum(-1)
    xs = []
    for s in range(counts.shape[-1]):
        c_s = counts[..., s]
        other = rem_total - c_s
        x = hypergeometric(u[..., s], rem_draws, c_s, other, max_support=max_support)
        xs.append(x)
        rem_draws, rem_total = rem_draws - x, other
    return torch.stack(xs, dim=-1)


def draw_multivariate_hypergeometric(key, S: int, batch, device) -> torch.Tensor:
    """The uniforms ``[*batch, S]`` of :func:`multivariate_hypergeometric`:
    column s from ``split(key, S)[s]``."""
    rows = prng.key_rows(key, S, device)                     # [S, 2]
    u = prng.uniform(rows, tuple(batch), device)             # [S, *batch]
    return u.movedim(0, -1)


def prefix_permutation(u: torch.Tensor, cap: int, n) -> torch.Tensor:
    """idx[..., cap] whose first ``n`` entries are a uniform random
    permutation of {0..n-1} and whose rest are the remaining slots in
    ascending order: the stable argsort of ``u`` ``[..., cap]`` (the JAX
    function's ``uniform(key, (cap,))``) with slots past ``n`` keyed
    ``2 + slot``. Bit-equal to JAX given its ``u``."""
    slot = torch.arange(cap, dtype=torch.int64, device=u.device)
    n = torch.as_tensor(n, device=u.device).to(torch.int64).unsqueeze(-1)
    sort_key = torch.where(slot < n, u, 2.0 + slot.to(torch.float32))
    return torch.argsort(sort_key, dim=-1, stable=True)


def draw_prefix_permutation(key, cap: int, batch, device) -> torch.Tensor:
    """:func:`prefix_permutation`'s uniforms ``[*batch, cap]``."""
    return prng.uniform(key, tuple(batch) + (cap,), device)


def categorical_from_counts(u: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Index s with probability counts[s] / sum(counts), int64 ``[...]``,
    from the f32 uniform ``u`` ``[...]`` and ``counts`` ``[..., S]`` (ints
    below 2^24, so the f32 sums are exact in any order): the first s whose
    cdf passes ``u * max(total, 1e-30)``, 0 where none does."""
    c = counts.to(torch.float32)
    tot = c.sum(-1)
    x = u * torch.clamp(tot, min=1e-30)
    cdf = torch.cumsum(c, dim=-1)
    return torch.argmax((cdf > x.unsqueeze(-1)).to(torch.int8), dim=-1)

