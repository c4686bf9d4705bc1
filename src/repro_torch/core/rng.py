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

``binomial``, ``hypergeometric``, ``multivariate_hypergeometric`` and the
argsort ``prefix_permutation`` are not on the R-TBS path and are not ported
yet (ROADMAP queue A).
"""
from __future__ import annotations

import torch

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
