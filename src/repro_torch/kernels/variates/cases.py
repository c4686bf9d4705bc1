"""Operands that cover H2's and H3's routes and edges, made on a device from
a seed; ``chip_smoke.py`` and the card tests hold the kernels to their
plain versions on them."""
from __future__ import annotations

import torch

from repro_torch.core import prng, rng

# H3's support bound on the main B-RS tick: max_support = bcap = 65,536
H3_TRIPS = 65_537


def binomial_rows(N: int, device, seed: int = 0):
    """``(keys [N, 2], count [N], p [N])``: eighths of inversion rows
    (count * q <= 10), rows at count * q within 1 % of 10, BTRS rows with
    counts up to 2^22, rows of the main T-TBS tick (count near 2^20..2^22,
    p = e^-0.03; count 65,536, q = 0.4729), and edges (count 0, p 0, p 1,
    p outside [0, 1]); q below or above 1/2 alike."""
    g = torch.Generator(device=device).manual_seed(seed)

    def unif(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)

    e = N // 8
    parts = []
    # inversion: count in [1, 1000], count * q in (0, 10]
    c = unif(1, 1001, 2 * e).floor()
    parts.append((c, unif(0, 1, 2 * e) * torch.clamp(10 / c, max=0.5)))
    # the route boundary: count * q within 1 % of 10
    c = unif(21, 4096, e).floor()
    parts.append((c, unif(9.9, 10.1, e) / c))
    # BTRS: log-uniform counts in [11, 2^22], q in [10 / count, 1/2]
    c = torch.exp(unif(2.4, 22 * 0.6931471805599453, 2 * e)).floor()
    parts.append((c, unif(0, 1, 2 * e) * (0.5 - 10 / c) + 10 / c))
    # the main T-TBS tick's rows
    c = unif(2 ** 20, 2 ** 22, e).floor()
    parts.append((c, torch.full_like(c, 1 - 0.970445533548508)))
    parts.append((torch.full((e,), 65536.0, dtype=torch.float64, device=device),
                  torch.full((e,), 0.4729, dtype=torch.float64, device=device)))
    count = torch.cat([c for c, _ in parts])
    q = torch.cat([q for _, q in parts])
    flip = torch.rand(count.shape, generator=g, device=device) < 0.5
    p = torch.where(flip, 1 - q, q)
    # edges
    rest = N - count.shape[0]
    ec = unif(0, 2 ** 22, rest).floor()
    ep = unif(-0.5, 1.5, rest)
    k = torch.arange(rest, device=device) % 5
    ec = torch.where(k == 0, 0.0, ec)
    ep = torch.where(k == 1, 0.0, torch.where(k == 2, 1.0, ep))
    count = torch.cat([count, ec]).to(torch.int64)
    p = torch.cat([p, ep]).to(torch.float32)
    keys = rng.binomial_keys(prng.key(seed), (N,), device)
    return keys, count, p


def hypergeometric_rows(N: int, device, seed: int = 0):
    """``(u, k, a, b)`` [N]: halves of B-RS-like rows (a = |B| up to 65,536,
    b = W up to 2^21, k = min(n, W + |B|): supports up to 65,537 wide),
    small populations (a, b below 300) and edges (k = 0, a = 0, b = 0)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=device)

    h, q = N // 2, N // 4
    a1, b1 = ints(0, 65_537, h), ints(0, 1 << 21, h)
    k1 = torch.minimum(ints(1, 1 << 20, h), a1 + b1)
    a2, b2 = ints(0, 300, q), ints(0, 300, q)
    k2 = (torch.rand(q, generator=g, device=device) * (a2 + b2 + 1)).floor().to(torch.int64)
    r = N - h - q
    a3, b3 = ints(0, 50, r), ints(0, 50, r)
    m = torch.arange(r, device=device) % 3
    a3 = torch.where(m == 1, 0, a3)
    b3 = torch.where(m == 2, 0, b3)
    k3 = torch.where(m == 0, 0, torch.minimum(ints(0, 60, r), a3 + b3))
    k, a, b = torch.cat([k1, k2, k3]), torch.cat([a1, a2, a3]), torch.cat([b1, b2, b3])
    u = prng.uniform(prng.key(seed + 1), (N,), device)
    return u, k, a, b
