"""Operands that cover H2's and H3's routes and edges, made on a device from
a seed; ``chip_smoke.py`` and the card tests hold the kernels to their
plain versions on them."""
from __future__ import annotations

import torch

from repro_torch.core import prng, rng

from . import ref
from .kernel import H3_BLOCK

# H3's support bound on the main B-RS tick: max_support = bcap = 65,536
H3_TRIPS = 65_537
# a trips cap inside H3's second block
H3_CAP_MID_BLOCK = H3_BLOCK + 44


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


def _h3_edges():
    """``((k, a, b), trip)`` rows whose stop falls where H3's blocks of
    B = H3_BLOCK trips meet: ``trip`` is the trip the draw ends on, "mode"
    for the most likely trip, or None where the f32 cdf never reaches u
    (the guard returns hi)."""
    B = H3_BLOCK
    rows = [((3, 100, 100), 0)]                        # the first trip of block 0
    # lo = 0 and the mass at k / 5: the last and the first trip of blocks
    # 0 | 1 and 1 | 2
    for trip in (B - 1, B, 2 * B - 1, 2 * B):
        rows.append(((5 * trip, 4 * B, 16 * B), trip))
    # hi ends mid-block 1: B + 32 trips from lo = 16, the mass near trip
    # B + 16 (a b / (a - lo - trip) = a (B + 16) / 15 puts the mean there)
    a = B + 47
    b = a * (B + 16) // 15
    rows.append(((b + 16, a, b), "mode"))
    # supports of m + 1 trips from lo = a - m to hi = a whose mass sits at
    # hi: all but m of a items of type a and a (m - 1) of type b drawn.
    # hi ends mid-block 1; a support of exactly B trips; one of B + 1
    a = B + 44
    for m in (a, B - 1, B):
        b = a * (m - 1)
        rows.append(((a + b - m, a, b), m))
    rows += [((1000, 3000, 7000), None),               # 1,001 trips; the cdf never reaches u
             ((100, 300, 700), None)]
    return rows


def h3_edge_windows():
    """``[((k, a, b), trip, lo, hi)]``: H3's block-edge rows
    (:func:`_h3_edges`) with the window of uniforms ``lo < u <= hi`` that
    ends each draw on its trip (-1 for the guard: a u above the f32 cdf's
    last value). The cdf is the plain version's, on the CPU, clipped at 1."""
    import numpy as np

    out = []
    for (k, a, b), trip in _h3_edges():
        _, cs = ref.hypergeometric_cdf(k, a, b, H3_TRIPS)
        cs = np.minimum(cs, 1.0)
        if trip == "mode":
            trip = int(np.argmax(np.diff(np.concatenate([[0.0], cs]))))
        lo, hi = (cs[-1], 1.0) if trip is None else (cs[trip - 1] if trip else 0.0, cs[trip])
        assert hi - lo > 1e-4, ((k, a, b), trip, lo, hi)
        out.append(((k, a, b), -1 if trip is None else trip, float(lo), float(hi)))
    return out


def hypergeometric_edge_rows(device):
    """``(u, k, a, b, trip)`` [R]: the rows of :func:`h3_edge_windows`, u
    halfway through each window, so that a last-bit difference of a
    transcendental moves no draw; ``trip`` int64 is the trip each draw
    ends on (-1: the guard returns hi)."""
    import numpy as np

    rows = h3_edge_windows()
    k, a, b = torch.tensor([r[0] for r in rows], dtype=torch.int64, device=device).unbind(1)
    u = torch.tensor(np.asarray([(r[2] + r[3]) / 2 for r in rows], np.float32), device=device)
    return u, k, a, b, torch.tensor([r[1] for r in rows], dtype=torch.int64, device=device)
