"""Plain PyTorch versions of H2 (binomial) and H3 (hypergeometric): the
CPU route of their wrappers, and what ``chip_smoke.py`` holds the kernels
to on the card.

Both repeat ``csrc/variates.cu`` operation for operation in f32: every
constant is a 0-d f32 tensor of the value JAX uses, and no Python scalar
divides a tensor (``c / x`` on a tensor is ``x.reciprocal() * c``, and on
the card ``x / c`` multiplies by ``1 / c``: each rounds twice). Rows are
a batch dimension; each loop runs until its last row is done."""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng

_F32 = torch.float32

# f32 values of JAX's double constants (jax/_src/random.py, _btrs and
# _stirling_approx_tail)
_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
         0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
         0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
         0.00833056343336287)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=_F32, device=like.device)


def stirling_tail(k: torch.Tensor) -> torch.Tensor:
    """JAX's ``_stirling_approx_tail``: its table for k <= 9, else the
    series evaluated at k clamped into [0, 9], as JAX evaluates it."""
    kc = torch.clamp(k, 0.0, 9.0)
    kp1 = kc + 1.0
    kp1sq = kp1 * kp1
    approx = (1.0 / 12 - (1.0 / 360 - _c(1.0 / 1260, k) / kp1sq) / kp1sq) / kp1
    tab = torch.tensor(_TAIL, dtype=_F32, device=k.device)
    idx = torch.floor(kc).nan_to_num(0.0).to(torch.int64)     # a NaN k takes approx
    return torch.where(k <= 9.0, tab[idx], approx)


def _uniform_pair(keys: torch.Tensor, i: int):
    """Words 0 and 1 of Philox block (i, 0, 0, DRAW) of each row's key, as
    f32 uniforms."""
    ctr = torch.full(keys.shape[:-1] + (1,), i, dtype=torch.int64, device=keys.device)
    w = prng.philox(ctr, keys)[..., 0, :]
    return prng.uniform_from_bits(w[..., 0]), prng.uniform_from_bits(w[..., 1])


def binomial_ref(keys: torch.Tensor, count: torch.Tensor, p: torch.Tensor, *,
                 return_trips: bool = False):
    """Bin(count, clip(p, 0, 1)) per row, int64 ``[...]``, for ``keys``
    ``[..., 2]`` (int64 32-bit words), ``count`` int and ``p`` f32 ``[...]``.
    JAX's ``jax.random.binomial`` algorithm; trip i of a row takes Philox
    block (i, 0, 0, DRAW) of its key (see :func:`repro_torch.core.rng.binomial`).
    p = 0 and count <= 0 give 0, p = 1 gives count, a NaN p gives -1.
    ``return_trips`` also returns each row's trip count (int64, 0 for the
    edges), the work a bound counts."""
    count = count.to(torch.int64)
    pf = p.to(_F32)
    pc = torch.clamp(pf, 0.0, 1.0)
    n = count.to(_F32)
    lt = pc < 0.5
    q = torch.where(lt, pc, 1.0 - pc)
    inv = n * q <= 10.0
    trivial = torch.isnan(pf) | (count <= 0) | (pc == 0.0) | (pc == 1.0)

    # inversion's state, and BTRS's trip-independent terms (garbage on the
    # rows of the other route, which never read them)
    l1mq = torch.log1p(-q)
    num_geom = torch.zeros_like(n)
    geom_sum = torch.zeros_like(n)
    qb = torch.where(inv, _c(0.25, q), q)          # keeps BTRS's terms finite
    stddev = torch.sqrt(n * qb * (1.0 - qb))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * qb
    c = n * qb + 0.5
    v_r = 0.92 - _c(4.2, b) / b
    r = qb / (1.0 - qb)
    alpha = (2.83 + _c(5.1, b) / b) * stddev
    m = torch.floor((n + 1.0) * qb)
    nm1 = n - m + 1.0
    t_m = (m + 0.5) * torch.log((m + 1.0) / (r * nm1))
    st_m, st_nm = stirling_tail(m), stirling_tail(n - m)

    s = torch.zeros_like(n)
    active = ~trivial
    trips = torch.zeros_like(count)
    i = 0
    while bool(active.any()):
        trips = trips + active.to(torch.int64)
        u0, v = _uniform_pair(keys, i)
        # inversion: one geometric gap a trip
        act_i = active & inv
        num_geom = torch.where(act_i, num_geom + 1.0, num_geom)
        geom_sum = torch.where(act_i, geom_sum + torch.ceil(torch.log(u0) / l1mq), geom_sum)
        done_i = act_i & ~(geom_sum <= n)
        s = torch.where(done_i, num_geom - 1.0, s)
        # BTRS: one proposal a trip
        act_b = active & ~inv
        u = u0 - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2.0 * a / us + b) * u + c)
        reject = (k < 0.0) | (k > n)
        lv = torch.log(v * alpha / (a / (us * us) + b))
        nk1 = n - k + 1.0
        ub = t_m + (n + 1.0) * torch.log(nm1 / nk1)
        ub = ub + (k + 0.5) * torch.log(r * nk1 / (k + 1.0))
        ub = ub + st_m + st_nm - stirling_tail(k) - stirling_tail(n - k)
        done_b = act_b & (accept1 | (~reject & (lv <= ub)))
        s = torch.where(done_b, k, s)
        active = active & ~(done_i | done_b)
        i += 1

    x = torch.where(lt, s, n - s).to(torch.int64)
    x = torch.where(pc == 1.0, count, x)
    x = torch.where((count <= 0) | (pc == 0.0), 0, x)
    x = torch.where(torch.isnan(pf), -1, x)
    return (x, trips) if return_trips else x


# XLA's Lanczos coefficients (g = 7), as f32
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` evaluated in f64 and rounded to f32: the correctly rounded
    f32 value but where the f64 result lies within its own error of an f32
    rounding tie, so the CPU and the card agree."""
    return fn(x.double()).to(_F32)


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) for f32 x >= 0.5 as XLA computes ``lax.lgamma``: the
    Lanczos approximation its ``lgamma`` lowers to, in its f32 operation
    order, with the multiply-add that XLA:CPU contracts rounded once.
    ``torch.lgamma`` rounds differently at large x (by about 4e-3 at
    x = 5,000), enough to move a hypergeometric draw in ~1 % of draws.
    The formula's two logarithms are evaluated in f64 and rounded to f32:
    an ulp of log t moves the result by about x ulp(log t), and the f32
    libraries of the CPU and the card round log t apart often enough to
    move a draw; JAX's draws are matched as often either way."""
    z = x - 1.0
    t = z + 7.5
    log_t = _f64(torch.log1p, z * _c(1.0 / 7.5, x)) + _c(math.log(7.5), x)
    # one rounding of (z + 1/2 - t / log_t) * log_t + log(sqrt(2 pi))
    w = ((z + 0.5 - t / log_t).double() * log_t.double()
         + float(_c(0.5 * math.log(2.0 * math.pi), x))).to(_F32)
    a = _c(_LANCZOS[0], x) / (z + 1.0) + 1.0
    for i in range(1, len(_LANCZOS)):
        a = a + _c(_LANCZOS[i], x) / (z + float(i + 1))
    return w + _f64(torch.log, a)


def log_comb(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """log C(n, k) as JAX's ``_log_comb`` forms it in f32."""
    return lgamma(n + 1.0) - lgamma(k + 1.0) - lgamma(n - k + 1.0)


def hypergeometric_ref(u: torch.Tensor, k: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       trips: int) -> torch.Tensor:
    """HyperGeo(k, a, b) per row by inverse transform from the uniform
    ``u`` (f32 ``[...]``; ``k``, ``a``, ``b`` int ``[...]``), int64: JAX's
    sequential f32 cdf over the pmf-ratio recurrence, at most ``trips``
    trips; a row stops at the trip whose cdf reaches ``u`` or past its
    support, and takes hi = min(a, k) where the cdf never reached ``u``."""
    k, a, b = (x.to(_F32) for x in (k, a, b))
    u = u.to(_F32)
    lo = torch.clamp(k - b, min=0.0)
    hi = torch.minimum(a, k)
    logp = log_comb(a, lo) + log_comb(b, k - lo) - log_comb(a + b, k)
    cdf = torch.zeros_like(u)
    val = torch.full_like(u, -1.0)
    bk = b - k
    active = torch.ones_like(u, dtype=torch.bool)
    for i in range(trips):
        s = lo + float(i)
        active = active & (s <= hi)
        if i % 32 == 0 and not bool(active.any()):    # finished rows are masked
            break
        cdf = torch.where(active, cdf + torch.exp(logp), cdf)
        take = active & (cdf >= u)
        val = torch.where(take, s, val)
        active = active & ~take
        num = (a - s) * (k - s)
        den = (s + 1.0) * (bk + s + 1.0)
        ratio = torch.where((num > 0) & (den > 0), num / den, 1.0)
        logp = logp + torch.log(ratio)
    return torch.where(val < 0, hi, val).to(torch.int64)


def hypergeometric_blocked_ref(u: torch.Tensor, k: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, trips: int, block: int) -> torch.Tensor:
    """:func:`hypergeometric_ref` in H3's order of work: ``block`` trips
    at a time, each block's log-ratios and exps one vector op each, and
    only the two running sums, logp and cdf, a trip at a time, one f32 add
    each, in the serial loop's order (never ``torch.cumsum``, whose order
    and accumulator are not f32 left to right). A row ends at the first
    trip of a block that is past hi or whose cdf reaches ``u``, and takes
    hi where no trip below ``trips`` did. Bit-equal to
    :func:`hypergeometric_ref`."""
    shape = u.shape
    k, a, b = (x.to(_F32).reshape(-1, 1) for x in (k, a, b))
    u = u.to(_F32).reshape(-1, 1)
    lo = torch.clamp(k - b, min=0.0)
    hi = torch.minimum(a, k)
    bk = b - k
    logp = (log_comb(a, lo) + log_comb(b, k - lo) - log_comb(a + b, k))[:, 0]
    cdf = torch.zeros_like(logp)
    val = torch.full_like(logp, -1.0)
    done = torch.zeros_like(logp, dtype=torch.bool)
    for g0 in range(0, trips, block):
        if bool(done.all()):
            break
        s = lo + torch.arange(g0, min(g0 + block, trips), device=u.device).to(_F32)
        num = (a - s) * (k - s)
        den = (s + 1.0) * (bk + s + 1.0)
        lr = torch.log(torch.where((num > 0) & (den > 0), num / den, 1.0))
        lp = torch.empty_like(lr)
        for i in range(lr.shape[1]):
            lp[:, i] = logp
            logp = logp + lr[:, i]
        e = torch.exp(lp)
        c = torch.empty_like(e)
        for i in range(e.shape[1]):
            cdf = cdf + e[:, i]
            c[:, i] = cdf
        stop = ~(s <= hi) | (c >= u)
        first = stop.to(torch.int8).argmax(1, keepdim=True)    # the first stop, if any
        sf, cf = s.gather(1, first)[:, 0], c.gather(1, first)[:, 0]
        ends = stop.any(1) & ~done
        val = torch.where(ends & (sf <= hi[:, 0]) & (cf >= u[:, 0]), sf, val)
        done = done | ends
    return torch.where(val < 0, hi[:, 0], val).to(torch.int64).reshape(shape)


def hypergeometric_cdf(k: int, a: int, b: int, trips: int):
    """The f32 cdf of :func:`hypergeometric_ref` for one (k, a, b), trip by
    trip while the trip is inside the support: ``(values, cdf)`` as f64
    numpy arrays, cdf[i] the cdf after trip i, whose value is values[i]."""
    import numpy as np

    kf, af, bf = (torch.tensor(float(v)) for v in (k, a, b))
    lo = torch.clamp(kf - bf, min=0.0)
    hi = torch.minimum(af, kf)
    logp = log_comb(af, lo) + log_comb(bf, kf - lo) - log_comb(af + bf, kf)
    cdf = torch.zeros(())
    cs, vals = [], []
    for i in range(trips):
        s = lo + float(i)
        if not bool(s <= hi):
            break
        cdf = cdf + torch.exp(logp)
        cs.append(float(cdf))
        vals.append(float(s))
        num = (af - s) * (kf - s)
        den = (s + 1.0) * (bf - kf + s + 1.0)
        logp = logp + torch.log(torch.where((num > 0) & (den > 0), num / den, 1.0))
    return np.asarray(vals, np.float64), np.asarray(cs, np.float64)


def hypergeometric_implied(k: int, a: int, b: int, trips: int):
    """The exact distribution of :func:`hypergeometric_ref` for one
    (k, a, b) over a uniform ``u``: value s takes the increment of the f32
    cdf at s (the cdf clipped at 1), and hi takes as well the mass of every
    ``u`` the cdf never reaches (the guard). Returns ``(values, probs)`` as
    f64 numpy arrays: what the draws of the reference algorithm follow,
    to set beside the analytic pmf."""
    import numpy as np

    vals, cs = hypergeometric_cdf(k, a, b, trips)
    cs = np.minimum(cs, 1.0)
    probs = np.diff(np.concatenate([[0.0], cs]))
    guard = 1.0 - cs[-1] if cs.size else 1.0
    return np.append(vals, float(min(a, k))), np.append(probs, guard)
