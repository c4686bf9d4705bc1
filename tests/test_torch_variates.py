"""The draws of the paper's other schemes (``repro_torch.core.rng``) and
their kernels' plain versions (``kernels/variates``, H2 and H3) against
``repro.core.rng``: the argsort permutation, the hypergeometric draws and
the categorical draw are bit-equal given JAX's uniforms; the binomial,
whose stream cannot be JAX's, is held by distribution; the JAX tests'
statistical and property checks are re-run on the port's own draws."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_jax_draws import t, uniform
from repro.core import rng as jrng
from repro_torch.core import prng, rng
from repro_torch.kernels.variates import ops as va_ops
from repro_torch.kernels.variates import ref as va_ref

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tests run long chains of small tensor ops. The suite's
    parallel workers already fill the cores, and intra-op threads on top
    of them only wait on each other, so each test runs single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# bit for bit given JAX's uniforms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cap,n", [(12, 7), (64, 64), (33, 0), (9, 1), (300, 257)])
def test_prefix_permutation_equals_jax(cap, n):
    for s in range(3):
        key = jax.random.key(100 * cap + 10 * n + s)
        want = np.asarray(jrng.prefix_permutation(key, cap, jnp.int32(n)))
        got = rng.prefix_permutation(uniform(key, (cap,)), cap, torch.tensor(n))
        np.testing.assert_array_equal(got.numpy(), want)


def _hg_cases(bcap, N, seed):
    """B-RS's draws: M ~ HyperGeo(C = min(n, W + B), B, W), max_support bcap."""
    rs = np.random.RandomState(seed)
    bcount = rs.randint(0, bcap + 1, N)
    W = rs.randint(0, 5000, N)
    C = np.minimum(rs.randint(1, 4096, N), W + bcount)
    return C, bcount, W


@pytest.mark.parametrize("bcap", [8, 64, 256, 1024])
def test_hypergeometric_equals_jax(bcap):
    """150 draws a support bound (600 in all), the port fed JAX's uniform,
    equal to JAX's draw bit for bit. The port's log Gamma is XLA's Lanczos
    formula (``kernels/variates/ref.lgamma``); torch.lgamma would miss
    JAX's draw on ~1 % of these."""
    N = 150
    C, bcount, W = _hg_cases(bcap, N, bcap)
    keys = jax.random.split(jax.random.key(bcap), N)
    f = jax.vmap(lambda k, c, b, w: jrng.hypergeometric(k, c, b, w, max_support=bcap))
    want = np.asarray(jax.jit(f)(keys, jnp.asarray(C), jnp.asarray(bcount), jnp.asarray(W)))
    u = t(jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys))
    got = rng.hypergeometric(u, torch.from_numpy(C), torch.from_numpy(bcount),
                             torch.from_numpy(W), max_support=bcap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,a,b", [(0, 5, 5), (10, 10, 0), (5, 0, 9), (7, 10, 15),
                                   (16, 8, 8), (3, 40, 1)])
def test_hypergeometric_edges_equal_jax(k, a, b):
    """``TestRng.test_hypergeometric_edges``' cases and a few more, over
    50 keys each: JAX's draw bit for bit, inside the support."""
    keys = jax.random.split(jax.random.key(1000 * k + 10 * a + b), 50)
    want = np.asarray(jax.jit(jax.vmap(
        lambda kk: jrng.hypergeometric(kk, k, a, b, max_support=16)))(keys))
    u = t(jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float32))(keys))
    got = rng.hypergeometric(u, k, a, b, max_support=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= max(0, k - b) and got.max() <= min(a, k)
    if (k, a, b) in ((0, 5, 5), (10, 10, 0), (5, 0, 9)):
        assert (got == {0: 0, 10: 10, 5: 0}[k]).all()


def test_lgamma_equals_xla():
    """The port's log Gamma against ``jax.scipy.special.gammaln`` on the
    arguments the draws use (n + 1 for integers n): equal but where
    XLA:CPU's f32 log / log1p round apart from torch's, and there within 3
    ulp (162 of these 20,000 arguments differ with torch 2.13.0 and jax
    0.9.0 on the CPU; torch.lgamma differs on 9,558)."""
    from jax.scipy.special import gammaln

    x = np.arange(1, 20001, dtype=np.float32)
    want = np.asarray(gammaln(jnp.asarray(x)))
    got = va_ref.lgamma(torch.from_numpy(x)).numpy()
    ulp = np.spacing(np.abs(want))
    diff = np.abs(got.astype(np.float64) - want) / ulp
    assert diff.max() <= 3
    ours = int((got != want).sum())
    theirs = int((torch.lgamma(torch.from_numpy(x)).numpy() != want).sum())
    assert ours < theirs / 10, (ours, theirs)


def test_multivariate_hypergeometric_equals_jax():
    counts = np.array([3, 0, 7, 5, 11], np.int32)
    S, N = counts.shape[0], 60
    keys = jax.random.split(jax.random.key(7), N)
    ks = np.arange(N) % 27
    want = np.asarray(jax.jit(jax.vmap(lambda kk, k: jrng.multivariate_hypergeometric(
        kk, k, jnp.asarray(counts), max_support=16)))(keys, jnp.asarray(ks)))
    u = t(jax.vmap(lambda kk: jax.vmap(lambda k2: jax.random.uniform(k2, dtype=jnp.float32))(
        jax.random.split(kk, S)))(keys))
    got = rng.multivariate_hypergeometric(u, torch.from_numpy(ks),
                                          torch.from_numpy(counts).expand(N, S),
                                          max_support=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_from_counts_equals_jax():
    rs = np.random.RandomState(3)
    for s in range(60):
        counts = rs.randint(0, 1 << 20, size=rs.randint(1, 9)).astype(np.int32)
        if s % 7 == 0:
            counts[:] = 0
        key = jax.random.key(s)
        want = int(jrng.categorical_from_counts(key, jnp.asarray(counts)))
        got = int(rng.categorical_from_counts(uniform(key), torch.from_numpy(counts)))
        assert got == want


# --------------------------------------------------------------------------
# the JAX tests' statistical checks on the port's own draws
# --------------------------------------------------------------------------
def test_hypergeometric_pmf():
    """``TestRng.test_hypergeometric_pmf``: 40,000 draws, pmf within 0.012."""
    k, a, b = 7, 10, 15
    u = rng.draw_hypergeometric(prng.key(0), (40_000,), "cpu")
    draws = rng.hypergeometric(u, k, a, b, max_support=32).numpy()
    support = range(max(0, k - b), min(a, k) + 1)
    for x in support:
        p = math.comb(a, x) * math.comb(b, k - x) / math.comb(a + b, k)
        assert abs(float(np.mean(draws == x)) - p) < 0.012, x
    assert draws.min() >= max(0, k - b) and draws.max() <= min(a, k)


def test_multivariate_hypergeometric():
    """``TestRng.test_multivariate_hypergeometric``: 20,000 splits, exact
    partitions, means within 0.05."""
    counts = torch.tensor([3, 0, 7, 5])
    k = 9
    u = rng.draw_multivariate_hypergeometric(prng.key(2), 4, (20_000,), "cpu")
    draws = rng.multivariate_hypergeometric(u, k, counts.expand(20_000, 4),
                                            max_support=16).numpy()
    assert (draws.sum(axis=1) == k).all()
    assert (draws <= counts.numpy()).all()
    np.testing.assert_allclose(draws.mean(axis=0), k * counts.numpy() / counts.sum().item(),
                               atol=0.05)


@pytest.mark.parametrize("count,p", [(20, 0.2), (12, 0.7), (30, 0.31),     # inversion
                                     (100, 0.3), (60, 0.8), (400, 0.5)])   # BTRS
def test_binomial_pmf(count, p):
    """Bin(count, p) over 40,000 draws: pmf within 0.012 of
    ``scipy.stats.binom`` (the tolerance of the JAX hypergeometric pmf
    test), on both of JAX's routes (count * min(p, 1 - p) <= 10: inversion;
    else BTRS), each reflected where p >= 0.5."""
    N = 40_000
    keys = rng.binomial_keys(prng.key(count), (N,), "cpu")
    draws = rng.binomial(keys, torch.full((N,), count), torch.full((N,), p)).numpy()
    assert draws.min() >= 0 and draws.max() <= count
    pmf = scipy.stats.binom.pmf(np.arange(count + 1), count, p)
    emp = np.bincount(draws, minlength=count + 1) / N
    assert np.abs(emp - pmf).max() < 0.012
    assert abs(draws.mean() - count * p) < 5 * math.sqrt(count * p * (1 - p) / N)


def test_binomial_edges():
    """p = 0 and count = 0 give 0, p = 1 gives count (JAX's results, made
    explicitly), p is clipped into [0, 1], a NaN p gives -1; a large count
    at count * q just past 10 takes BTRS and stays in range."""
    keys = rng.binomial_keys(prng.key(5), (9,), "cpu")
    count = torch.tensor([0, 7, 7, 0, 1 << 22, 9, 9, 1 << 22, 11])
    p = torch.tensor([0.3, 0.0, 1.0, 1.0, 1.0, -0.5, 1.5, 2.5e-6, float("nan")])
    got = rng.binomial(keys, count, p).tolist()
    assert got[:7] == [0, 0, 7, 0, 1 << 22, 0, 9]
    assert 0 <= got[7] <= count[7] and got[8] == -1
    want = [int(jrng.binomial(jax.random.key(0), int(c), float(q)))
            for c, q in zip(count[:7].tolist(), p[:7].tolist())]
    assert got[:7] == want


def test_binomial_counter_layout():
    """Trip i of a row reads Philox block (i, 0, 0, DRAW) of its key: the
    inversion route's draw recomputed from ``prng.bits`` of that key."""
    key = prng.key(11)
    row = rng.binomial_keys(key, (1,), "cpu")
    k = prng.Key(int(row[0, 0]), int(row[0, 1]))
    count, p = 40, 0.1                                  # count * p = 4: inversion
    words = prng.bits(k, (4 * 64,), "cpu").reshape(64, 4)[:, 0]
    u = prng.uniform_from_bits(words)
    l1mq = np.float32(math.log1p(-np.float32(p)))
    gsum, num = np.float32(0), 0
    for i in range(64):
        if not gsum <= count:
            break
        num += 1
        gsum = np.float32(gsum + np.ceil(np.float32(np.log(np.float32(u[i])) / l1mq)))
    got = int(rng.binomial(row, torch.tensor([count]), torch.tensor([p]))[0])
    assert got == num - 1
    # the same key always gives the same draw; other keys other draws
    more = rng.binomial_keys(key, (64,), "cpu")
    a = rng.binomial(more, torch.full((64,), 50), torch.full((64,), 0.4))
    assert torch.equal(a, rng.binomial(more, torch.full((64,), 50), torch.full((64,), 0.4)))
    assert len(set(a.tolist())) > 3


@settings(max_examples=50, deadline=None)
@given(k=st.integers(0, 20), a=st.integers(0, 20), b=st.integers(0, 20),
       seed=st.integers(0, 10_000))
def test_hypergeometric_support(k, a, b, seed):
    """``tests/test_properties.py``'s twin: draws land in
    [max(0, k - b), min(a, k)]."""
    k = min(k, a + b)
    u = rng.draw_hypergeometric(prng.key(seed), (), "cpu")
    x = int(rng.hypergeometric(u, k, a, b, max_support=64))
    assert max(0, k - b) <= x <= min(a, k)


@settings(max_examples=30, deadline=None)
@given(total=st.integers(0, 30), counts=st.lists(st.integers(0, 10), min_size=2, max_size=6),
       seed=st.integers(0, 10_000))
def test_mvhg_partition(total, counts, seed):
    """``tests/test_properties.py``'s twin: splits are exact partitions."""
    total = min(total, sum(counts))
    u = rng.draw_multivariate_hypergeometric(prng.key(seed), len(counts), (), "cpu")
    xs = rng.multivariate_hypergeometric(u, total, torch.tensor(counts),
                                         max_support=16).numpy()
    assert xs.sum() == total
    assert (xs >= 0).all() and (xs <= np.asarray(counts)).all()


# --------------------------------------------------------------------------
# H3's blocked order of work (``ref.hypergeometric_blocked_ref``: the
# kernel's block logic, vector log-ratios and exps, two ordered f32 sums)
# --------------------------------------------------------------------------
def _jax_hg(keys, k, a, b, trips):
    """JAX's draws for ``keys`` [N] (max_support = trips - 1) and the port's
    uniforms for them."""
    f = jax.jit(jax.vmap(lambda kk, K, A, B: jrng.hypergeometric(kk, K, A, B,
                                                                max_support=trips - 1)))
    want = np.asarray(f(keys, *(jnp.asarray(np.asarray(x)) for x in (k, a, b))))
    u = t(jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float32))(keys))
    return want, u


def test_hypergeometric_blocked_equals_plain_and_jax_on_the_sweep():
    """256 rows of ``cases.hypergeometric_rows`` (B-RS-like supports up to
    65,537 trips, small and edge populations) with JAX's uniforms: the
    blocked plain version, the plain version and JAX's draw agree bit for
    bit."""
    from repro_torch.kernels.variates import cases, kernel

    _, k, a, b = cases.hypergeometric_rows(256, "cpu", seed=2)
    want, u = _jax_hg(jax.random.split(jax.random.key(7), 256), k, a, b, cases.H3_TRIPS)
    plain = va_ref.hypergeometric_ref(u, k, a, b, cases.H3_TRIPS)
    blocked = va_ref.hypergeometric_blocked_ref(u, k, a, b, cases.H3_TRIPS, kernel.H3_BLOCK)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(blocked.numpy(), want)


def _keys_in_windows(windows, seed):
    """A JAX key for each ``(lo, hi)`` window whose f32 uniform falls in the
    window's middle half."""
    keys = jax.random.split(jax.random.key(seed), 1 << 16)
    us = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float32))(keys))
    idx = []
    for lo, hi in windows:
        q = (hi - lo) / 4
        idx.append(int(np.nonzero((us > lo + q) & (us < hi - q))[0][0]))
    return keys[np.asarray(idx)]


@pytest.mark.parametrize("cap", ["support", "mid_block"])
def test_hypergeometric_blocked_on_block_edges_equals_plain_and_jax(cap):
    """H3's block-edge rows (``cases.h3_edge_windows``, B = H3_BLOCK:
    hits on the first trip of block 0 and on the last and the first trip
    of blocks 0 | 1 and 1 | 2, hi ending mid-block, supports of exactly B
    and B + 1 trips, rows whose cdf never reaches u), each with
    a JAX key whose uniform ends the draw on that trip, under the full
    trips bound and under a cap inside the second block: blocked == plain
    == JAX, and under the full bound each draw ends where it was aimed."""
    from repro_torch.kernels.variates import cases, kernel

    rows = cases.h3_edge_windows()
    k, a, b = (torch.tensor([r[0][i] for r in rows]) for i in range(3))
    trips = cases.H3_TRIPS if cap == "support" else cases.H3_CAP_MID_BLOCK
    want, u = _jax_hg(_keys_in_windows([r[2:] for r in rows], 11), k, a, b, trips)
    plain = va_ref.hypergeometric_ref(u, k, a, b, trips)
    blocked = va_ref.hypergeometric_blocked_ref(u, k, a, b, trips, kernel.H3_BLOCK)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(blocked.numpy(), want)
    lo, hi = torch.clamp(k - b, min=0), torch.minimum(a, k)
    aim = torch.tensor([r[1] for r in rows])
    if cap == "support":
        assert torch.equal(blocked, torch.where(aim < 0, hi, lo + aim))
    else:       # the cap ends every draw aimed past it at hi
        past = aim >= trips
        assert past.any() and torch.equal(blocked[past], hi[past])


def test_hypergeometric_edge_rows_end_where_aimed():
    """``cases.hypergeometric_edge_rows`` (the card's block-edge rows, u
    halfway through each window): the plain and blocked versions end each
    draw on its trip, or at hi by the guard."""
    from repro_torch.kernels.variates import cases, kernel

    u, k, a, b, aim = cases.hypergeometric_edge_rows("cpu")
    lo, hi = torch.clamp(k - b, min=0), torch.minimum(a, k)
    want = torch.where(aim < 0, hi, lo + aim)
    assert torch.equal(va_ref.hypergeometric_ref(u, k, a, b, cases.H3_TRIPS), want)
    for trips in (cases.H3_TRIPS, cases.H3_CAP_MID_BLOCK, kernel.H3_BLOCK,
                  kernel.H3_BLOCK + 1):
        assert torch.equal(va_ref.hypergeometric_blocked_ref(u, k, a, b, trips, kernel.H3_BLOCK),
                           va_ref.hypergeometric_ref(u, k, a, b, trips))


@pytest.mark.parametrize("block", [1, 7, 32, 256, 1000])
def test_hypergeometric_blocked_any_block_size(block):
    """The blocked version's result does not depend on its block size: 200
    B-RS-like rows (``_hg_cases``), 256 small-population and edge rows of
    ``cases.hypergeometric_rows``, at trips bounds on both sides of the
    block, against the plain version."""
    from repro_torch.kernels.variates import cases

    C, bcount, W = _hg_cases(64, 200, block)
    _, k2, a2, b2 = (x[256:] for x in cases.hypergeometric_rows(512, "cpu", seed=3))
    k = torch.cat([torch.from_numpy(C), k2])
    a = torch.cat([torch.from_numpy(bcount), a2])
    b = torch.cat([torch.from_numpy(W), b2])
    u = torch.rand(k.shape, generator=torch.Generator().manual_seed(block))
    for trips in (65, block, block + 1, 3 * block + 2):
        np.testing.assert_array_equal(
            va_ref.hypergeometric_blocked_ref(u, k, a, b, trips, block).numpy(),
            va_ref.hypergeometric_ref(u, k, a, b, trips).numpy())


def test_h3_block_is_the_kernels():
    """``kernel.H3_BLOCK``, which the block-edge rows and the mid-block cap
    aim at, is the block size the CUDA source compiles (its kBlock)."""
    import pathlib
    import re

    from repro_torch.kernels.variates import cases, kernel

    src = pathlib.Path(kernel.__file__).parents[1] / "csrc" / "variates.cu"
    found = re.findall(r"constexpr int kBlock = (\d+);", src.read_text())
    assert found == [str(kernel.H3_BLOCK)]
    assert kernel.H3_BLOCK < cases.H3_CAP_MID_BLOCK < 2 * kernel.H3_BLOCK


# --------------------------------------------------------------------------
# the wrappers as pure functions
# --------------------------------------------------------------------------
def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    n0, h0 = va_ops.binomial.launches, va_ops.hypergeometric.launches
    keys = rng.binomial_keys(prng.key(1), (3, 2), "cpu")
    count, p = torch.full((3, 2), 25), torch.full((3, 2), 0.45)
    got = va_ops.binomial(keys, count, p)
    assert got.shape == (3, 2) and got.dtype == torch.int64
    assert torch.equal(got, va_ref.binomial_ref(keys, count, p))
    u = torch.rand(4, generator=torch.Generator().manual_seed(0))
    k, a, b = torch.tensor([3, 5, 0, 9]), torch.tensor([4, 4, 4, 4]), torch.tensor([6, 6, 6, 6])
    got = va_ops.hypergeometric(u, k, a, b, 11)
    assert torch.equal(got, va_ref.hypergeometric_ref(u, k, a, b, 11))
    assert (va_ops.binomial.launches, va_ops.hypergeometric.launches) == (n0, h0)


def test_wrappers_refuse():
    keys = torch.zeros(3, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        va_ops.binomial(torch.zeros(3, 3, dtype=torch.int64), torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="rows"):
        va_ops.binomial(keys, torch.zeros(2), torch.zeros(3))
    with pytest.raises(ValueError, match="must agree"):
        va_ops.hypergeometric(torch.zeros(3), torch.zeros(3), torch.zeros(2), torch.zeros(3), 4)
    # a tensor on no CPU takes the kernel's route, which refuses what is not CUDA
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        va_ops.binomial(torch.zeros(3, 2, dtype=torch.int64, **meta),
                        torch.zeros(3, dtype=torch.int64, **meta), torch.zeros(3, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        va_ops.hypergeometric(*(torch.zeros(3, **meta) for _ in range(4)), 4)


def test_hypergeometric_guard_mass_is_the_references():
    """The reference's fault, held (ROADMAP C.8): where its f32 cdf never
    reaches u, JAX returns hi. ``ref.hypergeometric_implied`` gives that
    mass exactly (3.7e-4 at HyperGeo(100, 300, 700), where P(X = 100) is
    below 1e-50), and JAX's own draws take hi that often; at JAX's pmf-test
    triple the f32 distribution is the analytic one to 4e-6 (its cdf
    passes 1 by 3.6e-6 before the last value, which loses that much)."""
    vals, probs = va_ref.hypergeometric_implied(100, 300, 700, 257)
    guard = float(probs[-1])
    assert abs(probs.sum() - 1) < 1e-12 and vals[-1] == 100 and guard > 1e-4
    N = 1 << 16
    keys = jax.random.split(jax.random.key(21), N)
    x = np.asarray(jax.jit(jax.vmap(
        lambda kk: jrng.hypergeometric(kk, 100, 300, 700, max_support=256)))(keys))
    hits = int((x == 100).sum())
    assert abs(hits - guard * N) <= 5 * math.sqrt(guard * N), (hits, guard * N)
    vals, probs = va_ref.hypergeometric_implied(7, 10, 15, 33)
    exact = np.array([math.comb(10, v) * math.comb(15, 7 - v) / math.comb(25, 7)
                      for v in range(8)])
    np.testing.assert_allclose(probs[:8], exact, rtol=0, atol=4e-6)
    assert probs[-1] == 0.0
