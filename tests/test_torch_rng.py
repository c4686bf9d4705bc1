"""The port's PRNG and random-variate evaluations against ``jax.random`` and
``repro.core.rng``: fed the bits JAX drew, the port computes JAX's results
exactly; the port's own keys are deterministic and device-independent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import son_bits, t, uniform
from repro.core import rng as jrng
from repro_torch.core import prng, rng


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (3, 5)), (2, (1000,)),
                                        (3, ())])
def test_uniform_from_bits_equals_jax(seed, shape):
    key = jax.random.key(seed)
    b = t(jax.random.bits(key, shape, jnp.uint32))
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    got = prng.uniform_from_bits(b).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 50, 1000])
def test_swap_or_not_equals_jax(n):
    for s in range(3):
        key = jax.random.key(10 * n + s)
        x = jnp.arange(n, dtype=jnp.int32)
        want = np.asarray(jrng.swap_or_not(key, x, jnp.int32(n)))
        got = rng.swap_or_not(son_bits(key), torch.arange(n), torch.tensor(n))
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("cap,n,k", [(12, 7, None), (64, 50, 16), (32, 0, None),
                                     (9, 9, 4), (40, 1, 40)])
def test_prefix_permutation_fast_equals_jax(cap, n, k):
    key = jax.random.key(cap + n)
    want = np.asarray(jrng.prefix_permutation_fast(key, cap, jnp.int32(n), k=k))
    got = rng.prefix_permutation_fast(son_bits(key), cap, torch.tensor(n), k=k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_round_equals_jax():
    x = np.array([0.0, 0.3, 1.5, 2.999, 7.25, 1e3 + 0.5, 4.0], np.float32)
    for s in range(20):
        key = jax.random.key(s)
        want = np.asarray(jrng.stochastic_round(key, jnp.asarray(x)))
        got = rng.stochastic_round(uniform(key, x.shape), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


def test_philox_known_answers():
    """Random123's Philox-4x32-10 test vectors, on the host and in torch."""
    M = 0xFFFFFFFF
    vectors = [((0, 0, 0, 0), (0, 0),
                (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
               ((M, M, M, M), (M, M),
                (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
               ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                (0xA4093822, 0x299F31D0),
                (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, k, want in vectors:
        key = prng.Key(*k)
        assert prng.philox_host(ctr, key) == want
        dev = prng.philox(torch.tensor([ctr[0]]), key, ctr[1], ctr[2], ctr[3])
        assert tuple(dev[0].tolist()) == want


def test_port_keys_deterministic():
    k = prng.key(42)
    a = prng.bits(k, (5, 7), "cpu")
    assert torch.equal(a, prng.bits(prng.key(42), (5, 7), "cpu"))
    assert a.min() >= 0 and a.max() < 2**32
    # a longer draw extends a shorter one: counters, not a stream
    assert torch.equal(prng.bits(k, (9,), "cpu"), prng.bits(k, (20,), "cpu")[:9])
    assert prng.split(k, 3) == prng.split(prng.key(42), 3)
    assert prng.fold_in(k, 5) == prng.fold_in(prng.key(42), 5)
    kids = set(prng.split(k, 4)) | {prng.fold_in(k, i) for i in range(4)} | {k}
    assert len(kids) == 9
    assert not torch.equal(prng.bits(prng.split(k)[0], (8,), "cpu"),
                           prng.bits(prng.split(k)[1], (8,), "cpu"))
    # per-counter evaluation equals the host block (what the card evaluates)
    ctr = torch.arange(3)
    blocks = prng.philox(ctr, k)
    for i in range(3):
        assert tuple(blocks[i].tolist()) == prng.philox_host((i, 0, 0, 0), k)


def test_port_uniform_statistics():
    u = prng.uniform(prng.key(1), (200_000,), "cpu")
    assert u.dtype == torch.float32 and u.min() >= 0 and u.max() < 1
    assert abs(float(u.mean()) - 0.5) < 0.005
    p = torch.full((200_000,), 0.3)
    assert abs(float(prng.bernoulli(prng.key(2), p).float().mean()) - 0.3) < 0.005
