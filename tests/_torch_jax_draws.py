"""Replays of the JAX package's key tree, for the port's tests.

The port's functions take their random bits and uniforms as operands. These
helpers draw exactly the bits and uniforms the JAX functions draw from a
given ``jax.random`` key, so a test can feed them to the port and compare
the results bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import latent as tl
from repro_torch.core import rtbs as trt


def t(x, dtype=None):
    """numpy/JAX array -> CPU torch tensor (uint32 widened to int64)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a, copy=True))


def son_bits(key, rounds=16):
    return t(jax.random.bits(key, (rounds, 2), jnp.uint32))


def uniform(key, shape=()):
    return t(jax.random.uniform(key, shape, jnp.float32))


def ds_draws(key, cap, max_deleted=None):
    """``latent.downsample_map``'s draws: kperm, ku = split(key)."""
    kperm, ku = jax.random.split(key)
    small = None
    if max_deleted is not None and max_deleted > 0:
        D = min(int(max_deleted), cap)
        small = t(jax.random.bits(kperm, (D + 2,), jnp.uint32))
    return tl.DownsampleDraws(u=uniform(ku), rb_full=son_bits(kperm),
                              rb_small=small)


def tick_draws(key, cap, bcap):
    """``rtbs.tick_map``'s draws: k_ds, k_over, k_m, k_vic, k_pick."""
    k_ds, k_over, k_m, k_vic, k_pick = jax.random.split(key, 5)
    return trt.TickDraws(ds=ds_draws(k_ds, cap, bcap),
                         over=ds_draws(k_over, cap + bcap, bcap),
                         u_m=uniform(k_m), rb_vic=son_bits(k_vic),
                         rb_pick=son_bits(k_pick))


def id_stream(batch_sizes, bcap):
    """Integer items 1000 * (t + 1) + j, as tests/test_tbs_step.py makes them."""
    T = len(batch_sizes)
    batches = np.zeros((T, bcap), np.int32)
    for i, b in enumerate(batch_sizes):
        batches[i, :b] = 1000 * (i + 1) + np.arange(b)
    return batches, np.asarray(batch_sizes, np.int32)


def bank_tick_draws(tkeys, cap, bcap):
    """The bank's per-key ``tick_map`` draws, stacked over the routed rows:
    row t is :func:`tick_draws` of ``tkeys[t]`` (the tick key with touched
    key t folded in), drawn in one ``jax.vmap``."""
    def ds(key, c):
        kperm, ku = jax.random.split(key)
        return (jax.random.uniform(ku, (), jnp.float32),
                jax.random.bits(kperm, (16, 2), jnp.uint32),
                jax.random.bits(kperm, (min(bcap, c) + 2,), jnp.uint32))

    def one(key):
        k_ds, k_over, k_m, k_vic, k_pick = jax.random.split(key, 5)
        return (ds(k_ds, cap), ds(k_over, cap + bcap),
                jax.random.uniform(k_m, (), jnp.float32),
                jax.random.bits(k_vic, (16, 2), jnp.uint32),
                jax.random.bits(k_pick, (16, 2), jnp.uint32))

    a, o, u_m, vic, pick = jax.vmap(one)(tkeys)
    return trt.TickDraws(ds=tl.DownsampleDraws(*map(t, a)),
                         over=tl.DownsampleDraws(*map(t, o)), u_m=t(u_m),
                         rb_vic=t(vic), rb_pick=t(pick))


def exact_ds_draws(key, cap):
    """``latent.downsample_map(..., exact=True)``'s draws: kperm, ku = split(key)."""
    kperm, ku = jax.random.split(key)
    return tl.ExactDownsampleDraws(u=uniform(ku), u_perm=uniform(kperm, (cap,)))


def ref_draws(key, cap, bcap):
    """``rtbs.step_ref``'s draws: k_ds, k_over = split(key) for the
    unsaturated path, k_m, k_vic, k_pick, k_ds = split(key, 4) for the
    saturated one."""
    k_ds, k_over = jax.random.split(key)
    k_m, k_vic, k_pick, k_sds = jax.random.split(key, 4)
    return trt.RefDraws(ds=exact_ds_draws(k_ds, cap), over=exact_ds_draws(k_over, cap + bcap),
                        u_m=uniform(k_m), u_vic=uniform(k_vic, (cap,)),
                        u_pick=uniform(k_pick, (bcap,)), sat_ds=exact_ds_draws(k_sds, cap))


def _dist_ds_arrays(key, S):
    k_u, k_split, k_donor, k_local = jax.random.split(key, 4)
    u = lambda k: jax.random.uniform(k, (), jnp.float32)  # noqa: E731
    return (u(k_u), jax.vmap(u)(jax.random.split(k_split, S)), u(k_donor),
            jax.vmap(lambda s: jax.random.bits(jax.random.fold_in(k_local, s), (16, 2),
                                               jnp.uint32))(jnp.arange(S)))


@functools.lru_cache(maxsize=None)
def _drtbs_arrays(S):
    def draws(key):
        k_ds, k_over, k_m, k_sv, k_si, k_loc = jax.random.split(key, 6)
        u = lambda k: jax.random.uniform(k, (), jnp.float32)  # noqa: E731
        loc = jax.vmap(lambda s: jax.random.split(jax.random.fold_in(k_loc, s)))(jnp.arange(S))
        bits = jax.vmap(lambda k: jax.random.bits(k, (16, 2), jnp.uint32))
        return (_dist_ds_arrays(k_ds, S), _dist_ds_arrays(k_over, S), u(k_m),
                jax.vmap(u)(jax.random.split(k_sv, S)), jax.vmap(u)(jax.random.split(k_si, S)),
                bits(loc[:, 0]), bits(loc[:, 1]))

    return jax.jit(draws)


def drtbs_draws(key, S):
    """``distributed.drtbs_shard_step``'s draws: k_ds, k_over, k_m,
    k_split_v, k_split_i, k_loc = split(key, 6); each downsample splits its
    key k_u, k_split, k_donor, k_local; shard s's round words come from
    fold_in(k_local, s), its victim and pick words from split(fold_in(k_loc,
    s)); a split's uniforms from split(k_split, S)."""
    from repro_torch.core import distributed as tdist

    ds, over, u_m, sv, si, vic, pick = _drtbs_arrays(S)(key)
    return tdist.DRTBSDraws(
        ds=tdist.DownsampleDraws(*map(t, ds)), over=tdist.DownsampleDraws(*map(t, over)),
        u_m=t(u_m), u_split_v=t(sv), u_split_i=t(si), rb_vic=t(vic), rb_pick=t(pick))
