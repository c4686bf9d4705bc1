"""H1's plain versions on the CPU: the last-writer forest the card builds
(``ref.swap_delete_forest_ref``) against the loop (``ref.swap_delete_ref``,
the CPU route) bit for bit; the loop against JAX's own ``fori_loop``
(``repro.core.latent._downsample_map_small``'s deletion body) and the
port's ``downsample_map`` against JAX's delete-complement map at a
~3,900-deletion trim; and the wrapper's route as a pure function. Inputs
are made with numpy from a seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import ds_draws
from repro.core import latent as jl
from repro_torch.core import latent as tl
from repro_torch.kernels.swap_delete import ops, ref

F32 = np.float32


def _bits(rs, T, D, collide=False):
    hi = 3 if collide else 2**32
    return torch.from_numpy(rs.integers(0, hi, (T, D + 2), dtype=np.int64))


def _both(L, trips, k, bits, D):
    trips, k = torch.as_tensor(trips), torch.as_tensor(k)
    want = ref.swap_delete_ref(L, trips, k, bits, D)
    got = ref.swap_delete_forest_ref(L, trips, k, bits, D)
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("collide", [False, True])
def test_forest_equals_loop_on_random_rows(seed, collide):
    """Uniform words, and words from {0, 1, 2} so that writes collide and
    chains form; k up to L, trips up to D."""
    rs = np.random.default_rng(seed + 100 * collide)
    for _ in range(20):
        T, L, D = int(rs.integers(1, 5)), int(rs.integers(1, 200)), int(rs.integers(1, 80))
        k = rs.integers(0, L + 1, T)
        trips = rs.integers(0, D + 1, T)
        _both(L, trips, k, _bits(rs, T, D, collide), D)


@pytest.mark.parametrize("L,D,k", [(10, 8, 10), (64, 62, 64), (300, 250, 260),
                                   (4096, 4000, 4096)])
def test_forest_equals_loop_on_deep_chains(L, D, k):
    """bits[j] = k - 2 - j: step j writes slot m - 2, the next step's f,
    so every step moves the value the step before placed: one chain of D."""
    bits = torch.clamp(k - 2 - torch.arange(D + 2), min=0)[None]
    want = _both(L, [D], [k], bits, D)
    # the chain carries slot k - 1's entry down to slot k - 1 - D
    assert int(want[0, k - 1 - D]) == k - 1


@pytest.mark.parametrize("trips,k", [(0, 50), (50, 50), (40, 64), (0, 0), (30, 0)],
                         ids=["trips0", "trips=k", "k=L", "k0", "k0-trips30"])
def test_forest_equals_loop_at_the_edges(trips, k):
    L, D = 64, 64
    rs = np.random.default_rng(trips + k)
    want = _both(L, [trips], [k], _bits(rs, 1, D), D)
    if trips == 0 or k == 0:
        assert torch.equal(want[0], torch.arange(L))


def test_forest_equals_loop_with_a_row_past_L():
    """A row with k > L (its reads clamp to L - 1, its writes past L drop)
    beside rows the forest takes, and a row with more trips than D words."""
    L, D = 40, 16
    rs = np.random.default_rng(7)
    _both(L, [16, 16, 10, 25], [70, 40, 12, 30], _bits(rs, 4, D), D)
    _both(L, [16, 16], [41, 300], _bits(rs, 2, D, collide=True), D)


def test_forest_equals_loop_on_three_mixed_rows():
    """T = 3: a gated row (0 trips), a full trim (trips = k = L) and a short one."""
    L, D = 500, 500
    rs = np.random.default_rng(3)
    want = _both(L, [0, 500, 37], [480, 500, 300], _bits(rs, 3, D), D)
    assert torch.equal(want[0], torch.arange(L))


def test_forest_equals_loop_at_L_2_16():
    L, D = 1 << 16, 4096
    rs = np.random.default_rng(16)
    _both(L, [4096], [L - 1], _bits(rs, 1, D), D)


def _jax_loop(L, trips, k, bits, D):
    """``_downsample_map_small``'s deletion loop as JAX writes it (int32
    slots, uint32 words, dropped out-of-range writes, clipped reads)."""
    rb = jnp.asarray(bits, jnp.uint32)

    def delete(i, src):
        m = k - i
        v = (rb[jnp.minimum(i, D - 1)] % jnp.maximum(m, 1).astype(jnp.uint32)
             ).astype(jnp.int32)
        return src.at[v].set(src[jnp.clip(m - 1, 0, L - 1)])

    return np.asarray(jax.lax.fori_loop(0, trips, delete,
                                        jnp.arange(L, dtype=jnp.int32)))


@pytest.mark.parametrize("L,D,trips,k", [(64, 16, 16, 60), (64, 64, 64, 64),
                                         (64, 8, 12, 64), (32, 8, 8, 50),
                                         (1000, 300, 290, 999)])
def test_loop_equals_jax_fori_loop(L, D, trips, k):
    """The plain loop against JAX's, including trips > D (the last word
    reused) and k > L."""
    rs = np.random.default_rng(L + trips)
    bits = rs.integers(0, 2**32, (D + 2,), dtype=np.int64)
    want = _jax_loop(L, trips, k, bits, D)
    got = ref.swap_delete_ref(L, torch.tensor(trips), torch.tensor(k),
                              torch.from_numpy(bits), D)
    np.testing.assert_array_equal(got.numpy(), want)
    if k <= L and trips <= D:
        got_f = ref.swap_delete_forest_ref(L, torch.tensor(trips), torch.tensor(k),
                                           torch.from_numpy(bits), D)
        np.testing.assert_array_equal(got_f.numpy(), want)


_jsmall = jax.jit(jl._downsample_map_small, static_argnums=(1, 8))


@pytest.mark.parametrize("seed", range(2))
def test_downsample_map_small_equals_jax_at_3900_deletions(seed):
    """JAX's delete-complement map at cap 4,096 trimming C = 4,000.3 to
    C' = 100.7 (3,899 or 3,900 deletions), max_deleted 4,096, against the
    port's ``downsample_map`` fed JAX's draws."""
    cap, D, c, cp = 4096, 4096, 4000.3, 100.7
    cw, nw = F32(c), F32(cp)
    k, f = math.floor(cw), F32(cw - math.floor(cw))
    kp, fp = math.floor(nw), F32(nw - math.floor(nw))
    key = jax.random.key(4096 + seed)
    want = np.asarray(_jsmall(key, cap, jnp.int32(k), f, jnp.int32(kp), fp, nw, cw, D))
    got = tl.downsample_map(ds_draws(key, cap, D), cap, torch.tensor(cw),
                            torch.tensor(nw), max_deleted=D)
    np.testing.assert_array_equal(got.numpy(), want)
    # the survivors' slots are a permutation of distinct old slots
    assert len(set(want[: kp + 1].tolist())) == kp + 1


@pytest.mark.parametrize("L,D,want", [(65, 32, "rows"), (97, 32, "rows"),
                                      (256, 64, "rows"), (256, 65, "forest"),
                                      (257, 32, "forest"), (4096, 256, "forest"),
                                      (1 << 20, 65_536, "forest")])
def test_route_is_chosen_from_L_and_D(L, D, want):
    assert ops.route(L, D) == want


def test_wrapper_on_cpu_is_the_loop():
    rs = np.random.default_rng(11)
    L, D = 200, 50
    bits = _bits(rs, 3, D)
    trips, k = torch.tensor([50, 0, 20]), torch.tensor([200, 100, 30])
    n0 = ops.swap_delete.launches
    got = ops.swap_delete(L, trips, k, bits, D)
    assert torch.equal(got, ref.swap_delete_ref(L, trips, k, bits, D))
    assert ops.swap_delete.launches == n0
