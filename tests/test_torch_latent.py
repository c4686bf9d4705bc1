"""The port's latent samples against ``repro.core.latent``: the Alg. 3 maps
(both constructions, all three cases) fed JAX's draws are bit-equal to
JAX's maps; realization and insertion match; B2's plain version is
bit-equal to the JAX ``reservoir_compact`` routes; Theorem 4.1 holds through
the leading trial dimension."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import ds_draws, uniform
from repro.core import latent as jl
from repro.kernels.reservoir_compact import ops as jrc
from repro_torch.core import latent as tl
from repro_torch.core import prng
from repro_torch.kernels.reservoir_compact import ref as rc_ref

F32 = np.float32

# jitted once per static shape and shared by every seed and case below
_jmap = jax.jit(jl.downsample_map, static_argnums=(1,),
                static_argnames=("max_deleted",))
_jsmall = jax.jit(jl._downsample_map_small, static_argnums=(1, 8))
_jfull = jax.jit(jl._downsample_map_full, static_argnums=(1, 8))

# (cap, C, C') per Alg. 3 case, plus the C' == C identity shortcut
CASES = [
    (10, 5.6, 0.7),      # kp == 0
    (10, 5.6, 5.2),      # 0 < kp == k
    (10, 5.6, 3.2),      # 0 < kp < k
    (10, 5.0, 2.5),      # 0 < kp < k, no old partial
    (64, 40.3, 30.7),    # 0 < kp < k, 10 deleted
    (64, 40.3, 40.3),    # identity
    (9, 8.0, 8.0),       # identity at saturation
]


@pytest.mark.parametrize("cap,c,cp", CASES)
@pytest.mark.parametrize("max_deleted", [None, 4, 16])
def test_downsample_map_equals_jax(cap, c, cp, max_deleted):
    """``max_deleted`` None is the full construction; 4 and 16 select the
    delete-complement construction where few enough fulls leave, else the
    full one, as JAX's lax.cond does."""
    for s in range(3):
        key = jax.random.key(1000 * cap + s)
        want = np.asarray(_jmap(key, cap, jnp.int32(math.floor(c)), F32(c), F32(cp),
                                max_deleted=max_deleted))
        got = tl.downsample_map(ds_draws(key, cap, max_deleted), cap,
                                torch.tensor(F32(c)), torch.tensor(F32(cp)),
                                max_deleted=max_deleted)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {s}")


@pytest.mark.parametrize("cap,c,cp", CASES)
def test_both_constructions_equal_jax(cap, c, cp):
    """Each construction on its own, including inputs where JAX would not
    select it (the port computes both and selects with torch.where)."""
    D = 4
    cw, nw = F32(c), F32(min(cp, c))
    k, f = math.floor(cw), F32(cw - math.floor(cw))
    kp, fp = math.floor(nw), F32(nw - math.floor(nw))
    for s in range(2):
        key = jax.random.key(7 + s)
        dr = ds_draws(key, cap, D)
        args_j = (jnp.int32(k), f, jnp.int32(kp), fp, nw, cw)
        args_t = (torch.tensor(k), torch.tensor(f), torch.tensor(kp),
                  torch.tensor(fp), torch.tensor(nw), torch.tensor(cw))
        small_j = _jsmall(key, cap, *args_j, D)
        small_t = tl._downsample_map_small(dr.u, dr.rb_small, cap, *args_t, D,
                                           torch.tensor(True))
        np.testing.assert_array_equal(small_t.numpy(), np.asarray(small_j))
        full_j = _jfull(key, cap, *args_j, False)
        full_t = tl._downsample_map_full(dr.u, dr.rb_full, cap, *args_t)
        np.testing.assert_array_equal(full_t.numpy(), np.asarray(full_j))


def _lat(cap, c, leaf_dtype=np.int32):
    items = (np.arange(cap) * 3 + 1).astype(leaf_dtype)
    j = jl.Latent(items=jnp.asarray(items), nfull=jnp.int32(math.floor(c)),
                  weight=jnp.float32(c))
    p = tl.Latent(items=torch.from_numpy(items), nfull=torch.tensor(math.floor(c)),
                  weight=torch.tensor(F32(c)))
    return j, p


@pytest.mark.parametrize("c", [5.7, 5.0, 0.4, 0.0])
def test_partial_draw_realize_and_compact_equal_jax(c):
    cap = 9
    j, p = _lat(cap, c)
    for s in range(10):
        key = jax.random.key(s)
        u = uniform(key)
        kj, takej, fj = jl.partial_draw(key, j.weight)
        kt, taket, ft = tl.partial_draw(u, p.weight)
        assert (int(kj), bool(takej), float(fj)) == (int(kt), bool(taket), float(ft))
        mj, sj = jl.realize(key, j)
        mt, st = tl.realize(u, p)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert int(sj) == int(st)
        pj, szj = jl.realize_compact(key, j)
        pt, szt = tl.realize_compact(u, p)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        assert int(szj) == int(szt)


@pytest.mark.parametrize("c,bcount", [(5.7, 3), (5.0, 2), (0.0, 4), (3.25, 0)])
def test_insert_full_equals_jax(c, bcount):
    cap, bcap = 12, 4
    j, p = _lat(cap, c)
    j = jl.Latent(items={"a": j.items, "b": j.items.astype(jnp.float32)[:, None]
                         * jnp.ones((1, 2))}, nfull=j.nfull, weight=j.weight)
    p = tl.Latent(items={"a": p.items, "b": p.items.float()[:, None] * torch.ones(1, 2)},
                  nfull=p.nfull, weight=p.weight)
    bj = {"a": -jnp.arange(1, bcap + 1, dtype=jnp.int32),
          "b": -jnp.ones((bcap, 2), jnp.float32)}
    bt = {"a": -torch.arange(1, bcap + 1, dtype=torch.int32),
          "b": -torch.ones(bcap, 2)}
    oj = jl.insert_full(j, bj, jnp.int32(bcount))
    ot = tl.insert_full(p, bt, torch.tensor(bcount))
    for f in ("a", "b"):
        np.testing.assert_array_equal(ot.items[f].numpy(), np.asarray(oj.items[f]))
    assert int(ot.nfull) == int(oj.nfull)
    assert float(ot.weight) == float(oj.weight)
    # the widened-buffer helpers of the reference step
    wide_j = jl.truncate_items(jl.concat_items(oj.items, bj), cap + 2)
    wide_t = tl.truncate_items(tl.concat_items(ot.items, bt), cap + 2)
    for f in ("a", "b"):
        np.testing.assert_array_equal(wide_t[f].numpy(), np.asarray(wide_j[f]))


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8", "bool", "bf16"])
@pytest.mark.parametrize("cap,D", [(128, 4), (200, 3), (33, 1), (256, 1)])
def test_compact_plain_equals_jax(dtype, cap, D):
    """B2's plain version against the JAX kernel body (interpret) and the
    JAX oracle (ref), caps that are and are not multiples of 128."""
    rs = np.random.RandomState(cap * 7 + D)
    mask = rs.rand(cap) < 0.45
    if dtype in ("f32", "bf16"):
        x = jnp.asarray(rs.randn(cap, D).astype(np.float32))
        x = x.astype(jnp.bfloat16) if dtype == "bf16" else x
    elif dtype == "bool":
        x = jnp.asarray(rs.rand(cap, D) < 0.5)
    else:
        x = jnp.asarray(rs.randint(-100, 100, (cap, D)).astype(
            np.int8 if dtype == "i8" else np.int32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32) if dtype == "bf16" else x))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    got, cnt = rc_ref.compact_ref(xt, torch.from_numpy(mask))
    for impl in ("interpret", "ref"):
        want, wcnt = jrc.reservoir_compact(x, jnp.asarray(mask), impl=impl)
        assert int(cnt) == int(wcnt) == int(mask.sum())
        np.testing.assert_array_equal(got.float().numpy() if dtype == "bf16"
                                      else got.numpy(),
                                      np.asarray(want.astype(jnp.float32)
                                                 if dtype == "bf16" else want))


def _theorem_4_1(max_deleted, seed):
    c, cp, cap, trials = 5.6, 3.2, 10, 20000
    k = math.floor(c)
    ids = torch.arange(cap).expand(trials, cap)
    base = tl.Latent(items=ids, nfull=torch.full((trials,), k),
                     weight=torch.full((trials,), F32(c)))
    k1, k2 = prng.split(prng.key(seed))
    dr = tl.draw_downsample(k1, cap, "cpu", max_deleted=max_deleted,
                            batch=(trials,))
    out = tl.downsample(dr, base, torch.full((trials,), F32(cp)),
                        max_deleted=max_deleted)
    mask, _ = tl.realize(prng.uniform(k2, (trials,), "cpu"), out)
    member = torch.zeros(trials, cap).scatter_add_(1, out.items, mask.float())
    member = member.mean(dim=0).numpy()
    scale = cp / c
    for i in range(k):
        assert abs(member[i] - scale) < 0.02, (i, member[i], scale)
    assert abs(member[k] - scale * (c - k)) < 0.02


def test_downsample_theorem_4_1():
    """Theorem 4.1 at the reference's trials and tolerance
    (tests/test_tbs_step.py), the full construction, trials as a leading
    dimension."""
    _theorem_4_1(None, 1)


def test_downsample_theorem_4_1_delete_complement():
    """The same through the delete-complement construction (H1's loop)."""
    _theorem_4_1(4, 2)


def test_materialize_view_packs_scattered_mask():
    from repro_torch.core.api import SampleView, materialize_view

    cap = 21
    items = {"x": torch.arange(cap * 2, dtype=torch.float32).reshape(cap, 2),
             "y": torch.arange(cap, dtype=torch.int32)}
    mask = torch.from_numpy(np.arange(cap) % 3 == 1)
    size = mask.sum()
    dense = materialize_view(SampleView(items=items, mask=mask, size=size))
    assert int(dense.mask.sum()) == int(size) and bool(dense.mask[: int(size)].all())
    np.testing.assert_array_equal(dense.items["y"][: int(size)].numpy(),
                                  np.arange(cap)[mask.numpy()])
    assert not dense.items["x"][int(size):].any()
