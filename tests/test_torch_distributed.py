"""The port's distributed schemes (``repro_torch.core.distributed``, paper
Sec. 5) against the JAX package's ``repro.core.distributed``.

JAX's per-shard functions run in-process under ``jax.vmap(...,
axis_name="data")`` over the shards (its collectives are vmap-aware), the
port's with the shards as a leading dimension of one state:

  * the D-R-TBS step fed JAX's draws equals JAX's jitted step bit for bit
    at S = 1 and 4 on every tick (items, nfull, the partial item, C, W,
    overflow), over uneven and empty shards, covering every Alg. 2 path
    (unsaturated, over n, still saturated, undershoot) and every Alg. 3
    case (case0, case_eq, case_lt), overflow included;
  * the per-shard and global realizations, the global size and the
    packed global view (B2) against JAX's, both outcomes of the partial
    draw;
  * the D-T-TBS step fed JAX's draws (binomial results included) and its
    global view, the shard keys ``fold_in(key, s)``;
  * the registry's two samplers, the per-shard extract's reserved slot,
    ``convert`` both ways and checkpoints across the packages;
  * ``reshard_reservoir`` and ``StreamPipeline`` against JAX's.

"Exact" means bit for bit.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_jax_draws import drtbs_draws, son_bits
from repro.core import distributed as jdist
from repro.core import rng as jrng
from repro.core import simple as js
from repro.core.api import SampleView as JView
from repro.core.api import materialize_view as j_materialize_view
from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.core import prng
from repro_torch.core import simple as ts
from repro_torch.core.api import make_sampler

CPU = "cpu"
F32 = np.float32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: many small CPU ops, which slow down many
    times over when parallel test workers each spawn a full thread pool."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def _jproto():
    return {"id": jnp.zeros((), jnp.int32), "x": jnp.zeros((2,), jnp.float32)}


def _jinit(S, cap_s):
    return jax.vmap(lambda _: jdist.init_shard(_jproto(), cap_s))(jnp.arange(S))


def _to_port(jst) -> tdist.DRTBSShard:
    return convert.drtbs_state_from_numpy(
        pytree.tree_map(np.asarray, jst.items), jst.nfull,
        pytree.tree_map(np.asarray, jst.partial_item), jst.weight, jst.total_weight,
        jst.overflow, device=CPU)


def _assert_drtbs_equal(tst, jst, msg=""):
    for f in ("nfull", "weight", "total_weight", "overflow"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                      err_msg=f"{msg} {f}")
    for f in ("items", "partial_item"):
        for k in ("id", "x"):
            a, b = getattr(tst, f)[k].numpy(), np.asarray(getattr(jst, f)[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{msg} {f}.{k}"


def _batches(counts, bcap_s, seed):
    """Integer ids 1000 (t + 1) + j and f32 x rows for every shard slot."""
    T, S = counts.shape
    rs = np.random.RandomState(seed)
    ids = (1000 * (np.arange(T)[:, None, None] + 1)
           + np.arange(S * bcap_s).reshape(S, bcap_s)).astype(np.int32)
    return ids, rs.randn(T, S, bcap_s, 2).astype(F32)


def _case(cw, nw):
    nw = min(nw, cw)
    if nw >= cw:
        return None
    k, kp = math.floor(cw), math.floor(nw)
    return "case0" if kp == 0 else ("case_eq" if kp == k else "case_lt")


def _paths(W, C, B, d, n):
    """The Alg. 2 path and Alg. 3 cases a tick takes (f32 arithmetic)."""
    W, C, B, d = F32(W), F32(C), F32(B), F32(d)
    w_dec = F32(d * W)
    out = set()
    if W < n:
        out.add("unsat")
        if 0 < w_dec < C:
            out.add(_case(C, w_dec))
            C1 = w_dec
        else:
            C1 = min(C, max(w_dec, F32(0)))
        if F32(C1 + B) > n:
            out |= {"over", _case(F32(C1 + B), F32(n))}
    else:
        w_new = F32(d * W + B)
        if w_new >= n:
            out.add("still_sat")
        else:
            out |= {"undershoot", _case(C, F32(w_new - B))}
    return out - {None}


# (n, lam, counts seed, empty tick rows, n scales with S, skewed to shard 0)
CONFIGS = [
    (20, 0.3, 0, (5, 12, 13, 14), True, False),   # saturates, undershoots, over n
    (40, 0.02, 1, (), True, False),               # slow decay: case_eq unsaturated
    (12, 1.6, 2, (3, 4, 5, 6, 9, 10), True, False),  # fast decay, empty runs: case0
    (40, 0.05, 3, (), False, True),               # one shard takes it all: overflow
]
CAP_S, BCAP_S = 16, 6


@functools.lru_cache(maxsize=None)
def _jstep():
    """JAX's step vmapped over the shards, n and the decay factor traced
    (one compile for every configuration)."""
    return jax.jit(jax.vmap(
        lambda k, st, b, c, n, d: jdist.drtbs_shard_step(k, st, b, c, n=n, decay=d),
        in_axes=(None, 0, 0, 0, None, None), axis_name="data"))


@pytest.mark.parametrize("S", [1, 4])
def test_drtbs_step_equals_jax_bit_for_bit(S):
    """Every tick of four streams, the port fed JAX's draws: the whole
    state equal bit for bit, every path and case taken, overflow counted."""
    seen, overflowed = set(), False
    for n, lam, seed, empty, scale, skew in CONFIGS:
        T = 26
        n = max(3, n * S // 4) if scale else n
        rs = np.random.RandomState(seed)
        counts = rs.randint(0, BCAP_S + 1, size=(T, S)).astype(np.int32)
        counts[list(empty)] = 0
        if skew:
            counts[:, 1:] = 0
        elif S > 1:
            counts[7, :S // 2] = 0                                     # empty shards
        ids, xs = _batches(counts, BCAP_S, seed)
        jst = _jinit(S, CAP_S)
        tst = _to_port(jst)
        d = torch.tensor(math.exp(-lam), dtype=torch.float32)
        for t in range(T):
            seen |= _paths(float(jst.total_weight[0]), float(jst.weight[0]),
                           int(counts[t].sum()), float(d), n)
            key = jax.random.fold_in(jax.random.key(100 + seed), t)
            jst = _jstep()(key, jst, {"id": jnp.asarray(ids[t]), "x": jnp.asarray(xs[t])},
                           jnp.asarray(counts[t]), jnp.int32(n), jnp.float32(d))
            tst = tdist.drtbs_step_with(drtbs_draws(key, S), tst,
                                        {"id": _t(ids[t]), "x": _t(xs[t])},
                                        _t(counts[t]).long(), n=n, decay=d)
            _assert_drtbs_equal(tst, jst, f"S={S} cfg={seed} tick {t}")
        overflowed |= int(jst.overflow.sum()) > 0
    assert {"unsat", "over", "still_sat", "undershoot", "case0", "case_eq",
            "case_lt"} <= seen, seen
    assert overflowed


def _port_key_with_take(u_jax: float, frac: float):
    """A port key whose partial-item draw agrees with JAX's uniform."""
    want = u_jax < frac
    for seed in range(10_000):
        k = prng.key(seed)
        if bool(prng.uniform(k, (), CPU) < frac) == want and frac > 0:
            return k
    raise AssertionError("no key found")


def _run_jax(S, n, lam, T, seed):
    rs = np.random.RandomState(seed)
    counts = rs.randint(0, BCAP_S + 1, size=(T, S)).astype(np.int32)
    ids, xs = _batches(counts, BCAP_S, seed)
    jst = _jinit(S, CAP_S)
    for t in range(T):
        jst = _jstep()(jax.random.fold_in(jax.random.key(seed), t), jst,
                       {"id": jnp.asarray(ids[t]), "x": jnp.asarray(xs[t])},
                       jnp.asarray(counts[t]), jnp.int32(n), jnp.float32(math.exp(-lam)))
    return jst


@pytest.mark.parametrize("take", [False, True])
def test_drtbs_realizations_equal_jax(take):
    """Per-shard and global realizations, the global size and the packed
    global view (JAX's ``materialize_view`` of ``drtbs_realize_global``;
    the port's through B2 into a buffer with one row more), with the
    partial item taken and not."""
    S, cap_s = 4, CAP_S
    jst = _run_jax(S, 60, 0.25, 9, 7)                    # unsaturated: C fractional
    frac = float(jst.weight[0]) - math.floor(float(jst.weight[0]))
    assert frac > 0
    for seed in range(200):                  # a JAX key with the wanted outcome
        jkey = jax.random.key(seed)
        u = float(jax.random.uniform(jkey, (), jnp.float32))
        if (u < frac) == take:
            break
    tkey = _port_key_with_take(u, frac)
    tst = _to_port(jst)

    def jglobal(k, st):
        items, mask, size = jdist.drtbs_realize_global(k, st)
        view = j_materialize_view(JView(items=items, mask=mask, size=size))
        return items, mask, size, view.items, view.mask, jdist.drtbs_global_size(k, st), \
            jdist.drtbs_realize_shard(k, st)

    out = jax.vmap(jglobal, in_axes=(None, 0), axis_name="data")(jkey, jst)
    items, mask, size, vitems, vmask, gsize, (smask, ssize, stake) = \
        pytree.tree_map(lambda a: np.asarray(a)[0], out[:6]) + (
            tuple(np.asarray(a) for a in out[6]),)
    t_items, t_mask, t_size = tdist.drtbs_realize_global(tkey, tst)
    assert bool(t_mask[-1]) == take
    np.testing.assert_array_equal(t_mask.numpy(), mask)
    assert int(t_size) == int(size) == int(gsize) == int(tdist.drtbs_global_size(tkey, tst))
    for k in ("id", "x"):
        assert t_items[k].numpy().tobytes() == items[k].tobytes()
    p_items, p_mask, p_size = tdist.drtbs_extract_global(tkey, tst)
    np.testing.assert_array_equal(p_mask.numpy(), vmask)
    assert int(p_size) == int(size) == int(p_mask.sum())
    for k in ("id", "x"):
        assert p_items[k].shape[0] == S * cap_s + 1
        assert p_items[k].numpy().tobytes() == vitems[k].tobytes(), k
    r_mask, r_size, r_take = tdist.drtbs_realize_shard(tkey, tst)
    np.testing.assert_array_equal(r_mask.numpy(), smask)
    np.testing.assert_array_equal(r_size.numpy(), ssize)
    np.testing.assert_array_equal(r_take.numpy(), stake)
    # the sampler's per-shard extract reserves slot cap_s for the partial
    sampler = make_sampler("drtbs", n=60, lam=0.25, cap_s=cap_s, device=CPU)
    view = sampler.extract(tkey, tst)
    assert view.items["id"].shape == (S, cap_s + 1)
    np.testing.assert_array_equal(view.mask.sum(-1).numpy(), view.size.numpy())
    assert int(sampler.size(tkey, tst).sum()) == int(size)
    assert torch.equal(view.items["x"][0, cap_s], tst.partial_item["x"][0])
    g = sampler.extract_global(tkey, tst)
    assert torch.equal(g.items["x"], p_items["x"]) and int(g.size) == int(size)
    assert int(sampler.size_global(tkey, tst)) == int(size)


def test_shard_keys_fold_in_each_shard():
    """D-T-TBS's per-shard keys: row s is the host ``fold_in(key, s)``,
    also from a key tensor of trials."""
    key = prng.key(9)
    rows = tdist.shard_keys(key, 5, CPU)
    for s in range(5):
        k = prng.fold_in(key, s)
        assert rows[s].tolist() == [k.k0, k.k1]
    trials = prng.key_rows(key, 3, CPU)
    rows = tdist.shard_keys(trials, 5, CPU)
    assert rows.shape == (3, 5, 2)
    for i in range(3):
        assert torch.equal(rows[i], tdist.shard_keys(
            prng.Key(int(trials[i, 0]), int(trials[i, 1])), 5, CPU))


@pytest.mark.parametrize("S", [1, 4])
def test_dttbs_step_and_global_view_equal_jax(S):
    """D-T-TBS over 20 ticks, each shard's T-TBS fed JAX's draws
    (``fold_in(key, s)``, binomials included): the buffers, counts, W and
    overflow bit for bit, and the global view (buffers end to end, packed
    through B2) against JAX's."""
    cap, bcap, lam, n = 12, 6, 0.3, 5
    p = F32(math.exp(-lam))
    q = F32(n * (1 - math.exp(-lam)) / 3.0)
    T = 20
    rs = np.random.RandomState(S)
    counts = rs.randint(0, bcap + 1, size=(T, S)).astype(np.int32)
    counts[4] = 0
    ids, _ = _batches(counts, bcap, S)
    step = jax.jit(jax.vmap(
        lambda k, st, b, c: jdist.dttbs_shard_step(k, st, b, c, p=jnp.float32(p),
                                                   q=jnp.float32(q)),
        in_axes=(None, 0, 0, 0), axis_name="data"))
    jst = jax.vmap(lambda _: js.init(jnp.zeros((), jnp.int32), cap))(jnp.arange(S))
    tst = convert.buffer_state_from_numpy(np.asarray(jst.items), jst.count, jst.total_weight,
                                          jst.overflow, device=CPU)
    for t in range(T):
        key = jax.random.fold_in(jax.random.key(5), t)
        per = []
        for s in range(S):
            k_ret, k_perm, k_acc, k_pick = jax.random.split(jax.random.fold_in(key, s), 4)
            per.append((int(jrng.binomial(k_ret, jst.count[s], jnp.float32(p))),
                        int(jrng.binomial(k_acc, jnp.int32(counts[t, s]), jnp.float32(q))),
                        son_bits(k_perm), son_bits(k_pick)))
        draws = ts.TTBSDraws(m=torch.tensor([x[0] for x in per]),
                             k=torch.tensor([x[1] for x in per]),
                             rb_perm=torch.stack([x[2] for x in per]),
                             rb_pick=torch.stack([x[3] for x in per]))
        jst = step(key, jst, jnp.asarray(ids[t]), jnp.asarray(counts[t]))
        tst = ts.ttbs_step_with(draws, tst, _t(ids[t]), _t(counts[t]).long(),
                                p=torch.tensor(p))
        np.testing.assert_array_equal(tst.items.numpy(), np.asarray(jst.items))
        for f in ("count", "total_weight", "overflow"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))

    def jglobal(st):
        items, mask, size = jdist.buffer_realize_global(st)
        view = j_materialize_view(JView(items=items, mask=mask, size=size))
        return items, mask, size, view.items, view.mask

    out = [np.asarray(a)[0] for a in jax.vmap(jglobal, axis_name="data")(jst)]
    items, mask, size = tdist.buffer_realize_global(tst)
    np.testing.assert_array_equal(items.numpy(), out[0])
    np.testing.assert_array_equal(mask.numpy(), out[1])
    assert int(size) == int(out[2])
    sampler = make_sampler("dttbs", n=n, lam=lam, batch_size=3.0, cap=cap, device=CPU)
    view = sampler.extract_global(prng.key(0), tst)
    np.testing.assert_array_equal(view.items.numpy(), out[3])
    np.testing.assert_array_equal(view.mask.numpy(), out[4])
    assert int(sampler.size_global(prng.key(0), tst)) == int(out[2])
    # the sampler's own step (H2's plain version on the CPU) keeps W exact
    st2 = sampler.step(prng.key(3), tst, _t(ids[0]), _t(counts[0]).long())
    w = F32(F32(p) * tst.total_weight.numpy().astype(np.float64) + counts[0])
    np.testing.assert_array_equal(st2.total_weight.numpy(), w)
    assert (st2.count <= cap).all()


def test_samplers_registered_with_jax_hyper():
    """``make_sampler("drtbs" | "dttbs")``: JAX's hyperparameters, the
    distributed flag and the global closures; D-T-TBS keeps the eager p/q
    calibration and its refusal; a decay schedule threads through."""
    from repro.core.api import make_sampler as j_make_sampler
    from repro_torch.decay import polynomial

    for scheme, hyper in (("drtbs", dict(n=24, lam=0.2, cap_s=64)),
                          ("dttbs", dict(n=12, lam=0.2, batch_size=12))):
        s, j = make_sampler(scheme, **hyper, device=CPU), j_make_sampler(scheme, **hyper)
        assert s.distributed and j.distributed
        assert s.extract_global is not None and s.size_global is not None
        assert {k: v for k, v in s.hyper.items() if k != "decay"} == \
            {k: v for k, v in j.hyper.items() if k != "decay"}
        assert s.step_decayed is not None
    with pytest.raises(ValueError, match="q ="):
        make_sampler("dttbs", n=100, lam=0.5, batch_size=8, device=CPU)
    s = make_sampler("drtbs", n=8, cap_s=12, decay=polynomial(0.8), device=CPU)
    from repro_torch.manage import init_sharded_state

    st = init_sharded_state(s, 3, {"id": torch.zeros((), dtype=torch.int32)})
    batch = {"id": torch.arange(12, dtype=torch.int32).reshape(3, 4)}
    for t in range(4):
        st = s.step(prng.key(t), st, batch, torch.tensor([4, 0, 2]))
    assert st.dstate.shape == (3,)
    np.testing.assert_array_equal(st.inner.total_weight.numpy(),
                                  np.full(3, st.inner.total_weight[0].item(), F32))
    assert int(s.size_global(prng.key(0), st)) == int(s.extract_global(prng.key(0), st).size)


def test_convert_and_checkpoints_round_trip_both_packages(tmp_path):
    """A gathered D-R-TBS snapshot and a D-T-TBS one, JAX -> port -> numpy
    equal; a checkpoint the JAX package writes restores in the port and
    one the port writes restores in JAX's, leaf for leaf."""
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.checkpoint import save_checkpoint as j_save
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    jst = _run_jax(4, 21, 0.25, 8, 3)
    tst = _to_port(jst)
    back = convert.drtbs_state_to_numpy(tst)
    for f in ("nfull", "weight", "total_weight", "overflow"):
        a, b = back[f], np.asarray(getattr(jst, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("items", "partial_item"):
        for k in ("id", "x"):
            assert back[f][k].tobytes() == np.asarray(getattr(jst, f)[k]).tobytes()
    j_save(tmp_path / "j", 5, (jst, 5))
    got, tick = restore_checkpoint(tmp_path / "j", 5, (_to_port(_jinit(4, 16)), 0))
    assert tick == 5
    _assert_drtbs_equal(got, jst, "JAX -> port")
    save_checkpoint(tmp_path / "t", 6, (tst, 6))
    jgot, tick = j_restore(tmp_path / "t", 6, (_jinit(4, 16), 0))
    assert tick == 6
    _assert_drtbs_equal(tst, jax.tree_util.tree_map(jnp.asarray, jgot), "port -> JAX")
    jb = jax.vmap(lambda _: js.init(jnp.zeros((2,), jnp.float32), 8))(jnp.arange(3))
    tb = convert.buffer_state_from_numpy(np.asarray(jb.items), jb.count, jb.total_weight,
                                         jb.overflow, device=CPU)
    nb = convert.buffer_state_to_numpy(tb)
    assert nb["items"].shape == (3, 8, 2) and nb["count"].dtype == np.int32


def test_reshard_reservoir_equals_jax():
    """Elastic re-partition: 4 uneven shards into 3 and into 6, equal to
    JAX's; too small a capacity raises."""
    from repro.checkpoint import reshard_reservoir as j_reshard
    from repro_torch.checkpoint import reshard_reservoir

    rs = np.random.RandomState(0)
    items = rs.randn(4, 10, 2).astype(F32)
    nfull = np.array([3, 0, 10, 5], np.int32)
    for new in (3, 6):
        a, ca = reshard_reservoir(items, nfull, new, 12)
        b, cb = j_reshard(items, nfull, new, 12)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ca, cb)
    with pytest.raises(ValueError, match="overflow"):
        reshard_reservoir(items, nfull, 2, 4)


def test_pipeline_straggler_tolerance():
    """The twin of tests/test_system.py's straggler check: a stalled shard
    contributes zero items that tick, the tick completes, and the data
    arrives next tick; a tick's output drives one sharded manage step."""
    import time

    from repro_torch.data import StreamPipeline
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import init_sharded_state, make_model, make_sharded_manage_step

    delay = {"on": True}

    def make_batch(t, shard):
        if shard == 1 and t == 0 and delay["on"]:
            time.sleep(1.0)
        return np.full((4, 2), t * 10 + shard, np.float32)

    pipe = StreamPipeline(make_batch, num_shards=3, shard_capacity=8, item_shape=(2,),
                          tick_timeout=0.3)
    items, counts = pipe.next_tick()
    assert counts[0] == 4 and counts[2] == 4
    assert counts[1] == 0
    assert pipe.stats["late_shards"] == 1
    time.sleep(1.2)
    items, counts = pipe.next_tick()
    assert counts.tolist() == [4, 4, 4]
    pipe.close()
    batch = {"x": torch.from_numpy(items.reshape(24, 2)), "y": torch.zeros(24)}
    sampler = make_sampler("drtbs", n=10, lam=0.1, cap_s=16, device=CPU)
    tick = make_sharded_manage_step(sampler, make_model("linreg", dim=2, device=CPU),
                                    make_data_mesh(3, device=CPU))
    st = init_sharded_state(sampler, 3, {"x": torch.zeros(2), "y": torch.zeros(())})
    st, _, m = tick(prng.key(0), 0, st, torch.zeros(3), batch, _t(counts).long())
    assert int(st.nfull.sum()) == int(m["size"]) == 10      # 12 arrivals, n = 10
    assert st.items["x"][1, :int(st.nfull[1])].eq(1.0).all()   # shard 1's late rows
