"""The port's keyed sampler bank against the JAX package's ``repro.bank``:

  * device keys: ``fold_in`` / ``split`` over key tensors and per-row
    Philox draws equal the host-key path word for word;
  * routing and sub-batches equal JAX's on the same keys;
  * the plain B3 composition equals JAX's subbatches -> gather ->
    ``apply_banked`` (interpret) -> scatter(mode="drop");
  * the bank's tick map fed JAX's per-key draws equals ``vmap(tick_map)``;
  * a bank tick equals the port's own per-key standalone replay bit for bit;
    its [K] columns equal JAX's per-key replay exactly and JAX's jitted bank
    within 1 ulp of W (XLA contracts d*W + B into one FMA there);
  * per-key Theorem 4.1 on a Zipf keyed stream, extract/size, overflow, dt;
  * the bank manage loop, shared and per key.

Each test states its tolerance; "exact" means bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import bank_tick_draws, t
from repro.bank import make_bank as j_make_bank
from repro.bank import route as j_route
from repro.bank import subbatches as j_subbatches
from repro.core import latent as jl
from repro.core import rtbs as jr
from repro.kernels.tbs_step import ops as jts_ops
from repro_torch import convert
from repro_torch.bank import make_bank, route, subbatches
from repro_torch.bank import routing as trouting
from repro_torch.core import latent as tl
from repro_torch.core import prng, rng
from repro_torch.core import rtbs as tr
from repro_torch.data.streams import KeyedStream, LinRegStream
from repro_torch.kernels.tbs_step import ops as ts_ops
from repro_torch.manage import (make_bank_manage_step, make_bank_run_loop,
                                make_model, materialize_stream)
from repro_torch.manage.bank_loop import _train_windows

CPU = "cpu"
PROTO = {"x": torch.zeros(2)}
JPROTO = jax.ShapeDtypeStruct((2,), jnp.float32)


def _zipf_keys(rs, K, shape, alpha=1.2):
    w = (1.0 + np.arange(K)) ** -alpha
    return rs.choice(K, size=shape, p=w / w.sum()).astype(np.int32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# device keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_device_fold_and_split_equal_host_keys(seed):
    """Exact: every device-derived key equals the host key tree's."""
    k = prng.key(seed)
    ids = torch.tensor([0, 1, 5, 2**31 - 1, 2**33 + 7, -1, 1 << 20])
    dev = prng.fold_in(k, ids)
    for row, i in zip(dev.tolist(), ids.tolist()):
        h = prng.fold_in(k, i)
        assert row == [h.k0, h.k1]
    rows = prng.key_rows(k, 5, CPU)
    assert rows.tolist() == [[c.k0, c.k1] for c in prng.split(k, 5)]
    # a key tensor folds and splits row by row
    for data in (3, torch.arange(5)):
        f = prng.fold_in(rows, data)
        hs = prng.split(k, 5)
        want = [prng.fold_in(h, data if isinstance(data, int) else r)
                for r, h in enumerate(hs)]
        assert f.tolist() == [[w.k0, w.k1] for w in want]
    parts = prng.split(rows, 3)
    for r, h in enumerate(prng.split(k, 5)):
        for p, hp in zip(parts, prng.split(h, 3)):
            assert p[r].tolist() == [hp.k0, hp.k1]


@pytest.mark.parametrize("shape", [(), (1,), (5, 3), (16, 2), (34,)])
def test_per_row_bits_and_uniforms_equal_host_draws(shape):
    """Exact: row r of a per-row draw equals the host draw of key r."""
    keys = prng.fold_in(prng.key(11), torch.arange(6) * 1000)
    b = prng.bits(keys, shape)
    u = prng.uniform(keys, shape)
    assert b.shape == (6,) + shape and u.dtype == torch.float32
    for r in range(6):
        h = prng.Key(*keys[r].tolist())
        assert torch.equal(b[r], prng.bits(h, shape, CPU))
        assert torch.equal(u[r], prng.uniform(h, shape, CPU))


def _draw_leaves(d):
    return [x for ds in (d.ds, d.over) for x in (ds.u, ds.rb_full, ds.rb_small)] \
        + [d.u_m, d.rb_vic, d.rb_pick]


def test_per_row_tick_draws_equal_host_draws():
    """Exact: ``draw_tick`` / ``draw_downsample`` / ``draw_son_bits`` on a
    [T, 2] key tensor give row t the host draws of key t."""
    cap, bcap = 9, 4
    keys = prng.fold_in(prng.key(3), torch.tensor([0, 4, 9, 8]))
    dt = tr.draw_tick(keys, cap=cap, bcap=bcap, device=CPU)
    sb = rng.draw_son_bits(keys, (), CPU)
    for r in range(4):
        h = prng.Key(*keys[r].tolist())
        one = tr.draw_tick(h, cap=cap, bcap=bcap, device=CPU)
        for a, b in zip(_draw_leaves(dt), _draw_leaves(one)):
            assert torch.equal(a[r], b)
        assert torch.equal(sb[r], rng.draw_son_bits(h, (), CPU))
        dd = tl.draw_downsample(keys, cap, CPU, max_deleted=bcap)
        hd = tl.draw_downsample(h, cap, CPU, max_deleted=bcap)
        for a, b in ((dd.u, hd.u), (dd.rb_full, hd.rb_full),
                     (dd.rb_small, hd.rb_small)):
            assert torch.equal(a[r], b)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
ROUTE_CASES = [
    # (keys, bcount, K, bcap): tests/test_bank.py:60's shape, out-of-range
    # ids (:94), bcap overflow, all rows invalid, one hot key
    ("rand", 23, 11, 4),
    ([0, 7, 3, -1, 3, 4, 2, 1], 6, 4, 4),
    ("zipf", 40, 16, 2),
    ([5, 5, 5, 5], 0, 8, 2),
    ([0] * 16, 16, 4, 2),
]


def _route_keys(spec, seed=0):
    rs = np.random.RandomState(seed)
    if spec == "rand":
        return rs.randint(0, 11, size=32).astype(np.int32)
    if spec == "zipf":
        return _zipf_keys(rs, 20, 48)   # ids 16..19 are out of range
    return np.asarray(spec, np.int32)


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_equals_jax(case):
    """Exact on every field of ``Routing``."""
    spec, bcount, K, bcap = case
    keys = _route_keys(spec)
    j = j_route(jnp.asarray(keys), jnp.int32(bcount), num_keys=K, bcap=bcap)
    p = route(torch.from_numpy(keys), torch.tensor(bcount), num_keys=K, bcap=bcap)
    for f in ("order", "touched", "ntouched", "starts", "counts", "dropped",
              "invalid"):
        np.testing.assert_array_equal(_np(getattr(p, f)), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert int(p.overflow) == int(j.overflow)


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_subbatches_equal_jax(case):
    """Exact: the [b, bcap, ...] sub-batch tensors, pytree payload."""
    spec, bcount, K, bcap = case
    keys = _route_keys(spec, 1)
    rs = np.random.RandomState(2)
    pay = {"x": rs.randn(len(keys), 3).astype(np.float32),
           "y": rs.randint(-9, 9, size=len(keys)).astype(np.int8)}
    j = j_subbatches(j_route(jnp.asarray(keys), jnp.int32(bcount), num_keys=K,
                             bcap=bcap), {k: jnp.asarray(v) for k, v in pay.items()},
                     bcap=bcap)
    p = subbatches(route(torch.from_numpy(keys), bcount, num_keys=K, bcap=bcap),
                   {k: torch.from_numpy(v) for k, v in pay.items()}, bcap=bcap)
    for f in pay:
        np.testing.assert_array_equal(p[f].numpy(), np.asarray(j[f]))


# ---------------------------------------------------------------------------
# B3's plain composition against JAX's
# ---------------------------------------------------------------------------
def _jax_banked(bank, payload, src, keys, bcount, K, bcap, impl="interpret"):
    """The JAX bank's payload scope (bank.py:339-346), interpret route (or
    ``impl="ref"``, whose gathers clamp an out-of-range ``src`` where the
    kernel's one-hot rows select nothing)."""
    r = j_route(jnp.asarray(keys), jnp.int32(bcount), num_keys=K, bcap=bcap)
    sub = j_subbatches(r, jnp.asarray(payload), bcap=bcap)
    idx = jnp.minimum(r.touched, K - 1)
    items_t = jl.gather(jnp.asarray(bank), idx)
    out = jts_ops.tbs_step_apply_banked(items_t, sub, jnp.asarray(src), impl=impl)
    return np.asarray(jnp.asarray(bank).at[r.touched].set(out, mode="drop"))


@pytest.mark.parametrize("K,b,cap,bcap,D,dtype", [
    (16, 24, 7, 4, 2, np.float32),
    (5, 32, 17, 8, 1, np.float32),
    (64, 40, 33, 5, 3, np.float32),
    (9, 16, 6, 16, 4, np.int8),
    (3, 8, 9, 2, 100, np.float32),
])
def test_banked_plain_composition_equals_jax(K, b, cap, bcap, D, dtype):
    """Exact: ``tbs_step_apply_banked``'s plain version (in place) against
    JAX's subbatches -> gather -> apply_banked(interpret) -> scatter(drop),
    with a bcount below b and out-of-range ids so padded rows and dropped
    arrivals are in play."""
    rs = np.random.RandomState(K + b + D)
    if dtype == np.int8:
        bank = rs.randint(-100, 100, size=(K, cap, D)).astype(np.int8)
        payload = rs.randint(-100, 100, size=(b, D)).astype(np.int8)
    else:
        bank = rs.randn(K, cap, D).astype(dtype)
        payload = rs.randn(b, D).astype(dtype)
    keys = rs.randint(-1, K + 2, size=b).astype(np.int32)
    bcount = b - 3
    src = rs.randint(0, cap + bcap, size=(b, cap)).astype(np.int32)
    want = _jax_banked(bank, payload, src, keys, bcount, K, bcap)
    r = route(torch.from_numpy(keys), bcount, num_keys=K, bcap=bcap)
    got = torch.from_numpy(bank.copy())
    ts_ops.tbs_step_apply_banked(
        {"a": got}, {"a": torch.from_numpy(payload)}, torch.from_numpy(src),
        order=r.order, starts=r.starts, touched=r.touched, ntouched=r.ntouched,
        bcap=bcap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts_ops.tbs_step_apply_banked.launches == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banked_pass_writes_only_the_write_mask(seed):
    """Exact: ``ref.banked_write_mask`` marks a slot unless its clamped
    source is itself, and the plain composition (like JAX's, which it
    equals here) leaves every slot outside it, and every key not touched,
    bit-unchanged: self-copies, ``src < 0`` at slot 0, ``src >= cap +
    bcap``, out-of-range keys and routing rows past ``ntouched``. JAX's
    composition is its ``impl="ref"`` route where ``src`` leaves [0, cap +
    bcap) (the kernel's one-hot rows select nothing there), its interpret
    route on the same map with those entries brought into range."""
    from repro_torch.kernels.tbs_step import ref as ts_ref

    rs = np.random.RandomState(seed)
    K, b, cap, bcap, D = 12, 24, 9, 4, 2
    bank = rs.randn(K, cap, D).astype(np.float32)
    payload = rs.randn(b, D).astype(np.float32)
    keys = rs.randint(-2, K + 3, size=b).astype(np.int32)
    bcount = b - 4
    src = rs.randint(-3, cap + bcap + 4, size=(b, cap)).astype(np.int32)
    src = np.where(rs.rand(b, cap) < 0.6, np.arange(cap, dtype=np.int32), src)
    src[::2, 0] = -2                     # reads slot 0: a self-copy at slot 0
    src[1::2, 0] = 5                     # a move into slot 0
    src[::3, -1] = cap + bcap + 5        # clamps to the last batch slot
    mask = ts_ref.banked_write_mask(torch.from_numpy(src), cap).numpy()
    slot = np.arange(cap)
    np.testing.assert_array_equal(mask, (src >= cap) | (np.clip(src, 0, cap - 1) != slot))
    assert not mask[::2, 0].any() and mask[1::2, 0].all() and mask[::3, -1].all()
    assert not mask[src == slot].any()

    r = route(torch.from_numpy(keys), bcount, num_keys=K, bcap=bcap)
    for s, impl in ((src, "ref"), (np.clip(src, 0, cap + bcap - 1), "interpret")):
        got = torch.from_numpy(bank.copy())
        ts_ops.tbs_step_apply_banked({"a": got}, {"a": torch.from_numpy(payload)},
                                     torch.from_numpy(s), order=r.order, starts=r.starts,
                                     touched=r.touched, ntouched=r.ntouched, bcap=bcap)
        np.testing.assert_array_equal(
            got.numpy(), _jax_banked(bank, payload, s, keys, bcount, K, bcap, impl), impl)
        may = np.zeros((K, cap), bool)
        may[r.touched[: int(r.ntouched)].numpy()] = mask[: int(r.ntouched)]
        bits, old = got.numpy().view(np.int32), bank.view(np.int32)
        np.testing.assert_array_equal(bits[~may], old[~may])
        assert (bits[may] != old[may]).any(axis=-1).mean() > 0.9
    assert int(r.ntouched) < b and int(r.invalid) > 0   # padded rows, dropped ids


# ---------------------------------------------------------------------------
# the bank tick against JAX and against the port's own per-key replay
# ---------------------------------------------------------------------------
def _jax_bank_state(K, n, bcap, lam, ticks, seed):
    bank = j_make_bank("rtbs", num_keys=K, n=n, lam=lam, bcap=bcap)
    st = bank.init(JPROTO)
    rs = np.random.RandomState(seed)
    step = jax.jit(bank.step)
    for tt in range(ticks):
        st = step(jax.random.fold_in(jax.random.key(seed), tt), st,
                       jnp.asarray(rs.randint(0, K, size=12), jnp.int32),
                       jnp.asarray(rs.randn(12, 2), jnp.float32), jnp.int32(12))
    return st


def test_bank_tick_map_fed_jax_draws_equals_jax_vmap():
    """Exact: the bank's ``tick_map`` over the routed rows, fed the JAX
    bank's per-key draws (``fold_in(kt, k_id)``), equals
    ``jax.vmap(rtbs.tick_map)`` on src, C and W."""
    K, n, bcap, b, lam = 10, 6, 4, 20, 0.3
    cap = n + 1
    st = _jax_bank_state(K, n, bcap, lam, 3, 5)
    rs = np.random.RandomState(9)
    keys = rs.randint(0, K, size=b).astype(np.int32)
    kt = jax.random.key(123)
    d = jnp.float32(math.exp(-lam))
    pending = st.pending * d
    r = j_route(jnp.asarray(keys), jnp.int32(b - 2), num_keys=K, bcap=bcap)
    idx = jnp.minimum(r.touched, K - 1)
    tkeys = jax.vmap(lambda k_id: jax.random.fold_in(kt, k_id))(r.touched)
    # eager vmap: under jit XLA may contract d*W + B into one FMA
    src, C3, w_new = jax.vmap(
        lambda kk, k0, C, W, cnt, dd: jr.tick_map(kk, k0, C, W, cnt, dd, cap=cap,
                                                  bcap=bcap, n=n)
    )(tkeys, st.nfull[idx], st.weight[idx], st.total_weight[idx], r.counts,
      pending[idx])

    pr = route(torch.from_numpy(keys), b - 2, num_keys=K, bcap=bcap)
    pidx = pr.touched.clamp(max=K - 1)
    g = lambda a: t(a)[pidx]  # noqa: E731
    p_src, p_C3, p_w = tr.tick_map(
        bank_tick_draws(tkeys, cap, bcap), g(st.nfull), g(st.weight),
        g(st.total_weight), pr.counts, t(pending)[pidx], cap=cap, bcap=bcap, n=n)
    np.testing.assert_array_equal(p_src.numpy(), np.asarray(src))
    np.testing.assert_array_equal(p_C3.numpy(), np.asarray(C3))
    np.testing.assert_array_equal(p_w.numpy(), np.asarray(w_new))


def _bank_stream(K, b, T, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, K, size=b).astype(np.int32),
             rs.randn(b, 2).astype(np.float32)) for _ in range(T)]


def test_bank_tick_equals_per_key_standalone_replay():
    """Exact on items, nfull, weight, W and pending: each touched key's
    reservoir after a bank tick equals the port's standalone ``rtbs.step``
    of that key alone (key ``fold_in(kt, k_id)``, decay = its composed
    pending factor) over its routed sub-batch; untouched keys only decay
    their pending factor (the protocol of tests/test_bank.py:149)."""
    K, n, bcap, b, T, lam = 8, 5, 4, 16, 6, 0.3
    d = torch.tensor(math.exp(-lam), dtype=torch.float32)
    bank = make_bank("rtbs", num_keys=K, n=n, lam=lam, bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    key0 = prng.key(7)
    lazy_seen = False
    for tt, (keys, pay) in enumerate(_bank_stream(K, b, T, 3)):
        kt = prng.fold_in(key0, tt)
        keys_t, pay_t = torch.from_numpy(keys), {"x": torch.from_numpy(pay)}
        pend = st.pending * d
        r = route(keys_t, b, num_keys=K, bcap=bcap)
        sub = subbatches(r, pay_t, bcap=bcap)
        items = st.items["x"].clone()
        nfull, C = st.nfull.clone(), st.weight.clone()
        W = st.total_weight.clone()
        for i in range(int(r.ntouched)):
            k_id = int(r.touched[i])
            st_k = tr.RTBSState(lat=tl.Latent(items={"x": items[k_id].clone()},
                                              nfull=nfull[k_id].to(torch.int64),
                                              weight=C[k_id].clone()),
                                total_weight=W[k_id].clone())
            out = tr.step(prng.fold_in(kt, k_id), st_k, {"x": sub["x"][i]},
                          r.counts[i], n=n, decay=pend[k_id])
            items[k_id] = out.lat.items["x"]
            nfull[k_id], C[k_id] = out.lat.nfull, out.lat.weight
            W[k_id] = out.total_weight
            pend[k_id] = 1.0
        lazy_seen = lazy_seen or bool((pend < 1.0).any())
        st = bank.step(kt, st, keys_t, pay_t, torch.tensor(b))
        assert torch.equal(st.items["x"], items)
        assert torch.equal(st.nfull, nfull) and st.nfull.dtype == torch.int32
        assert torch.equal(st.weight, C)
        assert torch.equal(st.total_weight, W)
        assert torch.equal(st.pending, pend)
    assert lazy_seen   # some key carried a deferred decay into a tick


def test_bank_tick_map_then_banked_pass_equals_step():
    """Exact: the bank's tick up to its payload pass (``_rtbs_tick_map`` on
    the pending factors times the tick's decay), then one banked payload
    pass per leaf, equals ``step`` on items and its [K] columns; those are
    the operands a payload pass is checked on at full size."""
    from repro_torch.bank.bank import _rtbs_tick_map

    K, n, bcap, b, T, lam = 16, 6, 4, 24, 5, 0.2
    bank = make_bank("rtbs", num_keys=K, n=n, lam=lam, bcap=bcap, device=CPU)
    st = bank.init({"x": torch.zeros(2), "y": torch.zeros((), dtype=torch.int8)})
    for tt, (keys, pay) in enumerate(_bank_stream(K, b, T, 5)):
        kt = prng.fold_in(prng.key(3), tt)
        keys_t = torch.from_numpy(keys)
        pay_t = {"x": torch.from_numpy(pay),
                 "y": torch.arange(b, dtype=torch.int8) + 7 * tt}
        r, src, k3, C3, w_new = _rtbs_tick_map(kt, st, keys_t, b,
                                               st.pending * bank.base_rate(st),
                                               n=n, bcap=bcap)
        items = {f: v.clone() for f, v in st.items.items()}
        ts_ops.tbs_step_apply_banked(items, pay_t, src, order=r.order,
                                     starts=r.starts, touched=r.touched,
                                     ntouched=r.ntouched, bcap=bcap)
        st = bank.step(kt, st, keys_t, pay_t, b)
        for f in items:
            assert torch.equal(st.items[f], items[f])
        nt = int(r.ntouched)
        tt_ids = r.touched[:nt].long()
        assert torch.equal(st.nfull[tt_ids], k3[:nt].to(torch.int32))
        assert torch.equal(st.weight[tt_ids], C3[:nt])
        assert torch.equal(st.total_weight[tt_ids], w_new[:nt])


def _fma32(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in f64, one rounding."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def test_bank_columns_equal_jax_replay_and_jitted_bank():
    """The [K] columns are deterministic given the stream (DESIGN.md
    Sec. 11). Exact against the JAX per-key replay (jitted ``rtbs.step``
    per key, as tests/test_bank.py:149 builds it) on nfull, C, W and
    pending; against JAX's jitted bank exact on nfull, C and pending and
    within 1 ulp on W, where the jitted bank is the one-rounding FMA
    ``fma(d, W, B)`` and the replay and the port round twice. A JAX bank
    state carried across mid-stream continues identically."""
    K, n, bcap, b, T, lam = 8, 5, 4, 16, 6, 0.3
    d = np.float32(math.exp(-lam))
    jbank = j_make_bank("rtbs", num_keys=K, n=n, lam=lam, bcap=bcap)
    jstep = jax.jit(jbank.step)
    jst = jbank.init(JPROTO)
    bank = make_bank("rtbs", num_keys=K, n=n, lam=lam, bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    exp = {"nfull": np.zeros(K, np.int32), "weight": np.zeros(K, np.float32),
           "total_weight": np.zeros(K, np.float32),
           "pending": np.ones(K, np.float32)}
    items = np.zeros((K, n + 1, 2), np.float32)
    key0 = jax.random.key(7)
    fma_used = 0
    for tt, (keys, pay) in enumerate(_bank_stream(K, b, T, 3)):
        kt = jax.random.fold_in(key0, tt)
        exp["pending"] = (exp["pending"] * d).astype(np.float32)
        r = j_route(jnp.asarray(keys), jnp.int32(b), num_keys=K, bcap=bcap)
        sub = j_subbatches(r, jnp.asarray(pay), bcap=bcap)
        W_prev = exp["total_weight"].copy()
        pend_prev = exp["pending"].copy()
        jW_prev = np.asarray(jst.total_weight).copy()
        for i in range(int(r.ntouched)):
            k_id = int(r.touched[i])
            out = jr.step(jax.random.fold_in(kt, k_id),
                          jr.RTBSState(lat=jl.Latent(items=jnp.asarray(items[k_id]),
                                                     nfull=jnp.int32(exp["nfull"][k_id]),
                                                     weight=jnp.float32(exp["weight"][k_id])),
                                       total_weight=jnp.float32(W_prev[k_id])),
                          sub[i], r.counts[i], n=n, decay=jnp.float32(pend_prev[k_id]))
            items[k_id] = np.asarray(out.lat.items)
            exp["nfull"][k_id] = int(out.lat.nfull)
            exp["weight"][k_id] = np.float32(out.lat.weight)
            exp["total_weight"][k_id] = np.float32(out.total_weight)
            exp["pending"][k_id] = 1.0
        jst = jstep(kt, jst, jnp.asarray(keys), jnp.asarray(pay), jnp.int32(b))
        st = bank.step(prng.fold_in(prng.key(7), tt), st, torch.from_numpy(keys),
                       {"x": torch.from_numpy(pay)}, b)
        got = convert.bank_state_to_numpy(st)
        for f, v in exp.items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)
        for f in ("nfull", "weight", "pending"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jst, f)), err_msg=f)
        jw = np.asarray(jst.total_weight)
        np.testing.assert_array_max_ulp(got["total_weight"], jw, maxulp=1)
        # where they differ, JAX's jitted bank is the FMA of the port's inputs
        for k in np.nonzero(got["total_weight"] != jw)[0]:
            c = float(np.asarray(r.counts)[list(np.asarray(r.touched)).index(k)])
            assert jw[k] == _fma32(pend_prev[k], jW_prev[k], c)
            fma_used += 1
        # carry JAX's jitted state across: the port continues from it
        if tt == 2:
            st = convert.bank_state_from_numpy(
                {"x": np.asarray(jst.items)}, jst.nfull, jst.weight,
                jst.total_weight, jst.pending, jst.overflow, device=CPU)
            for f in exp:
                exp[f] = np.asarray(getattr(jst, f)).copy()
            items = np.asarray(jst.items).copy()
    assert fma_used > 0   # the case occurs in this stream


# ---------------------------------------------------------------------------
# per-key Theorem 4.1 (the acceptance criterion of tests/test_bank.py:255)
# ---------------------------------------------------------------------------
def test_bank_per_key_theorem_4_1_equivalence():
    """Tolerance 0.03 on inclusion probabilities over 10,000 trials, as
    tests/test_bank.py:255. Key k's reservoir in a K-key bank under a Zipf
    keyed stream reproduces Pr[i in S] = (C_T/W_T) e^{-lam a}, for a
    saturated (popular) and an unsaturated, irregular (rare) key, and
    agrees with standalone R-TBS fed only the key's arrivals lazily (dt
    gaps) and eagerly (empty ticks). The 10,000 trials are 10,000 copies of
    the K tenants in ONE bank (trial s owns keys [sK, (s+1)K)), each
    drawing from its own folded key."""
    K, n, T, b, lam, trials = 8, 6, 8, 16, 0.25, 10000
    bcap = b
    d = math.exp(-lam)
    rs = np.random.RandomState(5)
    keys = _zipf_keys(rs, K, (T, b))
    payload = (np.arange(1, T + 1)[:, None] * 100
               + np.arange(b)[None, :]).astype(np.float32)
    payload = np.repeat(payload[:, :, None], 2, axis=2)

    off = (np.arange(trials, dtype=np.int64) * K)[:, None]
    bank = make_bank("rtbs", num_keys=K * trials, n=n, lam=lam, bcap=bcap,
                     device=CPU)
    st = bank.init(PROTO)
    for tt in range(T):
        kk = torch.from_numpy((keys[tt][None, :] + off).reshape(-1))
        pp = {"x": torch.from_numpy(np.tile(payload[tt], (trials, 1)))}
        st = bank.step(prng.fold_in(prng.key(1), tt), st, kk, pp, kk.shape[0])

    def tick_counts(items, mask):
        ticks = (items[..., 0] // 100).to(torch.int64)
        out = torch.zeros(mask.shape[0], T + 1)
        out.scatter_add_(1, ticks, mask.to(torch.float32))
        return out[:, 1:].mean(dim=0).numpy()

    def standalone(focal, lazy):
        st1 = tr.RTBSState(
            lat=tl.Latent(items=torch.zeros(trials, n + 1, 2),
                          nfull=torch.zeros(trials, dtype=torch.int64),
                          weight=torch.zeros(trials)),
            total_weight=torch.zeros(trials))
        arrived = keys == focal
        prev = -1
        for tt in range(T):
            c_t = int(arrived[tt].sum())
            if not lazy or c_t > 0:
                gap = tt - prev
                bt = torch.zeros(bcap, 2)
                bt[:c_t] = torch.from_numpy(payload[tt, np.nonzero(arrived[tt])[0]])
                ktick = prng.fold_in(prng.key(2 + lazy), tt)
                draws = tr.draw_tick(ktick, cap=n + 1, bcap=bcap, device=CPU,
                                     batch=(trials,))
                st1 = tr.step_with(draws, st1, bt, torch.tensor(c_t), n=n,
                                   decay=torch.tensor(d ** (gap if lazy else 1),
                                                      dtype=torch.float32))
                prev = tt
        k_ds, k_re = prng.split(prng.key(4 + lazy))
        w_eff = torch.tensor(d ** (T - 1 - prev), dtype=torch.float32) * st1.total_weight
        draws = tl.draw_downsample(k_ds, n + 1, CPU, max_deleted=bcap, batch=(trials,))
        lat = tl.downsample(draws, st1.lat, torch.minimum(st1.lat.weight, w_eff),
                            max_deleted=bcap)
        mask, _ = tl.realize(prng.uniform(k_re, (trials,), CPU), lat)
        return tick_counts(lat.items, mask)

    for focal in (0, 5):
        c = (keys == focal).sum(axis=1).astype(np.float64)
        assert c.sum() > 0
        if focal == 5:
            assert (c == 0).any()
        W = 0.0
        for tt in range(T):
            W = d * W + c[tt]
        C = min(n, W)
        expect = np.array([(C / W) * d ** (T - 1 - tt) if c[tt] else 0.0
                           for tt in range(T)])
        view = bank.extract(prng.key(777), st, (np.arange(trials) * K + focal).tolist())
        got = {"bank": tick_counts(view.items["x"], view.mask),
               "lazy": standalone(focal, True), "eager": standalone(focal, False)}
        denom = np.where(c > 0, c, 1.0)
        for name, counts in got.items():
            probs = counts / denom
            for tt in range(T):
                assert abs(probs[tt] - expect[tt]) < 0.03, (focal, name, tt,
                                                            probs[tt], expect[tt])
        np.testing.assert_allclose(got["bank"] / denom, got["lazy"] / denom,
                                   atol=0.03)


# ---------------------------------------------------------------------------
# extract / size / overflow / dt / validation
# ---------------------------------------------------------------------------
def test_bank_extract_size_consistent_and_settles_pending():
    """Exact: ``mask.sum() == size`` per key and ``size`` equals
    ``extract``'s sizes for the same key; empty ticks move no payload and
    only decay ``pending``; sizes respect the decayed weight."""
    K, n, bcap, b = 12, 6, 8, 24
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.4, bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    rs = np.random.RandomState(6)
    for tt in range(6):
        st = bank.step(prng.fold_in(prng.key(2), tt), st,
                       torch.from_numpy(_zipf_keys(rs, K, b)),
                       {"x": torch.from_numpy(rs.randn(b, 2).astype(np.float32))}, b)
    before = st.items["x"].clone()
    for tt in range(6, 10):
        st = bank.step(prng.fold_in(prng.key(2), tt), st,
                       torch.zeros(b, dtype=torch.int32), {"x": torch.zeros(b, 2)}, 0)
    assert torch.equal(st.items["x"], before)
    assert (st.pending < 1.0).all()
    for ids in (range(K), torch.arange(K)):
        view = bank.extract(prng.key(9), st, ids)
        sizes = bank.size(prng.key(9), st, ids)
        assert torch.equal(view.mask.sum(dim=1), view.size)
        assert torch.equal(sizes, view.size)
    w_eff = (st.pending * st.total_weight).numpy()
    assert (sizes.numpy() <= np.ceil(np.minimum(n, w_eff) + 1e-6)).all()
    assert (sizes.numpy() <= n).all()


def test_bank_routing_overflow_accounting_through_step():
    """Exact overflow counts; W within 1e-5 relative of the accepted-only
    recurrence computed in f64 (tests/test_bank.py's tolerance)."""
    K, n, bcap, b = 4, 8, 2, 16
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.1, bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    for tt in range(3):
        st, stats = bank.step_stats(prng.fold_in(prng.key(0), tt), st,
                                    torch.zeros(b, dtype=torch.int32),
                                    {"x": torch.ones(b, 2)}, b)
        assert int(stats["overflow"]) == b - bcap and int(stats["ntouched"]) == 1
    assert int(st.overflow[0]) == 3 * (b - bcap)
    assert (st.overflow[1:] == 0).all()
    W = 0.0
    for _ in range(3):
        W = math.exp(-0.1) * W + bcap
    np.testing.assert_allclose(float(st.total_weight[0]), W, rtol=1e-5)


def test_bank_step_dt_consumes_wallclock_gaps():
    """One step spanning dt=3 equals three unit steps: pending within 1e-6
    relative (e^{-3 lam} against three f32 products), items and W exact."""
    K, n, bcap, b = 6, 5, 4, 8
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.2, bcap=bcap, device=CPU)
    rs = np.random.RandomState(7)
    keys = torch.from_numpy(rs.randint(0, K, size=b).astype(np.int32))
    pay = {"x": torch.from_numpy(rs.randn(b, 2).astype(np.float32))}
    st = bank.step(prng.key(1), bank.init(PROTO), keys, pay, b)
    empty_k, empty_p = torch.zeros(b, dtype=torch.int32), {"x": torch.zeros(b, 2)}
    clone = lambda s: torch.utils._pytree.tree_map(torch.clone, s)  # noqa: E731
    st_unit = clone(st)
    for tt in range(1, 4):
        st_unit = bank.step(prng.key(10 + tt), st_unit, empty_k, empty_p, 0)
    st_dt = bank.step(prng.key(9), clone(st), empty_k, empty_p, 0,
                      dt=torch.tensor(3.0))
    np.testing.assert_allclose(st_dt.pending.numpy(), st_unit.pending.numpy(),
                               rtol=1e-6)
    assert torch.equal(st_dt.items["x"], st_unit.items["x"])
    assert torch.equal(st_dt.total_weight, st_unit.total_weight)


def test_step_decayed_takes_a_per_key_factor():
    """Exact: ``step_decayed`` with a [K] factor decays each key's pending
    by its own factor and equals ``step`` when the factor is the schedule's."""
    K, n, bcap, b = 5, 4, 4, 8
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.2, bcap=bcap, device=CPU)
    empty_k, empty_p = torch.zeros(b, dtype=torch.int32), {"x": torch.zeros(b, 2)}
    st = bank.init(PROTO)
    dk = torch.linspace(0.5, 0.9, K)
    s1 = bank.step_decayed(prng.key(0), st, empty_k, empty_p, 0, dk)
    assert torch.equal(s1.pending, dk)
    rs = np.random.RandomState(1)
    keys = torch.from_numpy(rs.randint(0, K, size=b).astype(np.int32))
    pay = {"x": torch.from_numpy(rs.randn(b, 2).astype(np.float32))}
    a = bank.step(prng.key(3), bank.init(PROTO), keys, pay, b)
    c = bank.step_decayed(prng.key(3), bank.init(PROTO), keys, pay, b,
                          bank.base_rate(st))
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(c)):
        assert torch.equal(x, y)


def test_make_bank_validation():
    with pytest.raises(ValueError, match="unknown bank scheme"):
        make_bank("nope", num_keys=4, n=2, device=CPU)
    with pytest.raises(ValueError, match="num_keys"):
        make_bank("rtbs", num_keys=0, n=2, lam=0.1, device=CPU)
    with pytest.raises(ValueError, match="exactly one"):
        make_bank("rtbs", num_keys=4, n=2, device=CPU)
    from repro_torch.decay import polynomial

    b = make_bank("rtbs", num_keys=4, n=2, decay=polynomial(0.8), device=CPU)
    st = b.init(PROTO)
    assert st.dstate is not None and "SamplerBank(rtbs" in repr(b)
    with pytest.raises(ValueError, match="key_ids"):
        b.extract(prng.key(0), st, [0, 4])
    with pytest.raises(ValueError, match="key_ids"):
        b.size(prng.key(0), st, np.asarray([-1]))
    with pytest.raises(ValueError, match="train_keys"):
        make_bank_run_loop(b, make_model("linreg", device=CPU), train_keys=range(9))
    with pytest.raises(TypeError, match="Telemetry"):
        make_bank_run_loop(b, make_model("linreg", device=CPU), train_keys=range(2),
                           telemetry=object())
    from repro_torch.obs import MemorySink, Telemetry
    tel = Telemetry([MemorySink()], probe_key=3)
    make_bank_run_loop(b, make_model("linreg", device=CPU), train_keys=range(2),
                       telemetry=tel)   # a real handle builds
    with pytest.raises(ValueError, match="probe_key"):
        make_bank_run_loop(b, make_model("linreg", device=CPU), train_keys=range(2),
                           telemetry=Telemetry([MemorySink()], probe_key=4))


def test_time_varying_schedule_bank_equals_its_factors():
    """Exact: a polynomial-schedule bank's pending after T empty ticks is
    the f32 product of the schedule's factors."""
    from repro_torch.decay import decay_profile, polynomial

    sched = polynomial(0.8)
    b = make_bank("rtbs", num_keys=3, n=2, decay=sched, device=CPU)
    st = b.init(PROTO)
    for tt in range(5):
        st = b.step(prng.key(tt), st, torch.zeros(4, dtype=torch.int32),
                    {"x": torch.zeros(4, 2)}, 0)
    want = torch.ones(())
    for f in decay_profile(sched, 5, device=CPU):
        want = want * f
    assert torch.equal(st.pending, want.expand(3))


def test_bank_4096_keys_touch_only_arrivals():
    """Exact: at K = 4096 only the arriving keys gain weight."""
    K, n, bcap, b, T = 4096, 8, 8, 64, 4
    rs = np.random.RandomState(8)
    keys = _zipf_keys(rs, K, (T, b))
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.1, bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    for tt in range(T):
        st = bank.step(prng.fold_in(prng.key(0), tt), st, torch.from_numpy(keys[tt]),
                       {"x": torch.from_numpy(rs.randn(b, 2).astype(np.float32))}, b)
    touched = np.unique(keys)
    w = st.total_weight.numpy()
    assert (w[touched] > 0).all()
    assert (np.delete(w, touched) == 0).all()
    assert st.items["x"].shape == (K, n + 1, 2)


# ---------------------------------------------------------------------------
# the bank manage loop
# ---------------------------------------------------------------------------
def _keyed_stream(K=32, T=12, b=24):
    stream = KeyedStream(base=LinRegStream(seed=0), num_keys=K, alpha=1.2,
                         flip_every=6)
    return materialize_stream(stream, T, batch_size=b, fields=("key", "x", "y"),
                              device=CPU)


def test_materialize_stream_carries_the_key_column():
    """Exact: the ``"key"`` column and payload of a materialized
    ``KeyedStream`` are the stream's own."""
    from repro.data import streams as jstreams

    batches, bcounts = _keyed_stream(K=32, T=3, b=10)
    assert set(batches) == {"key", "x", "y"} and batches["key"].dtype == torch.int32
    js = jstreams.KeyedStream(jstreams.LinRegStream(seed=0), 32, alpha=1.2,
                              flip_every=6)
    for tt in range(3):
        k, x, y = js.batch(tt, 10)
        np.testing.assert_array_equal(batches["key"][tt].numpy(), k)
        np.testing.assert_array_equal(batches["x"][tt].numpy(), x)
        np.testing.assert_array_equal(batches["y"][tt].numpy(), y)
    assert bcounts.tolist() == [10, 10, 10]


def test_per_key_eval_windows_never_leak_other_tenants():
    """Exact, the case of tests/test_bank.py:581: rows past each key's
    count are zero, so an adapter that ignores bcount never sees another
    tenant's rows."""
    bank = make_bank("rtbs", num_keys=8, n=4, lam=0.1, bcap=4, device=CPU)
    keys = torch.tensor([0, 1, 0, 2, 1, 5, 0, 0], dtype=torch.int32)
    payload = torch.arange(8, dtype=torch.float32)[:, None] * torch.ones(1, 2) + 1.0
    tk = torch.tensor([0, 1, 3])
    _, stats = bank.step_stats(prng.key(0), bank.init({"x": torch.zeros(2)}), keys,
                               {"x": payload}, torch.tensor(6))
    windows, counts = _train_windows(stats["routing"], payload, bank.bcap, tk)
    assert counts.tolist() == [2, 2, 0]
    w = windows.numpy()
    np.testing.assert_array_equal(w[0, :2, 0], [1, 3])
    np.testing.assert_array_equal(w[1, :2, 0], [2, 5])
    assert (w[0, 2:] == 0).all() and (w[1, 2:] == 0).all()
    assert (w[2] == 0).all()


@pytest.mark.parametrize("per_key", [False, True])
def test_bank_run_loop_equals_ticks_by_hand(per_key):
    """Exact: ``make_bank_run_loop`` equals its tick body driven by hand
    (state, params and trace); shapes and the per-key NaN pattern (a key's
    metric is NaN exactly on ticks it has no arrivals) as the JAX loop's."""
    K, Q, T = 32, 4, 12
    batches, bcounts = _keyed_stream(K=K, T=T)
    bank = make_bank("rtbs", num_keys=K, n=10, lam=0.1, bcap=8, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    state, params, trace = make_bank_run_loop(
        bank, model, retrain_every=3, train_keys=range(Q), per_key=per_key)(
        prng.key(0), batches, bcounts)
    tick = make_bank_manage_step(bank, model, retrain_every=3, train_keys=range(Q),
                                 per_key=per_key)
    st = bank.init({"x": torch.zeros(2), "y": torch.zeros(())})
    p = model.init()
    if per_key:
        p = p.unsqueeze(0).expand(Q, 3).clone()
    ms = []
    for tt in range(T):
        st, p, m = tick(prng.key(0), tt, st, p, {f: v[tt] for f, v in batches.items()},
                        bcounts[tt])
        ms.append(m)
    for a, b in zip(torch.utils._pytree.tree_leaves((state, params)),
                    torch.utils._pytree.tree_leaves((st, p))):
        assert torch.equal(a, b)
    for k in trace:
        torch.testing.assert_close(trace[k], torch.stack([m[k] for m in ms]),
                                   rtol=0, atol=0, equal_nan=True)
    assert trace["size"].shape == (T, Q) and trace["overflow"].shape == (T,)
    assert (trace["size"] <= 10).all()
    if per_key:
        assert trace["metric"].shape == (T, Q) and params.shape == (Q, 3)
        kk = batches["key"].numpy()
        arrive = np.stack([(kk == q).any(axis=1) for q in range(Q)], axis=1)
        np.testing.assert_array_equal(np.isfinite(trace["metric"].numpy()), arrive)
        assert len({params[q].numpy().tobytes() for q in range(Q)}) > 1
    else:
        assert trace["metric"].shape == (T,) and params.shape == (3,)
        assert np.isfinite(trace["metric"].numpy()[1:]).all()


def test_bank_shared_loop_fits_the_pooled_extract():
    """Within 1e-4 relative (f32 normal equations summed in another order
    than XLA's): the shared model after a retrain tick equals linreg fit by
    the JAX adapter on the port's own pooled extract."""
    from repro.core.api import SampleView as JView
    from repro.manage import make_model as j_make_model
    from repro_torch.manage import pooled_view

    K, Q = 16, 3
    batches, bcounts = _keyed_stream(K=K, T=3, b=20)
    bank = make_bank("rtbs", num_keys=K, n=6, lam=0.1, bcap=8, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    tick = make_bank_manage_step(bank, model, retrain_every=3, train_keys=range(Q))
    st, p = bank.init({"x": torch.zeros(2), "y": torch.zeros(())}), model.init()
    for tt in range(3):
        st, p, _ = tick(prng.key(4), tt, st, p, {f: v[tt] for f, v in batches.items()},
                        bcounts[tt])
    _, k_extract, _ = prng.split(prng.fold_in(prng.key(4), 2), 3)
    view = pooled_view(bank.extract(k_extract, st, range(Q)))
    jv = JView(items={f: jnp.asarray(view.items[f].numpy()) for f in ("x", "y")},
               mask=jnp.asarray(view.mask.numpy()), size=jnp.int32(int(view.size)))
    want = j_make_model("linreg", dim=2).fit(jax.random.key(0), None, jv)
    np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_routing_module_drops_through_the_sentinel_slot():
    """Exact: the b+1-long drop buffer leaves rows past ntouched at the
    sentinel and never writes a real row for an invalid item."""
    r = trouting.route(torch.tensor([3, 9, 3, 1]), 4, num_keys=4, bcap=8)
    assert r.touched.tolist() == [1, 3, 4, 4]
    assert r.counts.tolist() == [1, 2, 0, 0] and int(r.invalid) == 1


def test_banked_wrapper_refuses_operands_that_do_not_agree():
    """The B3 wrapper checks shapes on the host before any pointer is
    passed: src must be [b, cap], the routing [b], the rows equal."""
    r = route(torch.tensor([0, 1, 1]), 3, num_keys=2, bcap=2)
    bank = torch.zeros(2, 4, 3)
    args = dict(order=r.order, starts=r.starts, touched=r.touched,
                ntouched=r.ntouched, bcap=2)
    for payload, src in ((torch.zeros(3, 3), torch.zeros(3, 5, dtype=torch.int32)),
                         (torch.zeros(3, 2), torch.zeros(3, 4, dtype=torch.int32)),
                         (torch.zeros(4, 3), torch.zeros(4, 4, dtype=torch.int32)),
                         (torch.zeros(3, 3), torch.zeros(12, dtype=torch.int32))):
        with pytest.raises(ValueError, match="tbs_step_apply_banked"):
            ts_ops.tbs_step_apply_banked(bank, payload, src, **args)
    with pytest.raises(ValueError, match="contiguous"):
        ts_ops.tbs_step_apply_banked(torch.zeros(4, 2, 3).transpose(0, 1),
                                     torch.zeros(3, 3),
                                     torch.zeros(3, 4, dtype=torch.int32), **args)
