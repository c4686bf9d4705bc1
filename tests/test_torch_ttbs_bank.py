"""The port's T-TBS bank (``make_bank("ttbs", ...)``) and the bank loop's
decay controller against the JAX package's ``repro.bank`` and
``repro.manage.bank_loop``:

  * the per-key slot map fed JAX's draws (binomial results included)
    equals JAX's ``_ttbs_key_map`` bit for bit;
  * a bank tick equals the port's own standalone ``ttbs_step`` of each
    touched key over its routed sub-batch bit for bit (the twin of
    tests/test_bank.py's vmap-of-single parity);
  * W and pending equal JAX's jitted bank bit for bit (W is rounded once,
    as XLA contracts ``p_eff * W + B`` into a fused multiply-add);
  * per-key eq. (1) inclusion on a Zipf keyed stream;
  * extract / size, the capacity overflow, and the bank loop with a shared
    and a per-key controller (the twin of tests/test_bank.py's per-key
    farm with a controller).

Each test states its tolerance; "exact" means bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_jax_draws import t
from repro.bank import bank as jbank_mod
from repro.bank import make_bank as j_make_bank
from repro.core import rng as jrng
from repro_torch.bank import make_bank, route, subbatches
from repro_torch.bank.bank import _ttbs_key_map, _ttbs_tick_map
from repro_torch.core import prng, simple
from repro_torch.data.streams import KeyedStream, LinRegStream
from repro_torch.decay import loss_ratio, polynomial
from repro_torch.kernels.tbs_step import ops as ts_ops
from repro_torch.manage import (make_bank_manage_step, make_bank_run_loop, make_model,
                                materialize_stream)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tests run many small and mid-size
    CPU ops, which slow down many times over when the parallel test
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PROTO = {"x": torch.zeros(2)}
JPROTO = jax.ShapeDtypeStruct((2,), jnp.float32)
F32 = np.float32


def _zipf_keys(rs, K, shape, alpha=1.2):
    w = (1.0 + np.arange(K)) ** -alpha
    return rs.choice(K, size=shape, p=w / w.sum()).astype(np.int32)


def _stream(K, b, T, seed, zipf=False):
    rs = np.random.RandomState(seed)
    keys = (_zipf_keys(rs, K, (T, b)) if zipf else rs.randint(0, K, size=(T, b)))
    return [(keys[t].astype(np.int32), rs.randn(b, 2).astype(np.float32))
            for t in range(T)]


def _bits_equal(a, b) -> bool:
    """Bit for bit, NaNs included."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _q32(n, d, batch_size):
    """The bank's acceptance probability in f32: clip(n (1 - d) / b, 0, 1)."""
    return torch.clamp(n * (1.0 - torch.as_tensor(d, dtype=torch.float32))
                       / torch.tensor(float(batch_size)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# the per-key map, given JAX's draws (ROADMAP's rule (a))
# ---------------------------------------------------------------------------
def test_ttbs_key_map_fed_jax_draws_equals_jax():
    """Exact on src, new_count and dropped over 96 rows: empty, full and
    overflowing buffers, empty and full sub-batches, p and q at 0, 1 and in
    between, each row's draws those of JAX's ``_ttbs_key_map`` (the two
    binomial results and the two swap-or-not round words)."""
    cap, bcap, R = 12, 5, 96
    rs = np.random.RandomState(0)
    count = rs.randint(0, cap + 1, size=R).astype(np.int32)
    bcount = rs.randint(0, bcap + 1, size=R).astype(np.int32)
    p = rs.rand(R).astype(np.float32)
    q = rs.rand(R).astype(np.float32)
    count[:8], p[8:12], q[12:16], p[16:20], q[20:24] = cap, 1.0, 1.0, 0.0, 0.0
    bcount[24:28], count[28:32] = 0, 0
    keys = jax.random.split(jax.random.key(3), R)
    jsrc, jcount, jdrop = jax.vmap(
        lambda kk, c, b, pp, qq: jbank_mod._ttbs_key_map(kk, c, b, pp, qq, cap=cap,
                                                         bcap=bcap))(
        keys, jnp.asarray(count), jnp.asarray(bcount), jnp.asarray(p), jnp.asarray(q))
    def jax_draws(kk, c, b, pp, qq):
        k_ret, k_perm, k_acc, k_pick = jax.random.split(kk, 4)
        return (jrng.binomial(k_ret, c, pp), jrng.binomial(k_acc, b, qq),
                jax.random.bits(k_perm, (16, 2), jnp.uint32),
                jax.random.bits(k_pick, (16, 2), jnp.uint32))

    m, k, rbp, rbk = jax.vmap(jax_draws)(keys, jnp.asarray(count), jnp.asarray(bcount),
                                         jnp.asarray(p), jnp.asarray(q))
    draws = simple.TTBSDraws(m=t(m, torch.int64), k=t(k, torch.int64), rb_perm=t(rbp),
                             rb_pick=t(rbk))
    src, new_count, dropped = _ttbs_key_map(draws, torch.from_numpy(count).long(),
                                            torch.from_numpy(bcount).long(), cap=cap,
                                            bcap=bcap)
    assert src.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(new_count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
    assert (np.asarray(jdrop) > 0).any()      # some rows overflow the buffer


# ---------------------------------------------------------------------------
# a bank tick against the port's own standalone step, per key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay", ["lam", "per_key"])
def test_ttbs_bank_tick_equals_vmap_of_single(decay):
    """Exact on items, nfull, W and pending (the protocol of
    tests/test_bank.py's ttbs parity): each touched key's buffer after a
    bank tick equals the port's standalone ``simple.ttbs_step`` of that key
    alone (key ``fold_in(kt, k_id)``, p = its composed pending factor,
    q = clip(n (1 - d) / batch_size, 0, 1) in f32) over its routed
    sub-batch; untouched keys only decay their pending factor. ``per_key``
    steps through ``step_decayed`` with a [K] factor."""
    K, n, cap, bcap, b, T, lam, bs = 6, 4, 8, 4, 12, 6, 0.3, 2.0
    bank = make_bank("ttbs", num_keys=K, n=n, lam=lam, batch_size=bs, cap=cap,
                     bcap=bcap, device=CPU)
    st = bank.init(PROTO)
    key0 = prng.key(11)
    lazy_seen = overflow_seen = False
    for tt, (keys, pay) in enumerate(_stream(K, b, T, 4)):
        kt = prng.fold_in(key0, tt)
        keys_t, pay_t = torch.from_numpy(keys), {"x": torch.from_numpy(pay)}
        d = (bank.base_rate(st) if decay == "lam"
             else torch.linspace(0.55, 0.95, K, dtype=torch.float32))
        pend = st.pending * d
        q = _q32(n, d, bs).expand(K)
        r = route(keys_t, b, num_keys=K, bcap=bcap)
        sub = subbatches(r, pay_t, bcap=bcap)
        items, cnt, W = st.items["x"].clone(), st.nfull.clone(), st.total_weight.clone()
        ov = st.overflow.clone()
        for i in range(int(r.ntouched)):
            k_id = int(r.touched[i])
            bs_k = simple.BufferState(items=items[k_id].clone(),
                                      count=cnt[k_id].to(torch.int64),
                                      total_weight=W[k_id].clone(),
                                      overflow=torch.tensor(0))
            out = simple.ttbs_step(prng.fold_in(kt, k_id), bs_k, sub["x"][i],
                                   r.counts[i], p=pend[k_id], q=q[k_id])
            items[k_id], cnt[k_id], W[k_id] = out.items, out.count, out.total_weight
            ov[k_id] += out.overflow + r.dropped[i]
            pend[k_id] = 1.0
        lazy_seen = lazy_seen or bool((pend < 1.0).any())
        if decay == "lam":
            st = bank.step(kt, st, keys_t, pay_t, torch.tensor(b))
        else:
            st = bank.step_decayed(kt, st, keys_t, pay_t, torch.tensor(b), d)
        assert torch.equal(st.items["x"], items)
        assert torch.equal(st.nfull, cnt) and st.nfull.dtype == torch.int32
        assert torch.equal(st.weight, cnt.to(torch.float32))
        assert torch.equal(st.total_weight, W)
        assert torch.equal(st.pending, pend)
        assert torch.equal(st.overflow, ov)
        overflow_seen = overflow_seen or bool((ov > 0).any())
    assert lazy_seen and overflow_seen


def test_ttbs_tick_map_then_banked_pass_equals_step():
    """Exact: the tick up to its payload pass, then one banked pass (B3's
    plain version on the CPU) over every leaf, equals ``step`` on items and
    the [K] columns; the operands B3 and H2 are held on at full size."""
    K, n, cap, bcap, b, T, lam, bs = 16, 6, 24, 4, 24, 5, 0.2, 3.0
    bank = make_bank("ttbs", num_keys=K, n=n, lam=lam, batch_size=bs, cap=cap,
                     bcap=bcap, device=CPU)
    st = bank.init({"x": torch.zeros(2), "y": torch.zeros((), dtype=torch.int8)})
    for tt, (keys, pay) in enumerate(_stream(K, b, T, 5)):
        kt = prng.fold_in(prng.key(3), tt)
        keys_t = torch.from_numpy(keys)
        pay_t = {"x": torch.from_numpy(pay), "y": torch.arange(b, dtype=torch.int8) + 7 * tt}
        d = bank.base_rate(st)
        r, src, new_count, _, w_new, pending, (h2_keys, h2_count, h2_p) = _ttbs_tick_map(
            kt, st, keys_t, b, d, n=n, batch_size=bs, bcap=bcap)
        # H2's operands: m's b rows (the touched keys' buffer counts at their
        # composed retention), then k's (the routed counts at q)
        idx = torch.clamp(r.touched, max=K - 1)
        assert h2_keys.shape == (2 * b, 2)
        assert torch.equal(h2_count, torch.cat([st.nfull[idx].long(), r.counts.long()]))
        assert torch.equal(h2_p, torch.cat([pending[idx], _q32(n, d, bs).expand(b)]))
        assert torch.equal(pending, st.pending * d)
        items = {f: v.clone() for f, v in st.items.items()}
        ts_ops.tbs_step_apply_banked(items, pay_t, src, order=r.order, starts=r.starts,
                                     touched=r.touched, ntouched=r.ntouched, bcap=bcap)
        st = bank.step(kt, st, keys_t, pay_t, b)
        for f in items:
            assert torch.equal(st.items[f], items[f])
        nt = int(r.ntouched)
        ids = r.touched[:nt]
        assert torch.equal(st.nfull[ids], new_count[:nt].to(torch.int32))
        assert torch.equal(st.total_weight[ids], w_new[:nt])


# ---------------------------------------------------------------------------
# against JAX's jitted bank: the deterministic columns
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay", ["lam", "polynomial"])
def test_ttbs_bank_w_and_pending_equal_jax_jitted_bank(decay):
    """Exact on W and pending against JAX's jitted ttbs bank over 12 ticks
    of a Zipf keyed stream (both deterministic given the arrivals, DESIGN.md
    Sec. 11): the port rounds ``p_eff * W + B`` once, as XLA's fused
    multiply-add does; also under a polynomial schedule. nfull differs (the
    draws are Philox, not threefry) and stays within [0, cap]."""
    K, n, bcap, b, T, bs = 16, 6, 6, 40, 12, 3.0
    kw = {"lam": 0.3} if decay == "lam" else {}
    jkw = dict(kw)
    if decay == "polynomial":
        from repro.decay import polynomial as jpoly

        jkw["decay"], kw["decay"] = jpoly(0.8), polynomial(0.8)
    jbank = j_make_bank("ttbs", num_keys=K, n=n, batch_size=bs, bcap=bcap, **jkw)
    jstep = jax.jit(jbank.step)
    jst = jbank.init(JPROTO)
    bank = make_bank("ttbs", num_keys=K, n=n, batch_size=bs, bcap=bcap, device=CPU, **kw)
    st = bank.init(PROTO)
    rounded_once = 0
    for tt, (keys, pay) in enumerate(_stream(K, b, T, 9, zipf=True)):
        W_prev, p_prev = st.total_weight.numpy().copy(), st.pending.numpy().copy()
        d = float(bank.base_rate(st))
        jst = jstep(jax.random.fold_in(jax.random.key(1), tt), jst, jnp.asarray(keys),
                    jnp.asarray(pay), jnp.int32(b))
        st = bank.step(prng.fold_in(prng.key(1), tt), st, torch.from_numpy(keys),
                       {"x": torch.from_numpy(pay)}, b)
        np.testing.assert_array_equal(st.pending.numpy(), np.asarray(jst.pending))
        np.testing.assert_array_equal(st.total_weight.numpy(), np.asarray(jst.total_weight))
        assert ((st.nfull >= 0) & (st.nfull <= bank.cap)).all()
        # where one rounding and two differ, both banks took the one
        u, c = np.unique(keys, return_counts=True)
        pe = (p_prev * F32(d)).astype(np.float32)
        two = (pe[u] * W_prev[u]).astype(np.float32) + np.minimum(c, bcap).astype(np.float32)
        rounded_once += int((two != st.total_weight.numpy()[u]).sum())
    assert rounded_once > 0   # the case occurs in this stream


# ---------------------------------------------------------------------------
# per-key eq. (1)
# ---------------------------------------------------------------------------
def test_ttbs_bank_per_key_eq1_inclusion():
    """Tolerance 0.03 on inclusion probabilities over 4,000 trials. On a
    Zipf keyed stream each key's buffer keeps an item arriving at tick t
    with Pr = q e^{-lam (T-1-t)} in the view after tick T-1 (paper eq. (1),
    Alg. 1 per key), for a popular and a rare, irregular key. The trials
    are 4,000 copies of an 8-key stream side by side in one bank (copy j's
    keys shifted by 8 j): each key draws from its own folded key, so the
    copies are independent."""
    K0, b0, T, n, lam, bs, trials = 8, 16, 6, 6, 0.4, 4.0, 4000
    p = math.exp(-lam)
    q = float(_q32(n, torch.tensor(p, dtype=torch.float32), bs))
    rs = np.random.RandomState(5)
    keys0 = _zipf_keys(rs, K0, (T, b0))
    shift = (K0 * np.arange(trials, dtype=np.int64))[:, None]
    K = K0 * trials
    bank = make_bank("ttbs", num_keys=K, n=n, lam=lam, batch_size=bs, cap=8 * n,
                     bcap=b0, device=CPU)
    st = bank.init({"x": torch.zeros(())})
    for t in range(T):
        keys = torch.from_numpy((keys0[t][None, :] + shift).reshape(-1))
        pay = torch.full((trials * b0,), float(t + 1))
        st = bank.step(prng.fold_in(prng.key(2), t), st, keys, {"x": pay},
                       trials * b0)
    assert int(st.overflow.sum()) == 0
    arrivals = np.stack([(keys0 == k).sum(axis=1) for k in range(K0)])   # [K0, T]
    popular = int(np.argmax(arrivals.sum(1)))
    rare = [k for k in range(K0) if 0 < (arrivals[k] > 0).sum() < T]
    assert rare, arrivals
    for focal in (popular, rare[-1]):
        ids = focal + K0 * np.arange(trials)
        view = bank.extract(prng.key(777), st, ids)
        tick_of = view.items["x"].long()                    # [trials, cap]: t + 1
        kept = torch.zeros(trials, T + 1).scatter_add_(1, tick_of, view.mask.float())[:, 1:]
        assert torch.equal(view.size, view.mask.sum(-1))
        for t in range(T):
            if arrivals[focal, t] == 0:
                continue
            got = float(kept[:, t].mean()) / arrivals[focal, t]
            want = q * p ** (T - 1 - t)
            assert abs(got - want) < 0.03, (focal, t, got, want)


def test_ttbs_bank_extract_size_consistent_and_settles_pending():
    """Exact: ``size`` equals ``extract``'s mask sums for the same key; a
    key touched this tick (pending 1) keeps its whole valid prefix; a key
    with pending < 1 keeps a subset of it; device key ids give the same
    view as host ones."""
    K, n, bcap, b = 12, 5, 6, 30
    bank = make_bank("ttbs", num_keys=K, n=n, lam=0.3, batch_size=3.0, bcap=bcap,
                     device=CPU)
    st = bank.init(PROTO)
    for tt, (keys, pay) in enumerate(_stream(K, b, 4, 2)):
        st = bank.step(prng.key(tt), st, torch.from_numpy(keys), {"x": torch.from_numpy(pay)}, b)
    last = set(_stream(K, b, 4, 2)[-1][0].tolist())
    ids = list(range(K))
    view = bank.extract(prng.key(9), st, ids)
    assert torch.equal(bank.size(prng.key(9), st, ids), view.mask.sum(-1))
    v2 = bank.extract(prng.key(9), st, torch.arange(K))
    assert torch.equal(v2.mask, view.mask)
    valid = torch.arange(bank.cap) < st.nfull.unsqueeze(-1)
    assert not (view.mask & ~valid).any()
    for k in range(K):
        if k in last:
            assert torch.equal(view.mask[k], valid[k])
    with pytest.raises(ValueError, match="key_ids"):
        bank.size(prng.key(0), st, [K])


def test_make_ttbs_bank_hyper_and_defaults():
    bank = make_bank("ttbs", num_keys=4, n=3, lam=0.1, batch_size=2.0, device=CPU)
    assert bank.cap == 12 and bank.bcap == 64 and bank.scheme == "ttbs"
    assert "SamplerBank(ttbs, K=4" in repr(bank)
    assert bank.hyper["batch_size"] == 2.0 and bank.hyper["lam"] == 0.1
    st = bank.init(PROTO)
    assert st.items["x"].shape == (4, 12, 2) and st.nfull.dtype == torch.int32


# ---------------------------------------------------------------------------
# the bank loop with a controller
# ---------------------------------------------------------------------------
def _keyed_stream(K=32, T=12, b=24):
    return materialize_stream(KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.2,
                                          flip_every=6),
                              T, batch_size=b, fields=("key", "x", "y"), device=CPU)


BANKS = {"rtbs": dict(n=10), "ttbs": dict(n=10, batch_size=2.0, bcap=8)}


@pytest.mark.parametrize("scheme", sorted(BANKS))
@pytest.mark.parametrize("per_key", [False, True])
def test_bank_loop_with_controller_equals_ticks_by_hand(scheme, per_key):
    """The twin of tests/test_bank.py's per-key farm with a controller, for
    both bank schemes and both regimes. Exact: the run equals its tick by
    hand (state, params, controller state, every trace column); the trace's
    "decay" is the controllers' rate before each tick ([Q] per key); per
    key, a key outside the train keys that never arrives decays by the
    schedule's base rate alone, and each train key's pending factor is the
    product of its controller's rates since its last touch. The per-key
    metric is NaN exactly on ticks the key did not arrive."""
    K, Q = 64, 4
    batches, bcounts = _keyed_stream(K=K)
    bank = make_bank(scheme, num_keys=K, lam=0.1, device=CPU,
                     **{"bcap": 8, **BANKS[scheme]})
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0, warmup=1)
    run = make_bank_run_loop(bank, model, retrain_every=3, train_keys=range(Q),
                             per_key=per_key, controller=ctrl)
    state, params, trace = run(prng.key(0), batches, bcounts)
    T = bcounts.shape[0]
    assert trace["metric"].shape == ((T, Q) if per_key else (T,))
    assert trace["decay"].shape == ((T, Q) if per_key else (T,))

    tick = make_bank_manage_step(bank, model, retrain_every=3, train_keys=range(Q),
                                 per_key=per_key, controller=ctrl)
    st = bank.init({"x": torch.zeros(2), "y": torch.zeros(())})
    p, c = model.init(), ctrl.init(CPU)
    if per_key:
        p, c = (pytree.tree_map(lambda a: a.expand((Q,) + a.shape).clone(), x) for x in (p, c))
    keys_h = batches["key"].numpy()
    pend = np.ones(K, np.float32)
    base = np.float32(math.exp(-0.1))
    ms = []
    for t in range(T):
        d = ctrl.rate(c)
        st, p, c, m = tick(prng.key(0), t, st, p, c, {f: v[t] for f, v in batches.items()},
                           bcounts[t])
        assert torch.equal(m["decay"], d)
        d_full = np.full(K, base, np.float32)
        if per_key:
            d_full[:Q] = d.numpy()
        else:
            d_full[:] = d.numpy()
        pend = (pend * d_full).astype(np.float32)
        pend[np.unique(keys_h[t, : int(bcounts[t])])] = 1.0
        np.testing.assert_array_equal(st.pending.numpy(), pend)
        ms.append(m)
    for a, b in zip(pytree.tree_leaves((state, params)), pytree.tree_leaves((st, p))):
        assert torch.equal(a, b)
    for k in trace:
        assert _bits_equal(trace[k], torch.stack([m[k] for m in ms])), k
    if per_key:
        arrive = np.stack([(keys_h == q).any(axis=1) for q in range(Q)], axis=1)
        np.testing.assert_array_equal(np.isfinite(trace["metric"].numpy()), arrive)
        never = np.setdiff1d(np.arange(Q, K), np.unique(keys_h))
        assert never.size and (st.pending.numpy()[never] == pend[never]).all()
    assert (trace["decay"] != trace["decay"][0]).any()   # the controller moved
