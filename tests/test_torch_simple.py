"""The paper's other schemes (``repro_torch.core.simple``: T-TBS, B-TBS,
B-RS, SW), their Sampler registrations and the argsort reference step
``rtbs.step_ref`` against the JAX package.

Each tick's evaluation, fed the JAX step's own draws (its permutation
bits, its hypergeometric uniform, its binomial results), is bit-equal to
the JAX step: items of every leaf dtype of ``tests/test_torch_tbs_step.py``
(the dead tail past ``count`` included), count, overflow and W. The JAX
tests' statistical checks are re-run on the port's own draws through its
trial dimension, with their trial counts and tolerances."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import id_stream, ref_draws, son_bits, uniform
from repro.core import rng as jrng
from repro.core import rtbs as jrt
from repro.core import simple as js
from repro.core.api import make_sampler as j_make_sampler
from repro.data import streams as jstreams
from repro.manage import make_model as j_make_model
from repro.manage import make_run_loop as j_make_run_loop
from repro.manage import materialize_stream as j_materialize
from repro_torch.core import prng
from repro_torch.core import rtbs as tr
from repro_torch.core import simple as ts
from repro_torch.core.api import available_schemes, make_sampler
from repro_torch.data import streams as tstreams
from repro_torch.decay import exponential, polynomial
from repro_torch.manage import make_model, make_run_loop, materialize_stream

CPU = "cpu"
F32 = np.float32
RTOL, ATOL = 1e-4, 1e-5          # tests/test_torch_manage.py's, for f32 fits


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
# payload leaves of every dtype B1's tests move
# --------------------------------------------------------------------------
def _leaves(ids: np.ndarray) -> dict:
    """numpy leaves from int32 item ids: f32 [., 2], int32, bf16 (held as
    f32 here), int8 and bool."""
    return {"x": np.stack([ids, -ids], -1).astype(F32), "i": ids.astype(np.int32),
            "h": ids.astype(F32) / 8, "b": (ids % 127).astype(np.int8),
            "m": ids % 3 == 0}


def _jax_tree(leaves: dict) -> dict:
    return {k: jnp.asarray(v, jnp.bfloat16) if k == "h" else jnp.asarray(v)
            for k, v in leaves.items()}


def _torch_tree(leaves: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) if k == "h"
            else torch.from_numpy(np.array(v)) for k, v in leaves.items()}


def _proto_pair():
    lv = _leaves(np.zeros((), np.int32))
    jproto = {k: jax.ShapeDtypeStruct(np.shape(v), jnp.bfloat16 if k == "h" else
                                      jnp.asarray(v).dtype) for k, v in lv.items()}
    return jproto, _torch_tree(lv)


def _assert_state_equal(tst: ts.BufferState, jst, what: str):
    for k, a in tst.items.items():
        b = np.asarray(jst.items[k].astype(jnp.float32) if k == "h" else jst.items[k])
        np.testing.assert_array_equal(a.float().numpy() if k == "h" else a.numpy(), b,
                                      err_msg=f"{what}: items[{k}]")
    assert int(tst.count) == int(jst.count), what
    assert int(tst.overflow) == int(jst.overflow), what
    assert tst.total_weight.dtype == torch.float32
    assert tst.total_weight.numpy().tobytes() == np.asarray(jst.total_weight).tobytes(), what


def _stream(sizes, bcap):
    ids, _ = id_stream(sizes, bcap)
    return ids


def _run_pair(sizes, bcap, cap, jstep, tstep, seed=0):
    """Step the JAX scheme and the port's evaluation tick by tick over one
    id stream; ``tstep(key_t, jstate, tstate, batch, bcount)`` makes the
    port's tick from the JAX key and state."""
    ids = _stream(sizes, bcap)
    jproto, tproto = _proto_pair()
    jst, tst = js.init(jproto, cap), ts.init(tproto, cap)
    for t_, b in enumerate(sizes):
        key = jax.random.fold_in(jax.random.key(seed), t_)
        lv = _leaves(ids[t_])
        jnew = jstep(key, jst, _jax_tree(lv), jnp.int32(b))
        tst = tstep(key, jst, tst, _torch_tree(lv), torch.tensor(b))
        jst = jnew
        _assert_state_equal(tst, jst, f"tick {t_}")
    return jst, tst


# --------------------------------------------------------------------------
# each scheme's tick, fed the JAX step's draws, bit for bit
# --------------------------------------------------------------------------
SIZES = [8, 3, 0, 8, 5, 8, 8, 1, 7, 8, 8, 2, 6, 8, 8, 8, 0, 4, 8, 8,
         8, 6, 8, 3, 8, 8, 7, 8, 8, 5]


def _ttbs_draws(key, jst, bcount, p, q):
    """The JAX T-TBS tick's draws, its binomial results included."""
    k_ret, k_perm, k_acc, k_pick = jax.random.split(key, 4)
    m = jrng.binomial(k_ret, jst.count, jnp.float32(p))
    k = jrng.binomial(k_acc, bcount, jnp.float32(q))
    return ts.TTBSDraws(m=torch.tensor(int(m)), k=torch.tensor(int(k)),
                        rb_perm=son_bits(k_perm), rb_pick=son_bits(k_pick))


@pytest.mark.parametrize("lam,n,cap", [(0.3, 12, 64), (0.3, 14, 10)])
def test_ttbs_step_equals_jax(lam, n, cap):
    """T-TBS over 30 ticks; the second case overflows its 10 slots."""
    p = F32(math.exp(-lam))
    q = F32(n * (1 - math.exp(-lam)) / 8)

    def jstep(key, st, b, c):
        return js.ttbs_step(key, st, b, c, p=jnp.float32(p), q=jnp.float32(q))

    def tstep(key, jst, st, b, c):
        return ts.ttbs_step_with(_ttbs_draws(key, jst, jnp.int32(c), p, q), st, b, c,
                                 p=torch.tensor(p))

    jst, _ = _run_pair(SIZES, 8, cap, jstep, tstep)
    if cap == 10:
        assert int(jst.overflow) > 0


def test_btbs_step_equals_jax():
    """B-TBS (q = 1) over 30 ticks into 24 slots: overflows."""
    p = F32(math.exp(-0.2))

    def jstep(key, st, b, c):
        return js.btbs_step(key, st, b, c, p=jnp.float32(p))

    def tstep(key, jst, st, b, c):
        return ts.ttbs_step_with(_ttbs_draws(key, jst, jnp.int32(c), p, 1.0), st, b, c,
                                 p=torch.tensor(p))

    jst, _ = _run_pair(SIZES, 8, 24, jstep, tstep)
    assert int(jst.overflow) > 0


@pytest.mark.parametrize("n,cap,bcap", [(10, 10, 8), (6, 8, 8), (5, 5, 12)])
def test_brs_step_equals_jax(n, cap, bcap):
    """B-RS over 30 ticks, fed JAX's hypergeometric uniform and
    permutation bits; batches larger than n included."""
    sizes = [min(s * bcap // 8, bcap) for s in SIZES]

    def jstep(key, st, b, c):
        return js.brs_step(key, st, b, c, n=n)

    def tstep(key, jst, st, b, c):
        k_hg, k_perm, k_pick = jax.random.split(key, 3)
        draws = ts.BRSDraws(u_hg=uniform(k_hg), rb_perm=son_bits(k_perm),
                            rb_pick=son_bits(k_pick))
        return ts.brs_step_with(draws, st, b, c, n=n)

    _run_pair(sizes, bcap, cap, jstep, tstep)


@pytest.mark.parametrize("n,cap,bcap", [(5, 8, 4), (10, 10, 8), (3, 3, 8)])
def test_sw_step_equals_jax(n, cap, bcap):
    """SW is deterministic: the port's step against JAX's directly."""
    sizes = [min(s * bcap // 8, bcap) for s in SIZES]

    def jstep(key, st, b, c):
        return js.sw_step(key, st, b, c, n=n)

    def tstep(key, jst, st, b, c):
        return ts.sw_step(prng.key(0), st, b, c, n=n)

    _run_pair(sizes, bcap, cap, jstep, tstep)


STREAMS = [
    ([12, 0, 0, 3, 9, 1, 5, 7, 16, 2, 0, 8], 0.07, 8),
    ([4, 4, 4, 4, 4, 4, 4, 4], 0.3, 8),
    ([6, 6, 0, 0, 0, 0, 6, 2], 0.8, 8),       # heavy decay, undershoots
    ([16, 16, 16, 16, 16, 16], 0.1, 24),      # saturates, stays saturated
]


@pytest.mark.parametrize("sizes,lam,n", STREAMS)
def test_step_ref_equals_jax(sizes, lam, n):
    """The argsort reference step fed JAX's argsort draws: items, nfull, C
    and W bit for bit on streams that visit every Alg. 2 branch."""
    bcap = 16
    ids, _ = id_stream(sizes, bcap)
    d = F32(math.exp(-lam))
    jst = jrt.init(jax.ShapeDtypeStruct((), jnp.int32), n)
    tst = tr.init(torch.zeros((), dtype=torch.int32), n)
    for t_, b in enumerate(sizes):
        key = jax.random.fold_in(jax.random.key(3), t_)
        jst = jrt.step_ref(key, jst, jnp.asarray(ids[t_]), jnp.int32(b), n=n,
                           decay=jnp.float32(d))
        tst = tr.step_ref_with(ref_draws(key, n + 1, bcap), tst, torch.from_numpy(ids[t_]),
                               torch.tensor(b), n=n, decay=torch.tensor(d))
        np.testing.assert_array_equal(tst.lat.items.numpy(), np.asarray(jst.lat.items))
        assert int(tst.lat.nfull) == int(jst.lat.nfull)
        assert tst.lat.weight.numpy().tobytes() == np.asarray(jst.lat.weight).tobytes()
        assert tst.total_weight.numpy().tobytes() == np.asarray(jst.total_weight).tobytes()


def test_run_stream_use_ref_keeps_the_fused_trajectory():
    """``run_stream(use_ref=True)`` steps the reference: the same C_t as
    the fused step (DESIGN.md Sec. 11), another RNG stream. W_t agrees to 1
    ulp: the reference rounds a saturated tick's d W + B once, as XLA
    rounds the jitted JAX reference's, and the fused step twice, as JAX's."""
    sizes = [12, 0, 3, 9, 16, 16, 2, 8, 16, 16]
    ids, bc = id_stream(sizes, 16)
    st0 = tr.init(torch.zeros((), dtype=torch.int32), 24)
    _, a = tr.run_stream(prng.key(1), st0, torch.from_numpy(ids), torch.from_numpy(bc),
                         n=24, lam=0.2)
    _, b = tr.run_stream(prng.key(1), st0, torch.from_numpy(ids), torch.from_numpy(bc),
                         n=24, lam=0.2, use_ref=True)
    assert torch.equal(a["C"], b["C"])
    ulp = torch.from_numpy(np.spacing(a["W"].numpy()))
    assert ((a["W"] - b["W"]).abs() <= ulp).all()


# --------------------------------------------------------------------------
# the Sampler registrations
# --------------------------------------------------------------------------
LOCAL = {
    "rtbs": dict(n=10, lam=0.3),
    "ttbs": dict(n=10, lam=0.3, batch_size=8),
    "btbs": dict(lam=0.3, cap=64),
    "brs": dict(n=10),
    "sw": dict(n=10),
}


def _ids(T=6, bcap=16, b=8):
    batches = np.zeros((T, bcap), np.int32)
    for i in range(T):
        batches[i, :b] = 1000 * (i + 1) + np.arange(b)
    return torch.from_numpy(batches), torch.full((T,), b)


def test_registry_and_refusals():
    assert set(available_schemes()) == set(LOCAL) | {"drtbs", "dttbs"}
    assert make_sampler("drtbs", n=4, lam=0.1, cap_s=8, device=CPU).distributed
    assert make_sampler("dttbs", n=4, lam=0.1, batch_size=4.0, device=CPU).distributed
    assert not any(make_sampler(s, **LOCAL[s], device=CPU).distributed for s in LOCAL)
    with pytest.raises(ValueError, match="q ="):
        make_sampler("ttbs", n=100, lam=0.5, batch_size=8, device=CPU)
    s = make_sampler("ttbs", **LOCAL["ttbs"], device=CPU)
    assert s.hyper["cap"] == 40
    assert s.hyper["q"] == 10 * (1 - math.exp(-0.3)) / 8
    assert s.hyper["p"] == math.exp(-0.3)


@pytest.mark.parametrize("scheme", sorted(LOCAL))
def test_extract_mask_sum_equals_size_local(scheme):
    """``tests/test_api.py``'s twin: an item counted in the size is
    materialized in the view, for every realization key."""
    s = make_sampler(scheme, **LOCAL[scheme], device=CPU)
    batches, bcounts = _ids()
    state = s.init(torch.zeros((), dtype=torch.int32))
    for i in range(batches.shape[0]):
        state = s.step(prng.fold_in(prng.key(5), i), state, batches[i], bcounts[i])
    for k in range(10):
        view = s.extract(prng.key(100 + k), state)
        assert int(view.mask.sum()) == int(view.size)
        assert int(s.size(prng.key(100 + k), state)) == int(view.size)


def test_bounded_schemes_respect_n():
    """``tests/test_api.py``'s twin."""
    for scheme in ("rtbs", "brs", "sw"):
        s = make_sampler(scheme, **LOCAL[scheme], device=CPU)
        batches, bcounts = _ids(T=8, bcap=32, b=30)
        state = s.init(torch.zeros((), dtype=torch.int32))
        for i in range(8):
            state = s.step(prng.fold_in(prng.key(1), i), state, batches[i], bcounts[i])
        view = s.extract(prng.key(2), state)
        assert int(view.size) <= s.hyper["n"], scheme


@pytest.mark.parametrize("scheme", ["rtbs", "ttbs", "btbs"])
def test_lam_is_exponential_decay(scheme):
    """``make_sampler(..., lam=)`` is bit-equal to
    ``decay=exponential(lam)`` (brs and sw take no decay)."""
    hyper = dict(LOCAL[scheme])
    lam = hyper.pop("lam")
    a = make_sampler(scheme, lam=lam, **hyper, device=CPU)
    b = make_sampler(scheme, decay=exponential(lam), **hyper, device=CPU)
    batches, bcounts = _ids(T=10)
    sa = a.init(torch.zeros((), dtype=torch.int32))
    sb = b.init(torch.zeros((), dtype=torch.int32))
    for i in range(10):
        key = prng.fold_in(prng.key(9), i)
        sa = a.step(key, sa, batches[i], bcounts[i])
        sb = b.step(key, sb, batches[i], bcounts[i])
    la, lb = torch.utils._pytree.tree_leaves(sa), torch.utils._pytree.tree_leaves(sb)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_time_varying_ttbs_threads_its_schedule():
    """A polynomial schedule: p_t from the schedule, q_t clipped into
    [0, 1] (its first ticks ask for q > 1); W_t bit-equal to the JAX
    sampler's (W never depends on the draws)."""
    from repro import decay as jdecay

    n, bs, T = 10, 8.0, 12
    a = make_sampler("ttbs", n=n, batch_size=bs, decay=polynomial(0.8), device=CPU)
    jsmp = j_make_sampler("ttbs", n=n, batch_size=bs, decay=jdecay.polynomial(0.8))
    batches, bcounts = _ids(T=T)
    st = a.init(torch.zeros((), dtype=torch.int32))
    jst_ = jsmp.init(jax.ShapeDtypeStruct((), jnp.int32))
    for i in range(T):
        st = a.step(prng.fold_in(prng.key(4), i), st, batches[i], bcounts[i])
        jst_ = jsmp.step(jax.random.fold_in(jax.random.key(4), i), jst_,
                         jnp.asarray(batches[i].numpy()), jnp.int32(8))
        assert (st.inner.total_weight.numpy().tobytes()
                == np.asarray(jst_.inner.total_weight).tobytes())
        assert 0 <= int(st.inner.count) <= 40 and int(st.inner.overflow) == 0


# --------------------------------------------------------------------------
# the JAX tests' statistical checks, through the port's trial dimension
# --------------------------------------------------------------------------
def _trials(trials: int, cap: int) -> ts.BufferState:
    z = torch.zeros(trials, dtype=torch.int64)
    return ts.BufferState(items=torch.zeros(trials, cap, dtype=torch.int32), count=z,
                          total_weight=torch.zeros(trials), overflow=z.clone())


def test_ttbs_mean_size_theorem_3_1_ii():
    """E[C_t] = n + p^t (C_0 - n): 4,000 trials, within 0.35."""
    n, lam, b = 12, 0.3, 8
    p = math.exp(-lam)
    q = n * (1 - p) / b
    T, trials, bcap, cap = 30, 4000, 8, 64
    st = _trials(trials, cap)
    batch = torch.ones(bcap, dtype=torch.int32)
    keys = prng.split(prng.key(11), T)
    csizes = []
    for i in range(T):
        st = ts.ttbs_step(keys[i], st, batch, torch.tensor(b), p=F32(p), q=F32(q))
        csizes.append(st.count.double())
    assert int(st.overflow.sum()) == 0
    for i in (4, 9, 19, 29):
        expect = n + (p ** (i + 1)) * (0 - n)
        assert abs(float(csizes[i].mean()) - expect) < 0.35, i


def test_ttbs_eq1_inclusion():
    """Pr[x in S_t'] = q e^{-lam (t' - t)}: 30,000 trials, within 0.015."""
    n, lam, b = 6, 0.4, 10
    p = math.exp(-lam)
    q = n * (1 - p) / b
    T, trials, bcap, cap = 6, 30000, 10, 64
    ids, _ = id_stream([b] * T, bcap)
    st = _trials(trials, cap)
    keys = prng.split(prng.key(12), T)
    for i in range(T):
        st = ts.ttbs_step(keys[i], st, torch.from_numpy(ids[i]), torch.tensor(b),
                          p=F32(p), q=F32(q))
    mask, _ = ts.realize_all(st)
    batch_of = (st.items // 1000).long()
    counts = torch.zeros(trials, T + 1).scatter_add_(1, batch_of, mask.float())[:, 1:]
    probs = counts.mean(0).numpy() / b
    for j in range(T):
        expect = q * math.exp(-lam * (T - 1 - j))
        assert abs(probs[j] - expect) < 0.015, j


def test_brs_uniform_inclusion():
    """Every item equally likely, n / total: 30,000 trials, within 0.02."""
    n = 6
    sizes = [4, 7, 2, 9, 3]
    total = sum(sizes)
    T, bcap, cap = len(sizes), max(sizes), 8
    ids, _ = id_stream(sizes, bcap)
    st = _trials(30000, cap)
    keys = prng.split(prng.key(13), T)
    for i, b in enumerate(sizes):
        st = ts.brs_step(keys[i], st, torch.from_numpy(ids[i]), torch.tensor(b), n=n)
    assert (st.count == n).all()
    mask, _ = ts.realize_all(st)
    batch_of = (st.items // 1000).long()
    counts = torch.zeros(30000, T + 1).scatter_add_(1, batch_of, mask.float())[:, 1:]
    probs = counts.mean(0).numpy() / np.asarray(sizes)
    np.testing.assert_allclose(probs, n / total, atol=0.02)


def test_sliding_window_exact():
    n, bcap, cap = 5, 4, 8
    sizes = [3, 4, 2, 4]
    batches = np.zeros((len(sizes), bcap), np.int32)
    order, nid = [], 1
    for i, b in enumerate(sizes):
        for j in range(b):
            batches[i, j] = nid
            order.append(nid)
            nid += 1
    st = ts.init(torch.zeros((), dtype=torch.int32), cap)
    for i, b in enumerate(sizes):
        st = ts.sw_step(prng.key(i), st, torch.from_numpy(batches[i]), torch.tensor(b), n=n)
    assert st.items[: int(st.count)].tolist() == order[-n:]     # arrival order, too


# --------------------------------------------------------------------------
# the whole loop on the CPU
# --------------------------------------------------------------------------
SCHEMES = {"ttbs": dict(n=60, lam=0.1, batch_size=24, cap=240),
           "btbs": dict(lam=0.1, cap=240), "brs": dict(n=60), "sw": dict(n=60)}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_run_loop_linreg(scheme):
    """``make_run_loop`` on ``LinRegStream`` with each scheme: finite
    metrics; W_t = p W_{t-1} + B_t exactly (ttbs, btbs) or the items seen
    (brs, sw); brs and sw hold min(n, seen) items, sw the newest of them in
    arrival order; sw, deterministic, equals the JAX package's loop."""
    T = 16
    sizes = [24 if t_ < 8 else 9 for t_ in range(T)]
    batches, bcounts = materialize_stream(tstreams.LinRegStream(seed=2), T,
                                          batch_size=lambda t_: sizes[t_], bcap=24,
                                          device=CPU)
    sampler = make_sampler(scheme, **SCHEMES[scheme], device=CPU)
    model = make_model("linreg", device=CPU)
    st, params, trace = make_run_loop(sampler, model, retrain_every=4)(
        prng.key(3), batches, bcounts)
    assert torch.isfinite(trace["metric"]).all() and torch.isfinite(params).all()
    seen = np.cumsum(sizes)
    if scheme in ("brs", "sw"):
        assert trace["size"].tolist() == np.minimum(60, seen).tolist()
        assert float(st.total_weight) == float(seen[-1])
    else:
        p, w = F32(math.exp(-0.1)), F32(0)
        for b in sizes:              # p W + B rounded once (tests above)
            w = F32(float(p) * float(w) + b)
        assert st.total_weight.numpy().tobytes() == np.asarray(w).tobytes()
        assert int(st.overflow) == 0
    if scheme == "sw":
        rows = torch.cat([batches["x"][t_, :sizes[t_]] for t_ in range(T)])[-60:]
        assert torch.equal(st.items["x"][:60], rows)
        jb, jc = j_materialize(jstreams.LinRegStream(seed=2), T,
                               batch_size=lambda t_: sizes[t_], bcap=24)
        jst, jp, jtr = j_make_run_loop(j_make_sampler("sw", n=60), j_make_model("linreg"),
                                       retrain_every=4)(jax.random.key(3), jb, jc)
        np.testing.assert_array_equal(trace["size"].numpy(), np.asarray(jtr["size"]))
        np.testing.assert_array_equal(st.items["x"].numpy(), np.asarray(jst.items["x"]))
        np.testing.assert_allclose(trace["metric"].numpy(), np.asarray(jtr["metric"]),
                                   rtol=RTOL, atol=ATOL)
