"""The port's closed-loop adaptive decay against the JAX package's
``repro.decay.adaptive`` and ``repro.manage.loop``:

  * the loss-ratio controller fed the same losses (NaNs, a shift, the
    cooldown, the relax) as JAX's jitted one: ``seen``, ``hold`` and the
    pulse ticks exact, ``fast`` and ``slow`` bit for bit, ``loglam`` and
    the rate within the counted ulp gaps of XLA:CPU's ``log`` and ``exp``
    (ROADMAP C.11);
  * ``Sampler.step_decayed`` on every scheme;
  * the controlled loop: per-tick driving equals the run bit for bit, the
    farm equals the stacked single runs bit for bit, and the twin of
    tests/test_decay.py's single-shift criterion through the port's farm.

Each test states its tolerance; "exact" means bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.decay import adaptive as jada
from repro_torch import decay as tdecay
from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import GMMStream, LinRegStream
from repro_torch.decay import adaptive as tada
from repro_torch.manage import (item_proto, make_manage_step, make_model, make_run_farm,
                                make_run_loop, materialize_stream, run_farm)

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


def _ulps(a, b) -> np.ndarray:
    """|a - b| in f32 ulps (same-sign finite values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _losses():
    """A fed loss sequence: stationary noise, a 30x shift held 60 ticks (a
    pulse, its cooldown, a second pulse once the refractory window ends and
    the relax back down), a fall, and NaNs (empty ticks) throughout."""
    rs = np.random.RandomState(0)
    T = 400
    loss = (0.1 * np.abs(rs.randn(T)) + 1.0).astype(np.float32)
    loss[120:180] *= 30.0
    loss[260:300] *= 0.05
    loss[rs.rand(T) < 0.06] = np.nan
    adjust = np.arange(T) % 3 == 2
    return loss, adjust


# the controller's float fields against JAX's jitted observe on _losses():
# (hyper, ticks whose loglam differs, its largest ulp gap, ticks whose rate
# differs from one loglam, that rate's largest ulp gap); measured with
# torch 2.13.0+cpu and jax 0.9.0. The port rounds each exp and log once
# from f64; XLA:CPU's f32 exp does not always round to nearest
# (ROADMAP C.7, C.11)
ULP_CASES = [
    (dict(lam0=0.1, lam_min=0.01, lam_max=1.0), 0, 0, 6, 1),
    (dict(lam0=0.03, lam_min=0.003, lam_max=0.5, warmup=1, cooldown=4, relax=0.1),
     0, 0, 24, 1),
    (dict(lam0=0.2, lam_min=0.05, lam_max=0.8, fast_alpha=0.3, slow_alpha=0.07,
          gain_down=0.7, deadband=0.02), 0, 0, 12, 1),
]


@pytest.mark.parametrize("hyper,n_loglam,max_loglam,n_rate,max_rate", ULP_CASES)
def test_controller_equals_jax_jitted_on_fed_losses(hyper, n_loglam, max_loglam,
                                                    n_rate, max_rate):
    """Exact on seen, hold, the pulse ticks, fast and slow (the jitted EMA is
    one FMA, which the port rounds as XLA does); loglam and the rate
    exp(-exp(loglam)) within the counted ulp gaps asserted here exactly.
    Each tick starts both packages from JAX's state, so a gap never
    carries into the next tick; a free run from init also keeps every
    integer field and pulse tick equal."""
    loss, adjust = _losses()
    jc, tc = jada.loss_ratio(**hyper), tada.loss_ratio(**hyper)
    jobs, jrate = jax.jit(jc.observe), jax.jit(jc.rate)
    cj = jc.init()
    ct_free = tc.init(CPU)
    diff = {"loglam": [], "rate": []}
    pulses = []
    for i in range(loss.shape[0]):
        ct = tada.ControllerState(*(torch.from_numpy(np.array(getattr(cj, f)))
                                    for f in ("loglam", "fast", "slow", "seen", "hold")))
        rj, rt = np.float32(jrate(cj)), tc.rate(ct).numpy()
        diff["rate"].append(int(_ulps(rj, rt)))
        cj = jobs(cj, jnp.float32(loss[i]), jnp.bool_(adjust[i]))
        ct = tc.observe(ct, torch.tensor(loss[i]), bool(adjust[i]))
        ct_free = tc.observe(ct_free, torch.tensor(loss[i]), bool(adjust[i]))
        for f in ("fast", "slow"):
            assert np.float32(getattr(cj, f)).tobytes() == getattr(ct, f).numpy().tobytes(), (i, f)
        if n_loglam == 0:       # then the free run's loglam is JAX's too
            assert np.float32(cj.loglam).tobytes() == ct_free.loglam.numpy().tobytes(), i
        for f in ("seen", "hold"):
            assert int(getattr(cj, f)) == int(getattr(ct, f)) == int(getattr(ct_free, f)), (i, f)
        diff["loglam"].append(int(_ulps(np.float32(cj.loglam), ct.loglam.numpy())))
        assert bool(tc.stats(ct)["pulse"]) == bool(jc.stats(cj)["pulse"]), i
        if bool(jc.stats(cj)["pulse"]):
            pulses.append(i)
    got = (sum(d > 0 for d in diff["loglam"]), max(diff["loglam"]),
           sum(d > 0 for d in diff["rate"]), max(diff["rate"]))
    assert got == (n_loglam, max_loglam, n_rate, max_rate), got
    assert any(120 <= i < 130 for i in pulses), pulses


def test_controller_pulses_relaxes_and_ignores_nan():
    """The JAX package's behavioural test of the controller
    (tests/test_decay.py), on the port: rel 1e-5 on lambda, exact on hold
    and seen."""
    ctrl = tada.loss_ratio(lam0=0.1, lam_min=0.05, lam_max=0.8, warmup=1)
    c = ctrl.init(CPU)
    for _ in range(10):
        c = ctrl.observe(c, torch.tensor(1.0), torch.tensor(True))
    assert float(c.lam) == pytest.approx(0.05, rel=1e-5)
    c = ctrl.observe(c, torch.tensor(100.0), torch.tensor(True))
    assert float(c.lam) == pytest.approx(0.8, rel=1e-5)
    assert int(c.hold) == 8 and bool(ctrl.stats(c)["pulse"])
    for _ in range(60):
        c = ctrl.observe(c, torch.tensor(100.0), True)
    assert float(c.lam) == pytest.approx(0.05, rel=1e-5)
    c_nan = ctrl.observe(c, torch.tensor(float("nan")), True)
    assert float(c_nan.loglam) == float(c.loglam) and int(c_nan.seen) == int(c.seen)
    c2 = ctrl.observe(c, torch.tensor(500.0), False)
    assert float(c2.loglam) == float(c.loglam) and float(c2.fast) != float(c.fast)
    # a device bool and a host bool give the same state
    c3 = ctrl.observe(c, torch.tensor(500.0), torch.tensor(False))
    for a, b in zip(pytree.tree_leaves(c2), pytree.tree_leaves(c3)):
        assert torch.equal(a, b)


def test_controller_takes_a_leading_dimension():
    """Exact: a state with [Q] fields is Q controllers, each equal to its
    own 0-d run (the bank loop's per-key form)."""
    ctrl = tada.loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0, warmup=1)
    loss, adjust = _losses()
    Q = 3
    c = pytree.tree_map(lambda a: a.expand(Q).clone(), ctrl.init(CPU))
    singles = [ctrl.init(CPU) for _ in range(Q)]
    for i in range(120, 200):
        row = torch.from_numpy(loss[i:i + Q].copy())
        c = ctrl.observe(c, row, bool(adjust[i]))
        singles = [ctrl.observe(s, row[q], bool(adjust[i])) for q, s in enumerate(singles)]
    for q, s in enumerate(singles):
        for a, b in zip(pytree.tree_leaves(c), pytree.tree_leaves(s)):
            assert torch.equal(a[q], b)
    assert torch.equal(ctrl.rate(c), torch.stack([ctrl.rate(s) for s in singles]))


def test_adaptive_validation():
    """The JAX package's validation errors (tests/test_decay.py)."""
    with pytest.raises(ValueError, match="lam_min <= lam0 <= lam_max"):
        tada.loss_ratio(lam0=0.5, lam_min=0.01, lam_max=0.1)
    with pytest.raises(ValueError, match="slow_alpha <= fast_alpha"):
        tada.loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0, fast_alpha=0.1,
                        slow_alpha=0.5)
    assert tdecay.loss_ratio is tada.loss_ratio
    assert "loss_ratio(lam0=0.1" in repr(tada.loss_ratio(lam0=0.1, lam_min=0.01,
                                                         lam_max=1.0))


# ---------------------------------------------------------------------------
# Sampler.step_decayed
# ---------------------------------------------------------------------------
SCHEMES = {"rtbs": dict(n=40), "ttbs": dict(n=40, batch_size=16.0, cap=200),
           "btbs": dict(cap=200)}


def _stream(T=12, bs=16, flip=None, seed=0):
    mode = 0 if flip is None else (lambda t: 0 if t < flip else 1)
    return materialize_stream(LinRegStream(seed=seed), T, batch_size=bs, mode=mode,
                              device=CPU)


def _equal_trees(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("scheme,decay", [("rtbs", "lam"), ("btbs", "lam"),
                                          ("rtbs", "polynomial"), ("ttbs", "polynomial"),
                                          ("btbs", "polynomial")])
def test_step_decayed_with_the_schedules_factor_equals_step(scheme, decay):
    """Exact: ``step_decayed`` fed the factor the schedule would apply gives
    ``step``'s state (T-TBS only under a time-varying schedule: at a
    constant rate its ``step`` applies the f64-derived q, as JAX's does);
    under a time-varying schedule the schedule's state still advances."""
    kw = {"lam": 0.2} if decay == "lam" else {"decay": tdecay.polynomial(0.8)}
    s = make_sampler(scheme, device=CPU, **SCHEMES[scheme], **kw)
    batches, bcounts = _stream()
    sched = s.hyper["decay"]
    a = b = s.init(item_proto(batches))
    ds = sched.init(CPU)
    for t in range(6):
        bt = {f: v[t] for f, v in batches.items()}
        d, ds = sched.tick(ds)
        a = s.step(prng.key(t), a, bt, bcounts[t])
        b = s.step_decayed(prng.key(t), b, bt, bcounts[t], d)
    _equal_trees(a, b)


def test_step_decayed_is_none_on_the_decay_free_schemes():
    for scheme in ("brs", "sw"):
        assert make_sampler(scheme, n=8, device=CPU).step_decayed is None
    for scheme, hyper in SCHEMES.items():
        assert make_sampler(scheme, lam=0.1, device=CPU, **hyper).step_decayed is not None


def test_controller_rejects_decay_free_schemes():
    """As JAX's ``_check_controllable``: ValueError, "no decay"."""
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = tada.loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0)
    for scheme in ("brs", "sw"):
        for build in (make_run_loop, make_manage_step, make_run_farm):
            with pytest.raises(ValueError, match="no decay"):
                build(make_sampler(scheme, n=8, device=CPU), model, controller=ctrl)


# ---------------------------------------------------------------------------
# the controlled loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_controlled_run_equals_ticks_by_hand(scheme):
    """Exact: the controlled loop equals its tick driven by hand (state,
    params, controller state and every trace column, "decay" included),
    and the trace's factor is exp(-exp(loglam)) of the controller's
    state before each tick."""
    s = make_sampler(scheme, lam=0.05, device=CPU, **SCHEMES[scheme])
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = tada.loss_ratio(lam0=0.05, lam_min=0.005, lam_max=0.5)
    batches, bcounts = _stream(T=16, flip=8)
    key = prng.key(5)
    out = make_run_loop(s, model, retrain_every=2, controller=ctrl)(key, batches, bcounts)
    tick = make_manage_step(s, model, retrain_every=2, controller=ctrl)
    state, params, c = s.init(item_proto(batches)), model.init(), ctrl.init(CPU)
    ms = []
    for t in range(bcounts.shape[0]):
        d = ctrl.rate(c)
        state, params, c, m = tick(key, t, state, params, c,
                                   {f: v[t] for f, v in batches.items()}, bcounts[t])
        assert torch.equal(m["decay"], d)
        ms.append(m)
    _equal_trees(out, (state, params, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}))
    assert set(out[2]) == {"metric", "size", "decay"}
    lam = -torch.log(out[2]["decay"])
    assert float(lam.max()) > 0.4       # the flip at tick 8 fired a pulse


FARMS = [("rtbs", dict(n=30, lam=0.2), None), ("rtbs", dict(n=30, lam=0.2), 0.2),
         ("ttbs", dict(n=30, lam=0.2, batch_size=20.0, cap=120), 0.2),
         ("btbs", dict(lam=0.2, cap=120), None), ("brs", dict(n=30), None),
         ("sw", dict(n=30), None),
         ("rtbs", dict(n=30, decay=tdecay.polynomial(0.8)), 0.2)]


@pytest.mark.parametrize("scheme,hyper,lam0", FARMS)
def test_farm_equals_stacked_single_runs(scheme, hyper, lam0):
    """Exact: ``farm(key, trials, ...)``, whose trials are a leading
    dimension of the sampler's and the controller's state, is
    ``run(split(key, trials)[i])`` stacked, for every scheme, with and
    without a controller and under a time-varying schedule; trials
    differ."""
    s = make_sampler(scheme, device=CPU, **hyper)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = _stream(T=8, bs=20, flip=4, seed=4)
    ctrl = None if lam0 is None else tada.loss_ratio(lam0=lam0, lam_min=0.02, lam_max=1.0,
                                                     warmup=1)
    trials = 8
    trace = make_run_farm(s, model, retrain_every=2, controller=ctrl)(
        prng.key(5), trials, batches, bcounts)
    run = make_run_loop(s, model, retrain_every=2, controller=ctrl)
    singles = [run(k, batches, bcounts)[2] for k in prng.split(prng.key(5), trials)]
    assert trace["metric"].shape == (trials, 8) and set(trace) == set(singles[0])
    for k in trace:
        assert torch.equal(trace[k], torch.stack([tr[k] for tr in singles])), k
    if scheme != "sw":
        assert len(set(trace["metric"][:, -1].tolist())) > 1
    one = run_farm(prng.key(5), trials, s, model, batches, bcounts, retrain_every=2,
                   controller=ctrl)
    _equal_trees(one, trace)


def test_adaptive_beats_best_static_lambda_on_single_shift():
    """The twin of tests/test_decay.py's convergence criterion through the
    port's farm, with its grid, trials and assertions: on the single-shift
    kNN/GMM stream the controller's post-shift prequential miss rate is
    below every static lambda's, lambda pulses past 0.4 in the 10 ticks
    after the shift, ends below 0.05 on average and sits below 0.01 on
    average in the 5 ticks before the shift."""
    warm, T, b, n, trials, skip = 30, 40, 50, 400, 8, 3
    grid = (0.005, 0.05, 0.2, 0.5)
    batches, bcounts = materialize_stream(
        GMMStream(seed=0, ratio=25), warm + T, batch_size=b,
        mode=lambda t: 0 if t < warm else 1, device=CPU)
    model = make_model("knn", cap=n + 1, dim=2, k=7, num_classes=100, device=CPU)

    def post_shift_miss(controller, lam):
        sampler = make_sampler("rtbs", n=n, lam=lam, device=CPU)
        farm = make_run_farm(sampler, model, retrain_every=1, controller=controller)
        trace = farm(prng.key(11), trials, batches, bcounts)
        return float(trace["metric"][:, warm + skip:].mean()), trace

    static = {lam: post_shift_miss(None, lam)[0] for lam in grid}
    ctrl = tada.loss_ratio(lam0=0.05, lam_min=0.005, lam_max=0.5)
    adaptive, trace = post_shift_miss(ctrl, 0.05)
    assert adaptive < min(static.values()), (adaptive, static)
    lam_path = -np.log(np.maximum(trace["decay"].numpy(), 1e-30))
    assert lam_path[:, warm:warm + 10].max() > 0.4, lam_path[:, warm:].max()
    assert lam_path[:, -1].mean() < 0.05, lam_path[:, -1]
    assert lam_path[:, warm - 5:warm].mean() < 0.01
