"""The port's loop layer against the JAX package: the stream copy, the model
adapters, the decay schedules, the Sampler API, and the manage loop."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import decay as jdecay
from repro.core.api import SampleView as JView
from repro.core.api import make_sampler as j_make_sampler
from repro.data import streams as jstreams
from repro.manage import make_model as j_make_model
from repro.manage import make_run_loop as j_make_run_loop
from repro.manage import materialize_stream as j_materialize
from repro_torch import convert
from repro_torch import decay as tdecay
from repro_torch.core import prng
from repro_torch.core.api import SampleView as TView
from repro_torch.core.api import make_sampler
from repro_torch.data import streams as tstreams
from repro_torch.manage import (make_manage_step, make_model, make_run_loop,
                                materialize_stream)

CPU = "cpu"


@pytest.mark.parametrize("seed", [0, 3])
def test_streams_equal_jax_package(seed):
    for name, kw, args in [("GMMStream", {}, (5, 40, 1)),
                           ("LinRegStream", {}, (2, 64, 0)),
                           ("LinRegStream", {}, (7, 33, 1)),
                           ("UsenetLikeStream", {"vocab": 50}, (3, 20, 0)),
                           ("TokenDriftStream", {"seq_len": 8}, (1, 6, 1))]:
        a = getattr(jstreams, name)(seed=seed, **kw).batch(*args)
        b = getattr(tstreams, name)(seed=seed, **kw).batch(*args)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ka = jstreams.KeyedStream(jstreams.LinRegStream(seed), 9, seed=seed).batch(4, 30)
    kb = tstreams.KeyedStream(tstreams.LinRegStream(seed), 9, seed=seed).batch(4, 30)
    for x, y in zip(ka, kb):
        np.testing.assert_array_equal(x, y)
    for t in range(30):
        assert jstreams.mode_schedule("periodic", t) == tstreams.mode_schedule("periodic", t)
        for kind in ("constant", "growing", "uniform", "decaying"):
            assert (jstreams.batch_size_schedule(kind, t, t0=5, seed=seed)
                    == tstreams.batch_size_schedule(kind, t, t0=5, seed=seed))


def _view(rs, cap, fields):
    mask = rs.rand(cap) < 0.7
    items = {k: f(rs) for k, f in fields.items()}
    jv = JView(items={k: jnp.asarray(v) for k, v in items.items()},
               mask=jnp.asarray(mask), size=jnp.int32(mask.sum()))
    tv = TView(items={k: torch.from_numpy(v) for k, v in items.items()},
               mask=torch.from_numpy(mask), size=torch.tensor(int(mask.sum())))
    return jv, tv


def _batch(rs, n, fields, valid):
    b = {k: f(rs) for k, f in fields.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(valid),
            {k: torch.from_numpy(v) for k, v in b.items()}, torch.tensor(valid))


def _leaves(p):
    """Params leaves in one order for both packages (dicts by sorted key)."""
    if isinstance(p, dict):
        return [p[k] for k in sorted(p)]
    return list(p) if isinstance(p, tuple) else [p]


# f32 sums in another order than XLA's: 1e-4 relative on fitted params and
# metrics (the linreg normal equations are 3x3 and well conditioned here)
RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("model,hyper,fields", [
    ("linreg", {"dim": 2}, {"x": lambda rs: rs.rand(300, 2).astype(np.float32),
                            "y": lambda rs: rs.randn(300).astype(np.float32)}),
    ("naive_bayes", {"vocab": 20},
     {"x": lambda rs: rs.poisson(2.0, (300, 20)).astype(np.float32),
      "y": lambda rs: rs.randint(0, 2, 300).astype(np.int32)}),
    ("knn", {"cap": 300, "dim": 2, "num_classes": 5},
     {"x": lambda rs: (rs.rand(300, 2) * 10).astype(np.float32),
      "y": lambda rs: rs.randint(0, 5, 300).astype(np.int32)}),
])
def test_adapters_fit_and_evaluate_close_to_jax(model, hyper, fields):
    rs = np.random.RandomState(0)
    jm, tm = j_make_model(model, **hyper), make_model(model, device=CPU, **hyper)
    jv, tv = _view(rs, 300, fields)
    jp = jm.fit(jax.random.key(0), jm.init(), jv)
    tp = tm.fit(prng.key(0), tm.init(), tv)
    for a, b in zip(_leaves(jp), _leaves(tp)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=RTOL, atol=ATOL)
    # evaluate the JAX params carried across, and the port's own fit
    carried = convert.params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    for valid in (250, 0):
        jb, jc, tb, tc = _batch(rs, 250, fields, valid)
        want = float(jm.evaluate(jp, jb, jc))
        for params in (carried, tp):
            got = float(tm.evaluate(params, tb, tc))
            if valid == 0:
                assert math.isnan(want) and math.isnan(got)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decay_profiles_equal_jax():
    for jsched, tsched in [
        (jdecay.exponential(0.3), tdecay.exponential(0.3)),
        (jdecay.piecewise((3, 7), (0.1, 0.5, 0.05)),
         tdecay.piecewise((3, 7), (0.1, 0.5, 0.05))),
        (jdecay.polynomial(0.8), tdecay.polynomial(0.8)),
    ]:
        want = np.asarray(jdecay.decay_profile(jsched, 12))
        got = tdecay.decay_profile(tsched, 12, device=CPU).numpy()
        if jsched.name == "polynomial":   # pow may round one ulp apart
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tdecay.resolve(None, None)
    with pytest.raises(TypeError):
        tdecay.resolve(None, 0.5)


def _stream(T=11, bs=16, device=CPU, seed=0):
    return materialize_stream(tstreams.LinRegStream(seed=seed), T, batch_size=bs,
                              device=device)


def test_lam_sugar_equals_exponential_schedule():
    batches, bcounts = _stream()
    model = make_model("linreg", device=CPU)
    outs = []
    for sampler in (make_sampler("rtbs", n=40, lam=0.15, device=CPU),
                    make_sampler("rtbs", n=40, decay=tdecay.exponential(0.15),
                                 device=CPU)):
        outs.append(make_run_loop(sampler, model, retrain_every=4)(
            prng.key(3), batches, bcounts))
    for a, b in zip(torch.utils._pytree.tree_leaves(outs[0]),
                    torch.utils._pytree.tree_leaves(outs[1])):
        assert torch.equal(a, b)


def test_time_varying_schedule_wraps_state():
    batches, bcounts = _stream(T=6)
    sampler = make_sampler("rtbs", n=40, decay=tdecay.polynomial(0.5), device=CPU)
    st, _, trace = make_run_loop(sampler, make_model("linreg", device=CPU))(
        prng.key(0), batches, bcounts)
    assert float(st.dstate) == 6.0 and int(trace["size"][-1]) <= 40


def test_run_loop_bit_identical_to_manage_step():
    batches, bcounts = _stream()
    sampler = make_sampler("rtbs", n=40, lam=0.15, device=CPU)
    model = make_model("linreg", device=CPU)
    key = prng.key(3)
    outs = [make_run_loop(sampler, model, retrain_every=4, superbatch=sb)(
        key, batches, bcounts) for sb in (None, 4)]
    tick = make_manage_step(sampler, model, retrain_every=4)
    from repro_torch.manage import item_proto

    state, params = sampler.init(item_proto(batches)), model.init()
    ms = []
    for t in range(bcounts.shape[0]):
        state, params, m = tick(key, t, state, params,
                                {k: v[t] for k, v in batches.items()}, bcounts[t])
        ms.append(m)
    by_hand = (state, params, {k: torch.stack([m[k] for m in ms]) for k in ms[0]})
    for out in outs:
        for a, b in zip(torch.utils._pytree.tree_leaves(out),
                        torch.utils._pytree.tree_leaves(by_hand)):
            assert torch.equal(a, b)


def test_loop_matches_jax_when_sample_is_whole_stream():
    """lam = 0 and n above the stream's total: the sample is the whole
    stream in both packages, so sizes are equal and metrics close."""
    T = 10
    jb, jc = j_materialize(jstreams.LinRegStream(seed=0), T,
                           batch_size=lambda t: 5 + t)
    tb, tc = materialize_stream(tstreams.LinRegStream(seed=0), T,
                                batch_size=lambda t: 5 + t, device=CPU)
    _, jp, jtr = j_make_run_loop(j_make_sampler("rtbs", n=200, lam=0.0),
                                 j_make_model("linreg"), retrain_every=2)(
        jax.random.key(0), jb, jc)
    _, tp, ttr = make_run_loop(make_sampler("rtbs", n=200, lam=0.0, device=CPU),
                               make_model("linreg", device=CPU), retrain_every=2)(
        prng.key(0), tb, tc)
    np.testing.assert_array_equal(ttr["size"].numpy(), np.asarray(jtr["size"]))
    np.testing.assert_allclose(ttr["metric"].numpy(), np.asarray(jtr["metric"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)


def test_naive_bayes_loop_and_extract():
    batches, bcounts = materialize_stream(tstreams.UsenetLikeStream(vocab=30), 6,
                                          batch_size=20, device=CPU)
    sampler = make_sampler("rtbs", n=50, lam=0.1, device=CPU)
    model = make_model("naive_bayes", vocab=30, device=CPU)
    st, params, trace = make_run_loop(sampler, model, retrain_every=2)(
        prng.key(1), batches, bcounts)
    assert torch.isfinite(trace["metric"]).all() and int(trace["size"].max()) <= 50
    view = sampler.extract(prng.key(2), st)
    assert int(view.mask.sum()) == int(view.size) == int(sampler.size(prng.key(2), st))


def test_unported_options_raise():
    with pytest.raises(ValueError, match="unknown"):
        make_sampler("nope", device=CPU)
    sampler = make_sampler("rtbs", n=4, lam=0.1, device=CPU)
    model = make_model("linreg", device=CPU)
    ctrl = tdecay.loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0)
    for scheme in ("brs", "sw"):
        with pytest.raises(ValueError, match="no decay"):
            make_run_loop(make_sampler(scheme, n=4, device=CPU), model, controller=ctrl)
    with pytest.raises(TypeError, match="Telemetry"):
        make_run_loop(sampler, model, telemetry=object())
    # a real handle runs, and drains one record a tick
    from repro_torch.obs import MemorySink, Telemetry
    mem = MemorySink()
    batches, bcounts = materialize_stream(tstreams.LinRegStream(), 3, batch_size=5, device=CPU)
    make_run_loop(sampler, model, telemetry=Telemetry([mem], every=2))(prng.key(0), batches,
                                                                      bcounts)
    assert [r["t"] for r in mem.by_kind("tick")] == [0, 1, 2]
