"""The port's LM training path against the JAX package on the CPU:
``models.zoo.loss_fn`` / ``ModelAPI.loss`` and its gradients,
``train.steps.make_train_step`` (microbatched), ``manage.make_sgd_adapter``
(``fit`` fed JAX's row indices, ``evaluate``, ``row_loss``), B5's backward
(``kernels.ssd_scan.ops.ssd_scan_backward`` and the autograd Function that
calls it), and the driver ``repro_torch.launch.train`` (twins of
``tests/test_system.py``'s driver tests; the resume twin is bit for bit),
also on granite_moe_3b (MoE) and zamba2_2p7b (hybrid), the other families
JAX's driver trains on tokens alone. Every model runs under ``cfg.remat``,
JAX's default, in both packages.

Every model is a smoke config in float32 whose parameters JAX draws and
``convert.lm_params_from_numpy`` carries across; tokens are seeded numpy
draws fed to both. Tolerances: loss 1e-5 relative, gradients 1e-5 (absolute
and relative; f32 sums over a few layers in two BLAS libraries' orders);
train steps and fits 2e-5 on losses and 1e-4 on params (the same sums
through AdamW's sqrt(v) normalisation, whose first step moves each element
by +-lr). B5's backward equals autograd through the plain form bit for bit
(one computation) and JAX's gradient of its jnp ``ssd_chunked`` within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import config as jconfig
from repro.core.api import SampleView as JView
from repro.manage import make_sgd_adapter as j_make_sgd_adapter
from repro.models import ssm as jS
from repro.models import zoo as jzoo
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch import config as tconfig
from repro_torch import convert
from repro_torch.core.api import SampleView as TView
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.core import prng
from repro_torch.manage import draw_rows, make_sgd_adapter, rows_from_uniforms
from repro_torch.models import zoo as tzoo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step

CPU = "cpu"
ARCHS = ["stablelm_12b", "mamba2_370m", "granite_moe_3b", "zamba2_2p7b"]
# gradients against JAX's: 1e-5, but the hybrid's at tests/test_torch_hybrid.py's
# 1e-4 (its embedding gradient sums the shared block's invocations and its
# Mamba2 layers in two libraries' orders: up to 8.6e-5 apart on leaves of ~1)
GRAD_TOL = {"zamba2_2p7b": 1e-4}
B, S = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed=0):
    """Seeded noise on the Mamba2 leaves JAX initializes to constants (the
    hybrid keeps its Mamba2 layers under ``"mamba"``)."""
    layers = tree.get("blocks", tree.get("mamba"))
    if "ssm" not in layers:
        return tree
    rng = np.random.default_rng(seed)
    ssm = layers["ssm"]
    for k, scale in {"A_log": 0.5, "dt_bias": 0.5, "D": 0.3, "norm_scale": 0.2,
                     "conv_b": 0.2}.items():
        a = np.asarray(ssm[k])
        ssm[k] = (a + rng.standard_normal(a.shape) * scale).astype(a.dtype)
    return tree


def _models(arch):
    jcfg = dataclasses.replace(jconfig.get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfig.get_smoke_config(arch), dtype="float32")
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    tree = _perturb(jax.tree_util.tree_map(np.asarray, japi.init_params(jax.random.key(0))))
    return japi, tree, tapi


def _jp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tp(tcfg, tree):
    return convert.lm_params_from_numpy(tcfg, tree, device=CPU)


def _tokens(cfg, rows=B, seq=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (rows, seq), dtype=np.int32)


def _close_tree(tparams, jtree, tol):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jtree))
    got = jax.tree_util.tree_leaves(convert.lm_params_to_numpy(tparams))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, masked):
    japi, tree, tapi = _models(arch)
    toks = _tokens(japi.cfg)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if masked:
        m = np.random.default_rng(1).random((B, S)) < 0.6
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(m), torch.from_numpy(m)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(_jp(tree), jb)
    tparams = _tp(tapi.cfg, tree)
    leaves, spec = pytree.tree_flatten(tparams)
    live = [p.requires_grad_(True) for p in leaves]
    tl = tapi.loss(pytree.tree_unflatten(live, spec), tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, live)
    _close_tree(pytree.tree_unflatten(list(grads), spec), jg, GRAD_TOL.get(arch, 1e-5))


def test_loss_fn_drops_a_frontend_prefix():
    """Logits past a prefix of extra positions are dropped, as in JAX."""
    V = 11
    logits = torch.randn(2, 7, V, generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, V, (2, 5), generator=torch.Generator().manual_seed(1))
    got = tzoo.loss_fn(None, lambda p, b: logits, None, {"tokens": toks})
    want = jzoo.loss_fn(None, lambda p, b: jnp.asarray(logits.numpy()), None,
                        {"tokens": jnp.asarray(toks.numpy())})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_over_three_steps(arch, microbatches):
    japi, tree, tapi = _models(arch)
    kw = dict(microbatches=microbatches, total_steps=40, warmup=1)
    jstep = jax.jit(j_make_train_step(japi, JAdamWConfig(lr=1e-3), **kw))
    tstep = make_train_step(tapi, AdamWConfig(lr=1e-3), **kw)
    jparams, tparams = _jp(tree), _tp(tapi.cfg, tree)
    jopt, topt = j_adamw_init(jparams), adamw_init(tparams)
    for k in range(3):
        toks = _tokens(japi.cfg, seed=10 + k)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        tparams, topt, tm = tstep(tparams, topt, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
        assert int(topt["count"]) == int(jopt["count"]) == k + 1
        _close_tree(tparams, jparams, 1e-4)
        _close_tree(topt["m"], jopt["m"], 1e-4)


def test_microbatched_step_equals_summed_gradients():
    """Inside the port: two microbatches give the mean of the two halves'
    gradients accumulated in f32, in order (JAX's scan), which differs from
    the one-batch step only by the sums' order (1e-6)."""
    _, tree, tapi = _models("mamba2_370m")
    toks = torch.from_numpy(_tokens(tapi.cfg, rows=4, seed=3))
    p = _tp(tapi.cfg, tree)
    one = make_train_step(tapi, AdamWConfig(lr=1e-3), microbatches=1, warmup=1)
    two = make_train_step(tapi, AdamWConfig(lr=1e-3), microbatches=2, warmup=1)
    clone = lambda: pytree.tree_map(torch.clone, p)     # the step updates in place
    p1, p2 = clone(), clone()
    _, _, m1 = one(p1, adamw_init(p1), {"tokens": toks})
    _, _, m2 = two(p2, adamw_init(p2), {"tokens": toks})
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the SGD adapter
# ---------------------------------------------------------------------------
def _adapters(arch, *, tb=3, steps=2, row_loss=False):
    japi, tree, tapi = _models(arch)
    common = dict(batch_field="tokens", train_batch=tb, retrain_steps=steps)
    jrl = trl = None
    if row_loss:
        def jrl(p, b):
            logits = japi.forward(p, b)[:, :-1].astype(jnp.float32)
            lab = b["tokens"][:, 1:]
            nll = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
                logits, lab[..., None], -1)[..., 0]
            return nll.mean(-1)

        def trl(p, b):
            logits = tapi.forward(p, b)[:, :-1].float()
            lab = b["tokens"][:, 1:].long()
            nll = torch.logsumexp(logits, -1) - torch.take_along_dim(
                logits, lab[..., None], -1)[..., 0]
            return nll.mean(-1)
    ja = j_make_sgd_adapter(
        init_params=lambda: _jp(tree),
        train_step=jax.jit(j_make_train_step(japi, JAdamWConfig(lr=1e-3), warmup=1,
                                             total_steps=40)),
        init_opt_state=j_adamw_init, loss=japi.loss, row_loss=jrl, **common)
    ta = make_sgd_adapter(
        init_params=lambda: _tp(tapi.cfg, tree),
        train_step=make_train_step(tapi, AdamWConfig(lr=1e-3), warmup=1, total_steps=40),
        init_opt_state=adamw_init, loss=tapi.loss, row_loss=trl, device=CPU, **common)
    return japi, ja, ta


def _view(cfg, cap=12, seed=0):
    items = _tokens(cfg, rows=cap, seed=seed)
    mask = np.random.default_rng(seed + 1).random(cap) < 0.5
    mask[0] = True
    return (JView(items=jnp.asarray(items), mask=jnp.asarray(mask),
                  size=jnp.int32(mask.sum())),
            TView(items=torch.from_numpy(items), mask=torch.from_numpy(mask),
                  size=torch.tensor(int(mask.sum()))))


def _jax_rows(key, view, steps, tb):
    """The rows JAX's ``fit`` draws: each step splits its key, then
    ``jax.random.choice`` over the mask's probabilities; also the uniforms
    that choice draws."""
    m = view.mask.astype(jnp.float32)
    probs = m / jnp.maximum(m.sum(), 1.0)
    rows, us = [], []
    for _ in range(steps):
        key, k_sel = jax.random.split(key)
        rows.append(np.asarray(jax.random.choice(k_sel, probs.shape[0], shape=(tb,), p=probs)))
        us.append(np.asarray(jax.random.uniform(k_sel, (tb,), dtype=jnp.float32)))
    return np.stack(rows), np.stack(us)


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_fit_on_jax_rows_matches_jax(arch):
    japi, ja, ta = _adapters(arch)
    jv, tv = _view(japi.cfg)
    key = jax.random.key(5)
    rows, _ = _jax_rows(key, jv, 2, 3)
    assert jv.mask[rows].all()                      # only sampled rows are drawn
    jst = jax.jit(ja.fit)(key, ja.init(), jv)
    tst = ta.fit(None, ta.init(), tv, rows=torch.from_numpy(rows))
    _close_tree(tst["params"], jst["params"], 1e-4)
    assert int(tst["opt"]["count"]) == int(jst["opt"]["count"]) == 2
    toks = _tokens(japi.cfg, seed=7)
    np.testing.assert_allclose(float(ta.evaluate(tst, torch.from_numpy(toks), B)),
                               float(ja.evaluate(jst, jnp.asarray(toks), B)), rtol=2e-5)


def test_sgd_rows_from_jax_uniforms_are_jax_rows():
    """Exact: the port's choice formula given JAX's uniforms picks JAX's rows."""
    japi, _, _ = _adapters("mamba2_370m")
    for seed in range(3):
        jv, tv = _view(japi.cfg, cap=40, seed=seed)
        rows, us = _jax_rows(jax.random.key(seed), jv, 4, 16)
        got = rows_from_uniforms(torch.from_numpy(us), tv.mask)
        np.testing.assert_array_equal(got.numpy(), rows)


def test_sgd_fit_draws_from_the_mask_and_guards_an_empty_sample():
    _, _, ta = _adapters("mamba2_370m", tb=8, steps=3)
    st = ta.init()
    _, tv = _view(tconfig.get_smoke_config("mamba2_370m"), cap=16)
    rows = draw_rows(prng.key(3), tv.mask, 3, 8)
    assert rows.shape == (3, 8) and tv.mask[rows].all()
    assert torch.equal(rows, draw_rows(prng.key(3), tv.mask, 3, 8))
    empty = TView(items=tv.items, mask=torch.zeros_like(tv.mask), size=torch.tensor(0))
    assert ta.fit(prng.key(0), st, empty) is st


def test_sgd_row_loss_masks_padding():
    """``row_loss``: evaluate is the bcount prefix mean of per-row losses,
    so padded rows cannot move it (twin of tests/test_api.py's)."""
    japi, ja, ta = _adapters("mamba2_370m", row_loss=True)
    toks = _tokens(japi.cfg, rows=6, seed=2)
    junk = toks.copy()
    junk[4:] = 0
    st, jst = ta.init(), ja.init()
    a = ta.evaluate(st, torch.from_numpy(toks), torch.tensor(4))
    b = ta.evaluate(st, torch.from_numpy(junk), torch.tensor(4))
    assert float(a) == float(b)
    np.testing.assert_allclose(float(a), float(ja.evaluate(jst, jnp.asarray(toks), jnp.int32(4))),
                               rtol=1e-5)
    assert torch.isnan(ta.evaluate(st, torch.from_numpy(toks), torch.tensor(0)))


# ---------------------------------------------------------------------------
# B5's backward
# ---------------------------------------------------------------------------
def _ssd_inputs(G=1, init=False, seed=0, Bsz=2, S_=16, H=4, P=8, N=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(Bsz, S_, H, P, generator=g)
    dt = torch.rand(Bsz, S_, H, generator=g) * 0.5 + 0.05
    a = -(torch.rand(H, generator=g) + 0.2)
    Bm = torch.randn(Bsz, S_, G, N, generator=g)
    Cm = torch.randn(Bsz, S_, G, N, generator=g)
    st = torch.randn(Bsz, H, N, P, generator=g) if init else None
    return x, dt, a, Bm, Cm, st


@pytest.mark.parametrize("G,init,with_state", [(1, False, False), (2, False, True),
                                               (1, True, True), (2, True, False)])
def test_ssd_scan_backward_equals_autograd_of_the_plain_form(G, init, with_state):
    ins = _ssd_inputs(G, init)
    Q = 8
    g = torch.Generator().manual_seed(9)
    gy = torch.randn(ins[0].shape, generator=g)
    gs = torch.randn(2, 4, 8, 8, generator=g) if with_state else None
    got = ssd_ops.ssd_scan_backward(*ins, Q, gy, gs)
    live = [None if t is None else t.clone().requires_grad_(True) for t in ins]
    y, st = ssd_ref.ssd_chunked_ref(*live[:5], chunk=Q, init_state=live[5])
    outs, cots = [y], [gy]
    if gs is not None:
        outs.append(st)
        cots.append(gs)
    want = torch.autograd.grad(outs, [t for t in live if t is not None], cots)
    got = [t for t in got if t is not None]
    assert len(got) == len(want) == (6 if init else 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and JAX's gradient of its model's jnp ssd_chunked, within 1e-5
    cfg = dataclasses.replace(jconfig.get_smoke_config("mamba2_370m"), ssm_chunk=Q)
    jin = [None if t is None else jnp.asarray(t.numpy()) for t in ins]

    def f(x, dt, a, Bm, Cm, st):
        y, fs = jS.ssd_chunked(cfg, x, dt, a, Bm, Cm, init_state=st)
        out = jnp.sum(y * jnp.asarray(gy.numpy()))
        return out + (jnp.sum(fs * jnp.asarray(gs.numpy())) if gs is not None else 0.0)

    argn = tuple(range(6 if init else 5))
    jg = jax.grad(f, argnums=argn)(*jin)
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_ssd_scan_backward_stays_finite_where_jax_overflows():
    """At a chunk whose decay spans more than e^88 (mamba2_370m's chunk of
    256 at init: A = -1, dt ~ 0.7), the upper triangle's exp(cl_i - cl_j)
    overflows: JAX's gradient of its jnp ``ssd_chunked`` is NaN there
    (ROADMAP C.13), while the port masks the exponent first. Its forward
    equals JAX's (1e-5) and its f32 gradient equals the same function's in
    f64, where nothing overflows (1e-4 relative to each gradient's max)."""
    Q = 64
    g = torch.Generator().manual_seed(4)
    x, Bm, Cm = (torch.randn(1, Q, 2, 8, generator=g), torch.randn(1, Q, 1, 8, generator=g),
                 torch.randn(1, Q, 1, 8, generator=g))
    dt = torch.full((1, Q, 2), 2.0)
    a = -torch.ones(2)
    gy = torch.randn(x.shape, generator=g)
    got = ssd_ops.ssd_scan_backward(x, dt, a, Bm, Cm, None, Q, gy, None)
    want = ssd_ops.ssd_scan_backward(*(t.double() for t in (x, dt, a, Bm, Cm)), None, Q,
                                     gy.double(), None)
    for u, v in zip(got[:5], want[:5]):
        assert torch.isfinite(u).all()
        np.testing.assert_allclose(u.numpy(), v.float().numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()))
    cfg = dataclasses.replace(jconfig.get_smoke_config("mamba2_370m"), ssm_chunk=Q)
    jin = [jnp.asarray(t.numpy()) for t in (x, dt, a, Bm, Cm)]
    jy, _ = jS.ssd_chunked(cfg, *jin)
    ty, _ = ssd_ref.ssd_chunked_ref(x, dt, a, Bm, Cm, chunk=Q)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    jg = jax.grad(lambda *a_: jnp.sum(jS.ssd_chunked(cfg, *a_)[0] * jnp.asarray(gy.numpy())),
                  argnums=(0, 1, 2, 3, 4))(*jin)
    nan = [bool(np.isnan(np.asarray(v)).any()) for v in jg]
    assert nan == [False, True, True, True, True]     # x's gradient never meets the inf


def test_ssd_scan_autograd_function_routes_the_backward(monkeypatch):
    """The CUDA route's autograd Function, driven on the CPU with its launch
    replaced by the kernel's plain version: the gradients that reach x, dt,
    a, B and C are :func:`ssd_scan_backward`'s, an unused final state passes
    no cotangent (None), and only the forward counts as a launch."""
    def fake_launch(x, dt, a, Bm, Cm, init_state, Q, which):
        ssd_ops.ssd_scan.launches += 1
        return ssd_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q, init_state=init_state)

    monkeypatch.setattr(ssd_ops, "_launch", fake_launch)
    ins = _ssd_inputs(2)
    live = [t.clone().requires_grad_(True) for t in ins[:5]]
    n0 = ssd_ops.ssd_scan.launches
    y, _ = ssd_ops._SSDScan.apply(*live, None, 8, "cuda_core")
    assert ssd_ops.ssd_scan.launches == n0 + 1
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(y, live, gy)
    assert ssd_ops.ssd_scan.launches == n0 + 1
    want = ssd_ops.ssd_scan_backward(*ins, 8, gy, None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the driver (twins of tests/test_system.py)
# ---------------------------------------------------------------------------
def test_driver_runs_and_adapts():
    """The full loop (stream -> R-TBS -> periodic retraining) runs on the
    CPU and the retrained model improves on the stream it samples from."""
    from repro_torch.launch.train import main

    log = main([
        "--arch", "mamba2_370m", "--preset", "smoke", "--ticks", "12",
        "--batch-per-tick", "24", "--reservoir", "96", "--retrain-every", "3",
        "--retrain-steps", "6", "--train-batch", "8", "--drift", "none",
        "--seq-len", "32",
    ], device=CPU)
    assert len(log) == 12
    first, last = log[0]["eval_loss"], log[-1]["eval_loss"]
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (first, last)
    # W_t = d W_(t-1) + |B_t| in f32, two roundings, on every tick
    d = np.float32(np.exp(-0.07))
    w = np.float32(0.0)
    for r in log:
        w = np.float32(np.float32(d * w) + np.float32(24))
        assert r["total_weight"] == float(w)
        assert r["sample_size"] <= 96


@pytest.mark.parametrize("arch", ["granite_moe_3b", "zamba2_2p7b"])
def test_driver_runs_and_adapts_on_the_zoo(arch):
    """The twin of :func:`test_driver_runs_and_adapts` on the MoE and hybrid
    smoke configs: eval finite and falling, W exact on every tick, |S|
    within --reservoir."""
    from repro_torch.launch.train import main

    log = main([
        "--arch", arch, "--preset", "smoke", "--ticks", "12",
        "--batch-per-tick", "24", "--reservoir", "96", "--retrain-every", "3",
        "--retrain-steps", "6", "--train-batch", "8", "--drift", "none",
        "--seq-len", "32",
    ], device=CPU)
    assert len(log) == 12
    first, last = log[0]["eval_loss"], log[-1]["eval_loss"]
    assert all(np.isfinite(r["eval_loss"]) for r in log)
    assert last < first, (first, last)
    d = np.float32(np.exp(-0.07))
    w = np.float32(0.0)
    for r in log:
        w = np.float32(np.float32(d * w) + np.float32(24))
        assert r["total_weight"] == float(w)
        assert r["sample_size"] <= 96


@pytest.mark.parametrize("extra", [[], ["--scheme", "ttbs", "--adaptive"]])
def test_checkpoint_restart_bit_exact(tmp_path, extra):
    """Kill/restart: resuming from a checkpoint reproduces the run that
    never stopped bit for bit (eval and train losses, W, sizes, lambda, and
    the final checkpoint's every leaf)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import main

    base = [
        "--arch", "stablelm_12b", "--preset", "smoke", "--batch-per-tick", "16",
        "--reservoir", "64", "--retrain-every", "2", "--retrain-steps", "2",
        "--train-batch", "8", "--seq-len", "32", "--ckpt-every", "4",
    ] + extra
    full = main(base + ["--ticks", "8", "--ckpt-dir", str(tmp_path / "a")], device=CPU)
    main(base + ["--ticks", "4", "--ckpt-dir", str(tmp_path / "b")], device=CPU)
    resumed = main(base + ["--ticks", "8", "--ckpt-dir", str(tmp_path / "b"), "--resume"],
                   device=CPU)
    assert [r["tick"] for r in resumed] == [4, 5, 6, 7]
    f = {r["tick"]: r for r in full}
    for r in resumed:
        want = f[r["tick"]]
        assert set(r) == set(want)
        for k in r:
            assert r[k] == want[k] or (np.isnan(r[k]) and np.isnan(want[k])), (k, r, want)
    assert latest_step(tmp_path / "a") == latest_step(tmp_path / "b") == 8
    a = np.load(tmp_path / "a" / "step_8" / "leaves.npz")
    b = np.load(tmp_path / "b" / "step_8" / "leaves.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("argv", [["--scheme", "drtbs"], ["--scheme", "dttbs"],
                                  ["--shards", "4"]])
def test_driver_distributed_schemes_raise_naming_a7(argv, capsys):
    """Once refused (naming ROADMAP A.7), now run on the CPU at smoke
    size: the distributed schemes through the sharded loop over the
    default 8 shards, the tick batch padded to a multiple of them;
    ``--shards 4`` alone runs the local default, as in JAX."""
    from repro_torch.launch.train import main

    log = main(["--arch", "mamba2_370m", "--ticks", "2", "--batch-per-tick", "12",
                "--reservoir", "24", "--retrain-every", "2", "--retrain-steps", "1",
                "--train-batch", "4", "--seq-len", "16"] + argv, device=CPU)
    out = capsys.readouterr().out
    assert [r["tick"] for r in log] == [0, 1]
    assert all(np.isfinite(r["eval_loss"]) for r in log)
    if "--scheme" in argv:
        assert "batch-per-tick 12 -> 16 (multiple of 8 shards)" in out
        assert f"sharded {argv[1]} loop: 8 shards" in out
        assert log[-1]["sample_size"] > 0
    else:
        assert "sharded" not in out and log[-1]["sample_size"] <= 24


def test_driver_bank_mode_and_profile(tmp_path):
    """``--num-keys``: the bank loop over a Zipf-keyed token stream, every
    tick's eval finite and each train key's |S| within --reservoir;
    ``--profile-dir`` writes a trace."""
    from repro_torch.launch.train import main

    log = main(["--arch", "mamba2_370m", "--preset", "smoke", "--ticks", "6",
                "--batch-per-tick", "16", "--reservoir", "8", "--num-keys", "32",
                "--train-keys", "4", "--retrain-every", "3", "--retrain-steps", "2",
                "--train-batch", "4", "--seq-len", "16", "--bank-bcap", "4",
                "--profile-dir", str(tmp_path / "prof")], device=CPU)
    assert len(log) == 6
    assert all(np.isfinite(r["eval_loss"]) for r in log)
    assert all(max(r["train_key_sizes"]) <= 8 for r in log)
    assert sum(r["overflow"] for r in log) > 0          # bcap 4 drops arrivals
    assert list((tmp_path / "prof").glob("trace_*.json"))
