"""The port's sharded manage loops (``repro_torch.manage.loop``, paper
Sec. 5) against the JAX package's ``repro.manage.loop`` sharded builders,
whose per-shard program runs in-process under ``jax.vmap(...,
axis_name="data")``:

  * the W / C trajectories of the port's sharded loop equal JAX's vmapped
    tick and loop on the same per-shard counts, exactly;
  * fused == per-tick == resumed (with a checkpoint round trip between
    segments), bit for bit, for drtbs and dttbs, with and without the
    decay controller; a misaligned resume raises, as JAX's does;
  * the farm equals the single runs stacked, and the twin of
    tests/_sharded_loop_check.py at 8 shards over 4,000 trials: Theorem
    4.2, Pr[i in S_t] = (C_t / W_t) w_t(i), on the farm's final
    reservoirs within JAX's 0.03, the deterministic trajectories, the size
    bounds, zero overflow, and the fit's view holding the partial item
    exactly when it is counted;
  * ``shard_stream`` equal to JAX's; local samplers refused; telemetry
    leaves the outputs bit-identical.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core.api import make_sampler as j_make_sampler
from repro.data.streams import LinRegStream as JLinRegStream
from repro.manage import loop as jloop
from repro.manage import make_model as j_make_model
from repro.manage import materialize_stream as j_materialize
from repro.manage import shard_stream as j_shard_stream
from repro_torch import decay as tdecay
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import LinRegStream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.manage import (init_sharded_state, item_proto, make_model,
                                make_sharded_manage_step, make_sharded_resume_loop,
                                make_sharded_run_farm, make_sharded_run_loop, materialize_stream,
                                shard_stream)
from repro_torch.manage.models import ModelAdapter

CPU = "cpu"
SHARDED = {
    "drtbs": dict(n=24, lam=0.2, cap_s=64),
    "dttbs": dict(n=12, lam=0.2, batch_size=12),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (many small CPU ops; see
    tests/test_torch_adaptive.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream(T=10, b=16, S=1, sizes=None):
    batches, bcounts = materialize_stream(LinRegStream(seed=0), T,
                                          batch_size=sizes or b, device=CPU)
    return shard_stream(batches, bcounts, S, device=CPU)


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y) or (
            x.dtype.is_floating_point and torch.equal(x.isnan(), y.isnan())
            and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))


def test_shard_stream_equals_jax():
    """The co-partitioned layout, uneven and empty shards included, equal
    to JAX's ``shard_stream`` of the same materialized stream."""
    sizes = [7, 3, 0, 8, 5]
    jb, jc = j_materialize(JLinRegStream(seed=1), 5, batch_size=lambda t: sizes[t])
    tb, tc = materialize_stream(LinRegStream(seed=1), 5, batch_size=lambda t: sizes[t],
                                device=CPU)
    for S, bcap_s in ((3, None), (4, 5)):
        jsb, jsc = j_shard_stream(jb, jc, S, bcap_s=bcap_s)
        tsb, tsc = shard_stream(tb, tc, S, bcap_s=bcap_s, device=CPU)
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        for k in ("x", "y"):
            np.testing.assert_array_equal(tsb[k].numpy(), np.asarray(jsb[k]))
    with pytest.raises(ValueError, match="exceeds bcap_s"):
        shard_stream(tb, tc, 2, bcap_s=3, device=CPU)


def test_sharded_loops_reject_local_samplers():
    model = make_model("linreg", dim=2, device=CPU)
    mesh = make_data_mesh(1, device=CPU)
    for scheme, hyper in (("rtbs", dict(n=8, lam=0.1)), ("sw", dict(n=8))):
        s = make_sampler(scheme, **hyper, device=CPU)
        for build in (make_sharded_run_loop, make_sharded_manage_step, make_sharded_run_farm,
                      make_sharded_resume_loop):
            with pytest.raises(ValueError, match="local scheme"):
                build(s, model, mesh)


@pytest.mark.parametrize("S", [4])
def test_wc_trajectories_equal_jax_vmapped_loop(S):
    """D-R-TBS through the sharded tick on the same per-shard counts: the
    port's C_t and W_t equal JAX's vmapped tick on every tick, its final
    state's W and C JAX's whole vmapped loop's, the sizes within
    {floor C_t, floor C_t + 1}, and the metric NaN only on an empty tick."""
    T, hyper = 14, dict(n=20, lam=0.3, cap_s=48)
    sizes = [16, 12, 0, 20, 8, 16, 0, 0, 4, 16, 20, 12, 3, 16]
    jb, jc = j_materialize(JLinRegStream(seed=0), T, batch_size=lambda t: sizes[t])
    jb, jc = j_shard_stream(jb, jc, S)
    js_, jm = j_make_sampler("drtbs", **hyper), j_make_model("linreg", dim=2)
    jtick = jax.jit(jax.vmap(jloop._make_sharded_tick(js_, jm, 2),
                             in_axes=(None, None, 0, None, 0, 0), axis_name="data"))
    proto = {"x": jnp.zeros((2,), jnp.float32), "y": jnp.zeros((), jnp.float32)}
    jst = jax.vmap(lambda _: js_.init(proto))(jnp.arange(S))
    params = jm.init()
    bcap_s = jb["x"].shape[1] // S
    jW, jC = [], []
    for t in range(T):
        bt = jax.tree_util.tree_map(lambda a: a[t].reshape((S, bcap_s) + a.shape[2:]), jb)
        jst, p, _ = jtick(jax.random.key(1), jnp.int32(t), jst, params, bt, jc[t])
        params = jax.tree_util.tree_map(lambda a: a[0], p)
        jW.append(np.asarray(jst.total_weight)[0])
        jC.append(np.asarray(jst.weight)[0])
    loop = jax.jit(jax.vmap(jloop._sharded_loop_body(js_, jm, 2), in_axes=(None, 1, 1),
                            axis_name="data"))
    jb_s = jax.tree_util.tree_map(lambda a: a.reshape((T, S, bcap_s) + a.shape[2:]), jb)
    jfinal = loop(jax.random.key(1), jb_s, jc[:, :, None])[0]

    tb, tc = _stream(T=T, S=S, sizes=lambda t: sizes[t])
    sampler = make_sampler("drtbs", **hyper, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    tick = make_sharded_manage_step(sampler, model, make_data_mesh(S, device=CPU),
                                    retrain_every=2)
    st, params = init_sharded_state(sampler, S, item_proto(tb)), model.init()
    for t in range(T):
        st, params, m = tick(prng.key(1), t, st, params, pytree.tree_map(lambda a: a[t], tb),
                             tc[t])
        assert st.total_weight[0].item() == jW[t] and st.weight[0].item() == jC[t], t
        c = st.weight[0].item()
        assert math.floor(c) <= int(m["size"]) <= math.floor(c) + 1
        assert bool(torch.isnan(m["metric"])) == (sizes[t] == 0)
    np.testing.assert_array_equal(st.total_weight.numpy(), np.asarray(jfinal.total_weight)[0])
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(jfinal.weight)[0])
    assert int(st.overflow.sum()) == 0


@pytest.mark.parametrize("scheme", sorted(SHARDED))
def test_fused_per_tick_and_resumed_are_bit_identical(scheme, tmp_path):
    """At 4 shards: the fused run, the ticks driven one by one, and the
    stream consumed in segments through the resume loop with a checkpoint
    round trip of the snapshot between them, bit for bit."""
    T, cut, S = 12, 4, 4
    sampler = make_sampler(scheme, **SHARDED[scheme], device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = _stream(T=T, S=S)
    mesh = make_data_mesh(S, device=CPU)
    key = prng.key(17)
    state_f, params_f, trace_f = make_sharded_run_loop(sampler, model, mesh,
                                                       retrain_every=2)(key, batches, bcounts)
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=2)
    st, params = init_sharded_state(sampler, S, item_proto(batches)), model.init()
    rows = []
    for t in range(T):
        st, params, m = tick(key, t, st, params, pytree.tree_map(lambda a: a[t], batches),
                             bcounts[t])
        rows.append(m)
    _leaves_equal((st, params), (state_f, params_f))
    for k in trace_f:
        _leaves_equal(trace_f[k], torch.stack([r[k] for r in rows]))
    resume = make_sharded_resume_loop(sampler, model, mesh, retrain_every=2)
    st, params = init_sharded_state(sampler, S, item_proto(batches)), model.init()
    traces = []
    for t0 in range(0, T, cut):
        seg = pytree.tree_map(lambda a: a[t0:t0 + cut], batches)
        st, params, tr = resume(key, st, params, seg, bcounts[t0:t0 + cut], t0)
        traces.append(tr)
        save_checkpoint(tmp_path, t0 + cut, (st, params, t0 + cut))
        st, params, _ = restore_checkpoint(tmp_path, t0 + cut, (st, params, 0))
    _leaves_equal((st, params), (state_f, params_f))
    for k in trace_f:
        _leaves_equal(trace_f[k], torch.cat([tr[k] for tr in traces]))
    with pytest.raises(ValueError, match="multiple of"):
        make_sharded_resume_loop(sampler, model, mesh, retrain_every=2, superbatch=2)(
            key, st, params, batches, bcounts, 3)


def test_controlled_and_telemetry_runs_are_bit_identical():
    """drtbs under the loss-ratio controller: fused == per-tick (the
    controller state round-tripped) == resumed, the trace's decay column
    the controller's; with telemetry the outputs are unchanged and every
    tick drains one row of shard 0's gauges."""
    from repro_torch.obs import MemorySink, Telemetry

    T, S = 8, 3
    sampler = make_sampler("drtbs", n=24, lam=0.2, cap_s=64, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = tdecay.loss_ratio(lam0=0.2, lam_min=0.02, lam_max=1.0)
    batches, bcounts = _stream(T=T, S=S)
    mesh = make_data_mesh(S, device=CPU)
    key = prng.key(4)
    state_f, params_f, trace = make_sharded_run_loop(sampler, model, mesh, retrain_every=2,
                                                     controller=ctrl)(key, batches, bcounts)
    assert trace["decay"].shape == (T,)
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=2, controller=ctrl)
    st, params, cst = init_sharded_state(sampler, S, item_proto(batches)), model.init(), \
        ctrl.init(CPU)
    rows = []
    for t in range(T):
        st, params, cst, m = tick(key, t, st, params, cst,
                                  pytree.tree_map(lambda a: a[t], batches), bcounts[t])
        rows.append(m)
    _leaves_equal((st, params), (state_f, params_f))
    for k in trace:
        _leaves_equal(trace[k], torch.stack([r[k] for r in rows]))
    resume = make_sharded_resume_loop(sampler, model, mesh, retrain_every=2, controller=ctrl)
    st, params, cst = init_sharded_state(sampler, S, item_proto(batches)), model.init(), \
        ctrl.init(CPU)
    half = pytree.tree_map(lambda a: a[:4], batches), bcounts[:4]
    st, params, cst, tr0 = resume(key, st, params, cst, *half, 0)
    st, params, cst, tr1 = resume(key, st, params, cst,
                                  pytree.tree_map(lambda a: a[4:], batches), bcounts[4:], 4)
    _leaves_equal((st, params), (state_f, params_f))
    _leaves_equal(trace["decay"], torch.cat([tr0["decay"], tr1["decay"]]))
    mem = MemorySink()
    tel = Telemetry([mem], every=4)
    out = make_sharded_run_loop(sampler, model, mesh, retrain_every=2,
                                telemetry=tel)(key, batches, bcounts)
    ref = make_sharded_run_loop(sampler, model, mesh, retrain_every=2)(key, batches, bcounts)
    _leaves_equal(out, ref)
    ticks = mem.by_kind("tick")
    assert [r["t"] for r in ticks] == list(range(T))
    assert [r["bcount"] for r in ticks] == bcounts[:, 0].tolist()
    np.testing.assert_allclose([r["total_weight"] for r in ticks][-1],
                               float(ref[0].total_weight[0]))


def test_farm_equals_single_runs_stacked():
    """Trials x shards as two leading dimensions: trial i of the farm is
    the single run with ``split(key, trials)[i]``, bit for bit."""
    T, S, trials = 6, 3, 3
    sampler = make_sampler("drtbs", n=16, lam=0.2, cap_s=48, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = _stream(T=T, b=12, S=S)
    mesh = make_data_mesh(S, device=CPU)
    states, params, trace = make_sharded_run_farm(sampler, model, mesh, retrain_every=2)(
        prng.key(5), trials, batches, bcounts)
    assert trace["metric"].shape == (trials, T) and states.nfull.shape == (trials, S)
    assert params.shape == (trials, 3)
    run = make_sharded_run_loop(sampler, model, mesh, retrain_every=2)
    for i, k in enumerate(prng.split(prng.key(5), trials)):
        st, p, tr = run(k, batches, bcounts)
        _leaves_equal(st, pytree.tree_map(lambda a: a[i], states))
        _leaves_equal(p, params[i])
        for c in tr:
            _leaves_equal(tr[c], trace[c][i])
    items = states.items["x"].reshape(trials, -1)
    assert len({items[i].numpy().tobytes() for i in range(trials)}) > 1


# the twin of tests/_sharded_loop_check.py: its sizes, stream and tolerance
FS, FCAP_S, FBCAP_S, FN, FLAM, TRIALS, FRETRAIN = 8, 32, 8, 40, 0.3, 4000, 2
GLOBAL_BATCHES = [24, 8, 0, 40, 16, 8, 8, 4]


def _split_counts(total, s=FS):
    """tests/_sharded_loop_check.py's deterministic uneven split."""
    base = np.zeros(s, np.int32)
    rs = np.random.RandomState(total * 7 + 13)
    for _ in range(total):
        base[rs.randint(0, max(1, s // 2 + total % s))] += 1
    while base.max() > FBCAP_S:
        src, dst = base.argmax(), base.argmin()
        base[src] -= 1
        base[dst] += 1
    return base


def test_sharded_farm_theorem_4_2_at_8_shards():
    """Fused == per-tick at 8 shards on a skewed stream with empty shards
    and ticks, then 4,000 farm trials: Thm 4.2 per batch on the final
    reservoirs within 0.03, W_t / C_t the recurrence, sizes in {floor C,
    floor C + 1}, the global bound, zero overflow, and the last fit's view
    holding mask.sum() == size (the partial item materialized when
    counted)."""
    T = len(GLOBAL_BATCHES)
    items = np.zeros((T, FS * FBCAP_S), np.int32)
    counts = np.zeros((T, FS), np.int64)
    for t, g in enumerate(GLOBAL_BATCHES):
        c = _split_counts(g)
        counts[t] = c
        nid = 0
        for s in range(FS):
            for j in range(c[s]):
                items[t, s * FBCAP_S + j] = 1000 * (t + 1) + nid
                nid += 1
    batches, bcounts = torch.from_numpy(items), torch.from_numpy(counts)
    probe = ModelAdapter(
        name="probe", init=lambda: torch.tensor(-1.0),
        fit=lambda key, params, view: view.mask.sum().to(torch.float32),
        evaluate=lambda params, batch, bcount: torch.tensor(0.0), hyper={"probe": True},
        device=torch.device(CPU))
    sampler = make_sampler("drtbs", n=FN, lam=FLAM, cap_s=FCAP_S, device=CPU)
    mesh = make_data_mesh(FS, device=CPU)
    key = prng.key(11)
    state_f, params_f, trace_f = make_sharded_run_loop(sampler, probe, mesh,
                                                       retrain_every=FRETRAIN)(key, batches,
                                                                               bcounts)
    tick = make_sharded_manage_step(sampler, probe, mesh, retrain_every=FRETRAIN)
    st, params = init_sharded_state(sampler, FS, torch.zeros((), dtype=torch.int32)), \
        probe.init()
    for t in range(T):
        st, params, _ = tick(key, t, st, params, batches[t], bcounts[t])
    _leaves_equal((st, params), (state_f, params_f))

    states, params, trace = make_sharded_run_farm(sampler, probe, mesh,
                                                  retrain_every=FRETRAIN)(
        prng.key(17), TRIALS, batches, bcounts)
    items_np = states.items.numpy()                    # [TRIALS, S, CAP_S]
    nfull_np = states.nfull.numpy()
    partial_np = states.partial_item.numpy()[:, 0]
    weight_np = states.weight.numpy()[:, 0]
    tw_np = states.total_weight.numpy()[:, 0]
    size_np = trace["size"].numpy()
    assert int(states.overflow.sum()) == 0
    w = 0.0
    for t, g in enumerate(GLOBAL_BATCHES):
        w = math.exp(-FLAM) * w + g
        c = min(FN, w)
        assert ((size_np[:, t] >= math.floor(c)) & (size_np[:, t] <= math.floor(c) + 1)).all()
    W_T, C_T = w, min(FN, w)
    assert (np.abs(tw_np - W_T) < 1e-3 * max(1.0, W_T)).all()
    assert (np.abs(weight_np - C_T) < 1e-3 * max(1.0, C_T)).all()
    tot_full = nfull_np.sum(axis=1)
    assert (tot_full <= FN).all()
    assert (np.floor(weight_np + 1e-4) >= tot_full).all()
    last_fit = max(t for t in range(T) if (t + 1) % FRETRAIN == 0)
    np.testing.assert_array_equal(params.numpy(), size_np[:, last_fit].astype(np.float32))

    frac = weight_np - np.floor(weight_np)
    take = np.random.RandomState(0).rand(TRIALS) < frac
    valid = np.arange(FCAP_S)[None, None, :] < nfull_np[:, :, None]
    bidx = np.where(valid, items_np // 1000, 0)
    hits = np.zeros(T + 1)
    for t in range(1, T + 1):
        hits[t] = (bidx == t).sum() + ((partial_np // 1000 == t) & take).sum()
    bad = []
    for j, g in enumerate(GLOBAL_BATCHES):
        if g == 0:
            continue
        emp = hits[j + 1] / TRIALS / g
        expect = (C_T / W_T) * math.exp(-FLAM * (T - 1 - j))
        if abs(emp - expect) > 0.03:
            bad.append((j, emp, expect))
    assert not bad, bad
