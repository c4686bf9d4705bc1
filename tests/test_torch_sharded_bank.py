"""The port's key-sharded bank loop (``repro_torch.manage.
make_sharded_bank_loop``, ``shard_keyed_stream``) against the JAX package's
``repro.manage.bank_loop`` and against the port's own local bank loop:

  * ``shard_keyed_stream`` equals JAX's bit for bit (keys, payload, counts,
    its errors);
  * at S = 1 the loop equals ``make_bank_run_loop`` bit for bit (state,
    params, trace; JAX's own test holds rtol 1e-6, tests/test_bank.py:602);
  * at S = 3 it equals S local loops, one a shard's sub-stream with the
    same key, stacked: state and params bit for bit, the metric the
    |B|-weighted mean of the local metrics (NaN on an empty global tick),
    for rtbs and ttbs, shared and per key;
  * the deterministic columns (W, C, pending, nfull, overflow) equal JAX's
    per-key replay exactly, and JAX's jitted bank loop on each shard's
    sub-stream (and, at S = 1, JAX's own ``make_sharded_bank_loop``)
    exactly but for W's 1 ulp (ROADMAP C.3: XLA's one-rounding FMA);
  * two shards fed the same sub-stream end bit-identical (ROADMAP C.18);
  * the fused run equals its tick driven by hand, routed at S * b_s rows;
  * telemetry leaves the outputs bit-identical;
  * local ids outside [0, K_s) are counted in their shard's ``invalid`` and
    reach no neighbouring shard's key.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.bank import make_bank as j_make_bank
from repro.core import latent as jl
from repro.core import rtbs as jr
from repro.launch.mesh import make_data_mesh as j_make_data_mesh
from repro.manage import make_bank_run_loop as j_make_bank_run_loop
from repro.manage import make_model as j_make_model
from repro.manage import make_sharded_bank_loop as j_make_sharded_bank_loop
from repro.manage import shard_keyed_stream as j_shard_keyed_stream
from repro_torch.bank import make_bank, shard_bank
from repro_torch.core import prng
from repro_torch.data.streams import KeyedStream, LinRegStream
from repro_torch.decay import polynomial
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.manage import (make_bank_run_loop, make_model, make_sharded_bank_loop,
                                make_sharded_bank_manage_step, materialize_stream,
                                shard_keyed_stream)
from repro_torch.obs import MemorySink, Telemetry

CPU = "cpu"
BANKS = {"rtbs": dict(n=6, lam=0.2, bcap=4),
         "ttbs": dict(n=4, lam=0.2, bcap=4, batch_size=2.0),
         # a schedule with a state: each shard keeps a copy (JAX's gathered form)
         "rtbs_poly": dict(n=6, decay=polynomial(0.8), bcap=4)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (many small CPU ops; see
    tests/test_torch_adaptive.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keyed(K=12, T=8, b=16, sizes=None, seed=0):
    stream = KeyedStream(base=LinRegStream(seed=seed), num_keys=K, alpha=1.1, flip_every=4)
    return materialize_stream(stream, T, batch_size=sizes or b, bcap=b,
                              fields=("key", "x", "y"), device=CPU)


def _segment(batches, bcounts, s):
    """Shard s's sub-stream of a co-partitioned stream."""
    S = bcounts.shape[-1]
    b_s = batches["key"].shape[1] // S
    return {f: v[:, s * b_s:(s + 1) * b_s] for f, v in batches.items()}, bcounts[:, s]


def _equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.isnan(), y.isnan()) if x.is_floating_point() else True
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def _run(scheme, S, K, batches, bcounts, *, per_key=False, Q=2, key=3, telemetry=None):
    sb, sc = shard_keyed_stream(batches, bcounts, S, K, device=CPU)
    bank = make_bank(scheme.split("_")[0], num_keys=K // S, **BANKS[scheme], device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    run = make_sharded_bank_loop(bank, model, make_data_mesh(S, device=CPU), retrain_every=2,
                                 train_keys=range(Q), per_key=per_key, telemetry=telemetry)
    return (sb, sc, bank, model), run(prng.key(key), sb, sc)


def test_shard_keyed_stream_equals_jax():
    """Exact: keys, payload and counts of JAX's ``shard_keyed_stream`` on
    the same stream, ids past the last range and negative ones included
    (clipped into the last and first shard, localised out of range), with
    the default and an explicit ``bcap_s``; the same two errors."""
    K, S = 12, 3
    batches, bcounts = _keyed(K=K, T=5, b=10, sizes=lambda t: [10, 7, 0, 10, 4][t])
    batches["key"][1, :3] = torch.tensor([12, -1, 17], dtype=torch.int32)
    jb = {f: jnp.asarray(v.numpy()) for f, v in batches.items()}
    jc = jnp.asarray(bcounts.numpy(), jnp.int32)
    for bcap_s in (None, 9):
        tb, tc = shard_keyed_stream(batches, bcounts, S, K, bcap_s=bcap_s, device=CPU)
        wb, wc = j_shard_keyed_stream(jb, jc, S, K, bcap_s=bcap_s)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(wc))
        for f in ("key", "x", "y"):
            assert tb[f].dtype == batches[f].dtype
            np.testing.assert_array_equal(tb[f].numpy(), np.asarray(wb[f]))
    assert tc.sum(-1).tolist() == bcounts.tolist()
    with pytest.raises(ValueError, match="must divide evenly"):
        shard_keyed_stream(batches, bcounts, 5, K, device=CPU)
    with pytest.raises(ValueError, match="exceeds bcap_s"):
        shard_keyed_stream(batches, bcounts, S, K, bcap_s=2, device=CPU)


@pytest.mark.parametrize("scheme,per_key", [("rtbs", False), ("rtbs", True),
                                            ("ttbs", False), ("ttbs", True)])
def test_one_shard_equals_local_loop(scheme, per_key):
    """Exact: at S = 1 the key-sharded loop is the local bank loop on the
    same stream (state, params and trace, with the leading [1])."""
    K = 12
    batches, bcounts = _keyed(K=K)
    (_, _, bank, model), (state, params, trace) = _run(scheme, 1, K, batches, bcounts,
                                                      per_key=per_key)
    ls, lp, lt = make_bank_run_loop(bank, model, retrain_every=2, train_keys=range(2),
                                    per_key=per_key)(prng.key(3), batches, bcounts)
    _equal(pytree.tree_map(lambda a: a[0], (state, params)), (ls, lp))
    _equal({k: v[0] for k, v in trace.items()}, lt)


@pytest.mark.parametrize("scheme,per_key", [("rtbs", False), ("rtbs", True),
                                            ("ttbs", False), ("ttbs", True),
                                            ("rtbs_poly", False)])
def test_shards_equal_local_runs_stacked(scheme, per_key):
    """Exact: at S = 3 each shard's state, params, sizes and overflow are a
    local bank loop's on that shard's sub-stream with the same key; the
    per-key metric is the local loop's, and the shared metric (the same
    row on every shard) is the local metrics weighted by each shard's share
    of the tick's arrivals, NaN on the empty global tick. With a
    polynomial schedule every shard carries its own copy of the
    schedule's state, each the local loop's."""
    K, S = 12, 3
    sizes = [16, 9, 0, 16, 5, 16, 12, 16]
    batches, bcounts = _keyed(K=K, sizes=lambda t: sizes[t])
    (sb, sc, bank, model), (state, params, trace) = _run(scheme, S, K, batches, bcounts,
                                                        per_key=per_key)
    assert state.nfull.shape == (S, K // S) and trace["size"].shape == (S, 8, 2)
    local = make_bank_run_loop(bank, model, retrain_every=2, train_keys=range(2),
                               per_key=per_key)
    outs = [local(prng.key(3), *_segment(sb, sc, s)) for s in range(S)]
    for s, (ls, lp, lt) in enumerate(outs):
        _equal(pytree.tree_map(lambda a: a[s], (state, params)), (ls, lp))
        _equal({k: trace[k][s] for k in ("size", "overflow")},
               {k: lt[k] for k in ("size", "overflow")})
        if per_key:
            _equal(trace["metric"][s], lt["metric"])
    if not per_key:
        m = torch.stack([o[2]["metric"] for o in outs], -1)
        w = sc.to(torch.float32)
        share = w / w.sum(-1, keepdim=True).clamp(min=1.0)
        want = torch.where(w.sum(-1) > 0, (torch.where(sc > 0, m, 0.0) * share).sum(-1),
                           torch.nan)
        for s in range(S):
            _equal(trace["metric"][s], want)
        assert torch.isnan(trace["metric"][0, 2]) and torch.isfinite(trace["metric"][0, 3])
        torch.testing.assert_close(trace["metric"][0, 3:], (m * w).sum(-1)[3:] / w.sum(-1)[3:],
                                   rtol=1e-6, atol=0)


def _fma32(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _jax_replay(keys, bcounts, K, n, bcap, lam):
    """JAX's per-key replay of the rtbs bank's [K] columns: eager
    ``rtbs.step`` per touched key and tick (as tests/test_torch_bank.py
    does), the untouched keys' pending decay composed."""
    d = np.float32(math.exp(-lam))
    col = {"nfull": np.zeros(K, np.int32), "weight": np.zeros(K, np.float32),
           "total_weight": np.zeros(K, np.float32), "pending": np.ones(K, np.float32),
           "overflow": np.zeros(K, np.int32)}
    items = jnp.zeros((n + 1, 2), jnp.float32)
    for t in range(keys.shape[0]):
        col["pending"] = (col["pending"] * d).astype(np.float32)
        u, c = np.unique(keys[t, :int(bcounts[t])], return_counts=True)
        for k, ck in zip(u, c):
            out = jr.step(jax.random.key(0),
                          jr.RTBSState(lat=jl.Latent(items=items, nfull=jnp.int32(col["nfull"][k]),
                                                     weight=jnp.float32(col["weight"][k])),
                                       total_weight=jnp.float32(col["total_weight"][k])),
                          jnp.zeros((bcap, 2), jnp.float32), jnp.int32(min(ck, bcap)), n=n,
                          decay=jnp.float32(col["pending"][k]))
            col["nfull"][k] = int(out.lat.nfull)
            col["weight"][k] = np.float32(out.lat.weight)
            col["total_weight"][k] = np.float32(out.total_weight)
            col["pending"][k] = 1.0
            col["overflow"][k] += max(int(ck) - bcap, 0)
    return col


def _jax_columns_match(got, jst):
    """The port's columns against a jitted JAX bank's: nfull, pending and
    overflow exact, W within 1 ulp (C.3: XLA's one-rounding FMA) and C
    within 1 ulp, since C = W while a key's W is below n."""
    for f in ("nfull", "pending", "overflow"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jst, f)).reshape(-1),
                                      err_msg=f)
    for f in ("total_weight", "weight"):
        np.testing.assert_array_max_ulp(got[f], np.asarray(getattr(jst, f)).reshape(-1),
                                        maxulp=1)


def test_columns_equal_jax_replay_and_jax_loops():
    """The rtbs bank's [K] columns after 8 ticks at S = 3 and S = 1: exact
    against JAX's per-key replay; against JAX's jitted ``make_bank_run_loop``
    on each of the 3 shards' sub-streams, and at S = 1 against JAX's
    ``make_sharded_bank_loop`` on ``make_data_mesh(1)`` (whose trace's
    overflow is also the port's), within 1 ulp on W and C and exact on
    the rest (:func:`_jax_columns_match`)."""
    K, hyper = 12, BANKS["rtbs"]
    batches, bcounts = _keyed(K=K, b=24)
    replay = _jax_replay(batches["key"].numpy(), bcounts.numpy(), K, hyper["n"],
                         hyper["bcap"], hyper["lam"])
    jmodel = j_make_model("linreg", dim=2)
    as_jax = lambda b, c: ({f: jnp.asarray(v.numpy()) for f, v in b.items()},  # noqa: E731
                           jnp.asarray(c.numpy(), jnp.int32))
    for S in (3, 1):
        (sb, sc, _, _), (state, _, trace) = _run("rtbs", S, K, batches, bcounts)
        got = {f: getattr(state, f).reshape(-1).numpy() for f in replay}
        for f in replay:
            np.testing.assert_array_equal(got[f], replay[f], err_msg=f)
        jbank = j_make_bank("rtbs", num_keys=K // S, **hyper)
        if S == 3:
            jrun = j_make_bank_run_loop(jbank, jmodel, retrain_every=2, train_keys=range(2))
            for s in range(S):
                jst, _, _ = jrun(jax.random.key(3), *as_jax(*_segment(sb, sc, s)))
                sl = slice(s * (K // S), (s + 1) * (K // S))
                _jax_columns_match({f: v[sl] for f, v in got.items()}, jst)
        else:
            jst, _, jtr = j_make_sharded_bank_loop(
                jbank, jmodel, j_make_data_mesh(1), retrain_every=2,
                train_keys=range(2))(jax.random.key(3), *as_jax(sb, sc))
            _jax_columns_match(got, jst)
            np.testing.assert_array_equal(trace["overflow"].numpy(), np.asarray(jtr["overflow"]))


def test_two_shards_fed_the_same_substream_end_identical():
    """Exact (ROADMAP C.18): JAX's shards fold the LOCAL key id into the
    replicated tick key, so two shards fed the same sub-stream draw the same
    bits and end with the same state, params and trace rows."""
    K, S = 8, 2
    batches, bcounts = _keyed(K=K // S, T=6, b=12)
    twin = {f: torch.cat([v, v], dim=1) for f, v in batches.items()}
    counts = torch.stack([bcounts, bcounts], dim=-1)
    for scheme in ("rtbs", "ttbs"):
        bank = make_bank(scheme, num_keys=K // S, **BANKS[scheme], device=CPU)
        state, params, trace = make_sharded_bank_loop(
            bank, make_model("linreg", dim=2, device=CPU), make_data_mesh(S, device=CPU),
            retrain_every=2, train_keys=range(2), per_key=True)(prng.key(1), twin, counts)
        _equal(pytree.tree_map(lambda a: a[0], (state, params, trace)),
               pytree.tree_map(lambda a: a[1], (state, params, trace)))
        assert int(state.nfull.sum()) > 0


@pytest.mark.parametrize("per_key", [False, True])
def test_run_equals_ticks_by_hand(per_key):
    """Exact: the fused run (routed at the stream's largest tick) equals its
    tick driven by hand at the default S * b_s routed rows."""
    K, S, T = 12, 3, 8
    batches, bcounts = _keyed(K=K)
    (sb, sc, bank, model), (state, params, trace) = _run("rtbs", S, K, batches, bcounts,
                                                        per_key=per_key)
    assert int(sc.sum(-1).max()) < sb["key"].shape[1]     # the run routes fewer rows
    tick = make_sharded_bank_manage_step(bank, model, make_data_mesh(S, device=CPU),
                                         retrain_every=2, train_keys=range(2),
                                         per_key=per_key)
    st = shard_bank(bank, S).init({"x": torch.zeros(2), "y": torch.zeros(())})
    p = model.init()
    p = p.expand((S, 2, 3) if per_key else (S, 3)).clone()
    ms = []
    for t in range(T):
        st, p, m = tick(prng.key(3), t, st, p, {f: v[t] for f, v in sb.items()}, sc[t])
        ms.append(m)
    _equal((st, p), (state, params))
    _equal({k: torch.stack([m[k] for m in ms], 1) for k in trace}, trace)


def test_telemetry_leaves_the_outputs_bit_identical():
    """Exact: telemetry on equals off; it drains shard 0's view (its sizes,
    overflow and bcount) a tick."""
    K, S, T = 12, 3, 8
    batches, bcounts = _keyed(K=K)
    _, off = _run("rtbs", S, K, batches, bcounts)
    mem = MemorySink()
    (_, sc, _, _), on = _run("rtbs", S, K, batches, bcounts,
                             telemetry=Telemetry([mem], every=4, monitors=()))
    _equal(off, on)
    ticks = mem.by_kind("tick")
    assert [r["t"] for r in ticks] == list(range(T))
    assert mem.by_kind("run")[0]["scheme"] == "bank.rtbs"
    assert [r["size"] for r in ticks] == off[2]["size"][0].tolist()
    assert [r["overflow"] for r in ticks] == off[2]["overflow"][0].tolist()
    assert [r["bcount"] for r in ticks] == sc[:, 0].tolist()


def test_out_of_range_local_ids_are_invalid_and_never_cross_shards():
    """Exact: local ids -1, K_s and K_s + 3 in shard 0's valid rows are
    counted in shard 0's ``invalid`` and routed nowhere: shard 1 keeps only
    its own arrival, shard 0 its one valid one."""
    S, Ks = 2, 4
    bank = shard_bank(make_bank("rtbs", num_keys=Ks, n=3, lam=0.1, bcap=4, device=CPU), S)
    keys = torch.tensor([-1, 4, 2, 7, 0, 1, 5, 6], dtype=torch.int32)   # rows 0-3: shard 0
    pay = {"x": torch.arange(16, dtype=torch.float32).reshape(8, 2) + 1.0}
    st = bank.init({"x": torch.zeros(2)})
    st, stats = bank.step_stats(prng.key(0), st, keys, pay, torch.tensor([4, 1]))
    assert stats["invalid"].tolist() == [3, 0]
    assert stats["ntouched"].tolist() == [1, 1] and stats["overflow"].tolist() == [0, 0]
    assert st.total_weight.tolist() == [[0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0]]
    assert st.items["x"][0, 2, 0].tolist() == [5.0, 6.0]
    assert st.items["x"][1, 0, 0].tolist() == [9.0, 10.0]
    assert int((st.items["x"] != 0).sum()) == 4
    view = bank.extract(prng.key(1), st, [0, 2])
    assert view.size.tolist() == [[0, 1], [1, 0]] and view.mask.shape == (S, 2, 4)
    assert torch.equal(bank.size(prng.key(1), st, [0, 2]), view.size)
