"""The cases of tests/test_torch_ranks.py, written once for both forms of
the port's Sec. 5 schemes: each ``case_*(mesh, ...)`` runs on the stacked
mesh (every shard a row of one process's state) or on a rank's mesh (one
shard a rank of a gloo group) and returns the process's rows.

:func:`run` is a rank's entry (``repro_torch.launch.ranks.spawn``): it runs
every case over the group and saves the results to ``rank<r>.pt``. The
test runs the same cases on the stacked mesh and holds row r against rank
r's file, bit for bit.
"""
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import decay as tdecay
from repro_torch.bank import make_bank
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import distributed, prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import KeyedStream, LinRegStream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.manage import (init_sharded_state, item_proto, make_model,
                                make_sharded_bank_loop, make_sharded_manage_step,
                                make_sharded_resume_loop, make_sharded_run_farm,
                                make_sharded_run_loop, materialize_stream, shard_keyed_stream,
                                shard_stream)

CPU = "cpu"
S = 4
RETRAIN = 2
SHARDED = {"drtbs": dict(n=24, lam=0.2, cap_s=64),
           "dttbs": dict(n=12, lam=0.2, batch_size=12.0, cap=48)}
# the step case: unsaturated, overshoot, saturated, an undershoot after
# the empty ticks, and saturated again; every shard's count differs
STEP_T, STEP_BCAP, STEP = 24, 16, dict(n=48, lam=0.2, cap_s=64)
STEP_HIGH = (0, 1, 2, 3, 4, 5, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)
# the W / C case: tests/test_torch_sharded_loop.py's JAX comparison
WC_SIZES = [16, 12, 0, 20, 8, 16, 0, 0, 4, 16, 20, 12, 3, 16]
WC_HYPER = dict(n=20, lam=0.3, cap_s=48)


def _rank(mesh):
    return None if mesh.group is None else mesh.rank


def _rows(x, mesh, dim=-1):
    """The process's rows of a stacked every-shard array."""
    r = _rank(mesh)
    return x if r is None else x.narrow(dim, r, 1)


def step_stream():
    """A co-partitioned stream with an id, an f32 and a bf16 leaf: ``(items
    [T, S * bcap_s, ...], counts [T, S])``."""
    rs = np.random.RandomState(7)
    counts = rs.randint(0, STEP_BCAP + 1, size=(STEP_T, S)).astype(np.int64)
    counts[[t for t in range(STEP_T) if t not in STEP_HIGH]] = 0
    counts[3, 1:] = 0                                        # one shard's arrivals only
    ids = np.zeros((STEP_T, S * STEP_BCAP), np.int32)
    nid = 1
    for t in range(STEP_T):
        for s in range(S):
            c = counts[t, s]
            ids[t, s * STEP_BCAP:s * STEP_BCAP + c] = np.arange(nid, nid + c)
            nid += c
    x = rs.standard_normal((STEP_T, S * STEP_BCAP, 3)).astype(np.float32)
    items = {"id": torch.from_numpy(ids), "x": torch.from_numpy(x),
             "h": torch.from_numpy(x[..., :2] * 3).to(torch.bfloat16)}
    return items, torch.from_numpy(counts)


def case_step(mesh):
    """D-R-TBS through :func:`distributed.make_drtbs_step`, the state after
    every tick; then D-T-TBS through the sampler's step under the mesh's
    axis. Returns ``{"drtbs": [state a tick], "dttbs": [state a tick]}``."""
    items, counts = step_stream()
    L = mesh.local_shards
    batch = pytree.tree_map(
        lambda a: _rows(a.reshape((STEP_T, S, STEP_BCAP) + a.shape[2:]), mesh, 1).reshape(
            (STEP_T, L * STEP_BCAP) + a.shape[2:]), items)
    cnt = _rows(counts, mesh)
    step = distributed.make_drtbs_step(mesh, n=STEP["n"], lam=STEP["lam"])
    st = init_sharded_state(make_sampler("drtbs", **STEP, device=CPU), L,
                            pytree.tree_map(lambda a: torch.zeros(a.shape[2:], dtype=a.dtype),
                                            items))
    out = {"drtbs": [], "dttbs": []}
    for t in range(STEP_T):
        st = step(prng.fold_in(prng.key(11), t), st, pytree.tree_map(lambda a: a[t], batch),
                  cnt[t])
        out["drtbs"].append(st)
    ax = mesh.shard_axis
    sampler = make_sampler("dttbs", n=6, lam=0.2, batch_size=6.0, cap=24, axis=ax, device=CPU)
    st = init_sharded_state(sampler, L, pytree.tree_map(lambda a: torch.zeros(
        a.shape[2:], dtype=a.dtype), items))
    for t in range(STEP_T):
        b = distributed.split_batch(pytree.tree_map(lambda a: a[t], batch), L)
        st = sampler.step(prng.fold_in(prng.key(12), t), st, b, cnt[t])
        out["dttbs"].append(st)
    out["dttbs_view"] = sampler.extract_global(prng.key(0), st)
    out["dttbs_realize"] = distributed.buffer_realize_global(st, ax)
    out["dttbs_size"] = sampler.size_global(prng.key(0), st)
    return out


def case_realize(mesh, states):
    """Realize and extract the global sample of each D-R-TBS state of
    :func:`case_step` under several keys (the partial item taken and not)."""
    ax = mesh.shard_axis
    sampler = make_sampler("drtbs", **STEP, device=CPU).over(ax)
    out = []
    for i, st in enumerate(states):
        for k in range(6):
            key = prng.key(100 * i + k)
            view = sampler.extract_global(key, st)
            out.append({"shard": distributed.drtbs_realize_shard(key, st, ax),
                        "extract": sampler.extract(key, st),
                        "global": distributed.drtbs_realize_global(key, st, ax),
                        "view": (view.items, view.mask, view.size),
                        "size": sampler.size_global(key, st)})
    return out


def linreg_stream(T, b=16, sizes=None, seed=0, rank=None):
    batches, bcounts = materialize_stream(LinRegStream(seed=seed), T,
                                          batch_size=sizes or b, device=CPU)
    return shard_stream(batches, bcounts, S, device=CPU, rank=rank)


def _checkpoint(mesh, ckpt_dir, step, st, params):
    """The gathered snapshot, written by rank 0 (every rank gathers), then
    every rank restores its rows after a barrier."""
    snap = distributed.gather_tree(st, mesh.shard_axis)
    if mesh.rank == 0:
        save_checkpoint(ckpt_dir, step, (snap, params, step))
    if mesh.group is not None:
        torch.distributed.barrier(group=mesh.group)
    snap, params, _ = restore_checkpoint(ckpt_dir, step, (st, params, 0))
    return distributed.local_rows(snap, mesh.shard_axis), params


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        and (not x.is_floating_point() or torch.equal(x.isnan(), y.isnan()))
        for x, y in zip(la, lb))


def case_loop(mesh, ckpt_dir):
    """For drtbs and dttbs: the fused run, which must equal the ticks by
    hand and the run resumed across checkpoints of the gathered snapshot."""
    T, cut = 12, 4
    out = {}
    for scheme, hyper in SHARDED.items():
        sampler = make_sampler(scheme, **hyper, device=CPU)
        model = make_model("linreg", dim=2, device=CPU)
        batches, bcounts = linreg_stream(T, rank=_rank(mesh))
        key = prng.key(17)
        fused = make_sharded_run_loop(sampler, model, mesh, retrain_every=RETRAIN)(
            key, batches, bcounts)
        tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=RETRAIN)
        st, params = init_sharded_state(sampler, mesh, item_proto(batches)), model.init()
        rows = []
        for t in range(T):
            st, params, m = tick(key, t, st, params, pytree.tree_map(lambda a: a[t], batches),
                                 bcounts[t])
            rows.append(m)
        by_hand = (st, params, {k: torch.stack([r[k] for r in rows]) for k in rows[0]})
        resume = make_sharded_resume_loop(sampler, model, mesh, retrain_every=RETRAIN)
        st, params = init_sharded_state(sampler, mesh, item_proto(batches)), model.init()
        traces = []
        for t0 in range(0, T, cut):
            seg = pytree.tree_map(lambda a: a[t0:t0 + cut], batches)
            st, params, tr = resume(key, st, params, seg, bcounts[t0:t0 + cut], t0)
            traces.append(tr)
            st, params = _checkpoint(mesh, Path(ckpt_dir) / scheme, t0 + cut, st, params)
        resumed = (st, params, {k: torch.cat([tr[k] for tr in traces]) for k in traces[0]})
        if not (_equal(fused, by_hand) and _equal(fused, resumed)):
            raise AssertionError(f"{scheme}: fused, per-tick and resumed runs differ")
        out[scheme] = fused
    return out


def case_controller(mesh):
    """drtbs under the loss-ratio controller: ``(state, params, trace)``."""
    sampler = make_sampler("drtbs", n=24, lam=0.2, cap_s=64, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = tdecay.loss_ratio(lam0=0.2, lam_min=0.02, lam_max=1.0)
    batches, bcounts = linreg_stream(8, rank=_rank(mesh))
    return make_sharded_run_loop(sampler, model, mesh, retrain_every=RETRAIN,
                                 controller=ctrl)(prng.key(4), batches, bcounts)


def case_farm(mesh):
    """A 3-trial drtbs farm: ``(states, params, trace)``."""
    sampler = make_sampler("drtbs", n=16, lam=0.2, cap_s=48, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = linreg_stream(6, b=12, rank=_rank(mesh))
    return make_sharded_run_farm(sampler, model, mesh, retrain_every=RETRAIN)(
        prng.key(5), 3, batches, bcounts)


def case_wc(mesh):
    """The sharded tick on tests/test_torch_sharded_loop.py's W / C stream:
    ``(W [T], C [T], sizes [T], metric [T])``."""
    T = len(WC_SIZES)
    sampler = make_sampler("drtbs", **WC_HYPER, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    tb, tc = linreg_stream(T, sizes=lambda t: WC_SIZES[t], rank=_rank(mesh))
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=2)
    st, params = init_sharded_state(sampler, mesh, item_proto(tb)), model.init()
    W, C, size, metric = [], [], [], []
    for t in range(T):
        st, params, m = tick(prng.key(1), t, st, params, pytree.tree_map(lambda a: a[t], tb),
                             tc[t])
        W.append(st.total_weight[0])
        C.append(st.weight[0])
        size.append(m["size"])
        metric.append(m["metric"])
    return tuple(torch.stack(x) for x in (W, C, size, metric)) + (st,)


BANKS = {"rtbs": dict(n=6, lam=0.2, bcap=4), "ttbs": dict(n=4, lam=0.2, bcap=4, batch_size=2.0)}


def case_bank(mesh):
    """The key-sharded bank loop at K = 12 (3 keys a shard): rtbs shared and
    ttbs per key, ``{name: (state, params, trace)}``."""
    K, sizes = 12, [16, 9, 0, 16, 5, 16, 12, 16]
    stream = KeyedStream(base=LinRegStream(seed=0), num_keys=K, alpha=1.1, flip_every=4)
    batches, bcounts = materialize_stream(stream, 8, batch_size=lambda t: sizes[t], bcap=16,
                                          fields=("key", "x", "y"), device=CPU)
    sb, sc = shard_keyed_stream(batches, bcounts, S, K, device=CPU, rank=_rank(mesh))
    out = {}
    for scheme, per_key in (("rtbs", False), ("ttbs", True)):
        bank = make_bank(scheme, num_keys=K // S, **BANKS[scheme], device=CPU)
        model = make_model("linreg", dim=2, device=CPU)
        out[f"{scheme}_{per_key}"] = make_sharded_bank_loop(
            bank, model, mesh, retrain_every=2, train_keys=range(2), per_key=per_key)(
            prng.key(3), sb, sc)
    return out


def run_cases(mesh, ckpt_dir) -> dict:
    step = case_step(mesh)
    frac = [st for st in step["drtbs"] if float(st.weight[0]) % 1 > 0]
    return {"step": step, "realize": case_realize(mesh, frac[:3] + step["drtbs"][-1:]),
            "loop": case_loop(mesh, ckpt_dir), "controller": case_controller(mesh),
            "farm": case_farm(mesh), "wc": case_wc(mesh), "bank": case_bank(mesh)}


def case_no_axis(mesh):
    """A rank's calls that name no shard axis: each must raise, not run on
    the stacked axis over the rank's one shard. ``{call: message}``."""
    sampler = make_sampler("dttbs", **SHARDED["dttbs"], device=CPU)
    st = init_sharded_state(sampler, mesh, {"x": torch.zeros(2), "y": torch.zeros(())})
    drtbs = make_sampler("drtbs", **SHARDED["drtbs"], device=CPU)
    dst = init_sharded_state(drtbs, mesh, {"x": torch.zeros(2), "y": torch.zeros(())})
    calls = {"dttbs.size_global": lambda: sampler.size_global(prng.key(0), st),
             "dttbs.extract_global": lambda: sampler.extract_global(prng.key(0), st),
             "drtbs.size_global": lambda: drtbs.size_global(prng.key(0), dst),
             "drtbs.step": lambda: drtbs.step(prng.key(0), dst, {"x": torch.zeros(1, 4, 2),
                                                                 "y": torch.zeros(1, 4)},
                                              torch.ones(1, dtype=torch.int64)),
             "psum": lambda: distributed.psum(st.count),
             "gather_tree": lambda: distributed.gather_tree(st)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def run(device, out_dir):
    """A rank's entry: every case over the world group, saved to
    ``out_dir/rank<r>.pt``."""
    mesh = make_data_mesh(S, device=device, group=torch.distributed.group.WORLD)
    res = run_cases(mesh, Path(out_dir) / "ckpt")
    res["no_axis"] = case_no_axis(mesh)
    torch.save(res, Path(out_dir) / f"rank{mesh.rank}.pt")
