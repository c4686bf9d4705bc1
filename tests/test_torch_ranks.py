"""The port's Sec. 5 schemes over a process group, one reservoir shard a
rank (``repro_torch.core.distributed.GroupAxis``), against the stacked form
(every shard a row of one process's state), which the other sharded tests
hold against JAX.

Four gloo ranks start once for the module (``repro_torch.launch.ranks.
spawn``, ``file://`` init under the test's temporary directory, one thread
a rank) and run every case of ``tests/_torch_ranks_worker.py``; the test
runs the same cases on the stacked mesh. Rank r's state, params and trace
equal row r of the stacked form's bit for bit, on every path: the D-R-TBS
step on both Alg. 2 branches, D-T-TBS, the global realization and extract
with the partial item, the sharded run loop (fused == per-tick == resumed
across a checkpoint rank 0 writes), the controller, the farm and the
key-sharded bank loop. The W / C trajectories equal JAX's vmapped loop's,
and the LM driver runs under ``torch.distributed.run`` over 2 ranks.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_ranks_worker as W
from repro.core.api import make_sampler as j_make_sampler
from repro.data.streams import LinRegStream as JLinRegStream
from repro.manage import loop as jloop
from repro.manage import make_model as j_make_model
from repro.manage import materialize_stream as j_materialize
from repro.manage import shard_stream as j_shard_stream
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core import distributed
from repro_torch.core.api import make_sampler
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_data_mesh

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CPU = "cpu"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every rank's results, from one start of 4 gloo ranks, and the
    stacked form's, run in this process while the ranks run."""
    out = tmp_path_factory.mktemp("ranks")
    failed = []

    def start():
        try:
            ranks.spawn("_torch_ranks_worker:run", W.S, args=(str(out),), path=[HERE],
                        timeout=300, log_dir=out / "logs")
        except Exception as e:      # noqa: BLE001  (raised below, in the test's thread)
            failed.append(e)

    th = threading.Thread(target=start)
    th.start()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stacked = W.run_cases(make_data_mesh(W.S, device=CPU),
                              tmp_path_factory.mktemp("stacked"))
    finally:
        torch.set_num_threads(prev)
        th.join()
    if failed:
        raise failed[0]
    return (out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(W.S)],
            stacked)


@pytest.fixture(scope="module")
def ranked(both):
    return both[:2]


@pytest.fixture(scope="module")
def stacked(both):
    return both[2]


def _same(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.shape, y.shape)
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        if x.is_floating_point():
            assert torch.equal(x.isnan(), y.isnan())


def _row(tree, r, dim=0):
    return pytree.tree_map(lambda a: a.narrow(dim, r, 1), tree)


def test_drtbs_step_equals_the_stacked_rows_on_both_branches(ranked, stacked):
    """Every tick of a stream through the unsaturated path (overshoots
    included), the saturated path and an undershoot after empty ticks, with
    an int, an f32 and a bf16 leaf: rank r's state is the stacked state's
    row r, the partial item included."""
    _, res = ranked
    want = stacked["step"]["drtbs"]
    n, W_, C_ = W.STEP["n"], [float(s.total_weight[0]) for s in want], \
        [float(s.weight[0]) for s in want]
    sat = [w >= n for w in W_]
    assert not sat[0] and any(sat) and any(sat[i] and not sat[i + 1] for i in range(len(sat) - 1))
    assert any(C_[i] == n and (i == 0 or not sat[i - 1]) for i in range(len(C_)))  # overshoot
    assert any(0 < c - math.floor(c) for c in C_)                              # a partial item
    for r in range(W.S):
        for t, st in enumerate(res[r]["step"]["drtbs"]):
            _same(st, _row(want[t], r))


def test_dttbs_steps_and_global_view_equal_the_stacked_rows(ranked, stacked):
    _, res = ranked
    want = stacked["step"]
    for r in range(W.S):
        got = res[r]["step"]
        for t, st in enumerate(got["dttbs"]):
            _same(st, _row(want["dttbs"][t], r))
        for k in ("dttbs_view", "dttbs_realize", "dttbs_size"):
            _same(got[k], want[k])


def test_realize_and_extract_global_with_the_partial_item(ranked, stacked):
    """Each shard's realization is the stacked one's row r; the global
    realization, the packed view through B2 and the size are the stacked
    ones on every rank, the partial item taken on some keys and not on
    others."""
    _, res = ranked
    want = stacked["realize"]
    takes = [bool(w["global"][1][-1]) for w in want]
    assert any(takes) and not all(takes)
    for r in range(W.S):
        for g, w in zip(res[r]["realize"], want):
            _same(g["shard"], _row(w["shard"], r))
            _same(g["extract"].items, _row(w["extract"].items, r))
            _same((g["extract"].mask, g["extract"].size), _row((w["extract"].mask,
                                                                 w["extract"].size), r))
            _same((g["global"], g["view"], g["size"]), (w["global"], w["view"], w["size"]))


@pytest.mark.parametrize("scheme", sorted(W.SHARDED))
def test_sharded_run_loop_fused_per_tick_resumed_equal_the_stacked_rows(ranked, stacked,
                                                                        scheme):
    """The worker raised unless fused == per-tick == resumed across the
    gathered snapshots rank 0 wrote; the fused run is the stacked one's
    rows, and the last snapshot restores into the stacked run's state."""
    out, res = ranked
    st_w, p_w, tr_w = stacked["loop"][scheme]
    for r in range(W.S):
        st, p, tr = res[r]["loop"][scheme]
        _same(st, _row(st_w, r))
        _same((p, tr), (p_w, tr_w))
    snap, params, t = restore_checkpoint(out / "ckpt" / scheme, 12, (st_w, p_w, 0))
    assert t == 12
    _same((snap, params), (st_w, p_w))


def test_controlled_run_equals_the_stacked_rows(ranked, stacked):
    _, res = ranked
    st_w, p_w, tr_w = stacked["controller"]
    assert "decay" in tr_w
    for r in range(W.S):
        st, p, tr = res[r]["controller"]
        _same(st, _row(st_w, r))
        _same((p, tr), (p_w, tr_w))


def test_farm_equals_the_stacked_rows(ranked, stacked):
    _, res = ranked
    st_w, p_w, tr_w = stacked["farm"]
    assert st_w.nfull.shape == (3, W.S)
    for r in range(W.S):
        st, p, tr = res[r]["farm"]
        _same(st, _row(st_w, r, 1))
        _same((p, tr), (p_w, tr_w))


@pytest.mark.parametrize("case", ["rtbs_False", "ttbs_True"])
def test_key_sharded_bank_loop_equals_the_stacked_rows(ranked, stacked, case):
    """Each rank's bank, fits and trace (its keys' sizes, its overflow, the
    shared metric or its keys' own) are the stacked loop's row r."""
    _, res = ranked
    want = stacked["bank"][case]
    for r in range(W.S):
        _same(res[r]["bank"][case], _row(want, r))


def test_wc_trajectories_equal_jax_vmapped_loop(ranked, stacked):
    """The ranks' C_t and W_t on tests/test_torch_sharded_loop.py's stream
    equal JAX's vmapped tick on every tick (and the stacked form's), the
    final W and C JAX's whole vmapped loop's, the sizes within {floor C_t,
    floor C_t + 1}, and the metric NaN only on an empty tick."""
    _, res = ranked
    S, T, sizes = W.S, len(W.WC_SIZES), W.WC_SIZES
    jb, jc = j_materialize(JLinRegStream(seed=0), T, batch_size=lambda t: sizes[t])
    jb, jc = j_shard_stream(jb, jc, S)
    js_, jm = j_make_sampler("drtbs", **W.WC_HYPER), j_make_model("linreg", dim=2)
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
    for r in range(S):
        Wt, Ct, size, metric, st = res[r]["wc"]
        np.testing.assert_array_equal(Wt.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(Ct.numpy(), np.asarray(jC))
        _same((Wt, Ct, size, metric), stacked["wc"][:4])
        _same(st, _row(stacked["wc"][4], r))
        assert (np.floor(Ct.numpy()) <= size.numpy()).all()
        assert (size.numpy() <= np.floor(Ct.numpy()) + 1).all()
        assert torch.isnan(metric).tolist() == [s == 0 for s in sizes]
        np.testing.assert_array_equal(st.total_weight.numpy(),
                                      np.asarray(jfinal.total_weight)[0][r:r + 1])
        np.testing.assert_array_equal(st.weight.numpy(), np.asarray(jfinal.weight)[0][r:r + 1])
        assert int(st.overflow.sum()) == 0


def test_group_axis_gathers_every_dtype_and_refuses_a_wrong_state(ranked):
    """The stacked axis's collectives are the identity; a state whose shard
    dimension is not the mesh's local count is refused."""
    ax = distributed.StackedAxis(3)
    x = torch.arange(6).reshape(2, 3)
    assert ax.all_gather(x) is x and torch.equal(ax.psum(x), x.sum(-1))
    assert ax.all_gather_many((x, x))[1] is x and ax.mine(x) is x
    with pytest.raises(ValueError, match="holds 3 shard"):
        distributed.resolve_axis(ax, 4)
    assert distributed.resolve_axis(None, 5).size == 5      # no process group here
    sampler = make_sampler("drtbs", n=8, lam=0.2, cap_s=16, device=CPU)
    bound = sampler.over(ax)
    assert sampler.axis is None and bound.axis is ax and bound.over(ax) is bound
    assert repr(bound) == repr(sampler)
    with pytest.raises(ValueError, match="not a distributed scheme"):
        make_sampler("rtbs", n=8, lam=0.2, device=CPU).over(ax)


def test_a_rank_that_names_no_axis_raises(ranked):
    """On a rank of a process group, a sampler made without ``axis=`` and
    the module's collectives without one raise: no call quietly runs on the
    stacked axis over the rank's one shard."""
    _, res = ranked
    for r in range(W.S):
        got = res[r]["no_axis"]
        assert set(got) == {"dttbs.size_global", "dttbs.extract_global", "drtbs.size_global",
                            "drtbs.step", "psum", "gather_tree"}
        for call, msg in got.items():
            assert msg is not None and "pass axis=" in msg, (r, call, msg)


EXAMPLE = ["--shards", "2", "--ticks", "6"]
DRIVER = ["--arch", "mamba2_370m", "--preset", "smoke", "--scheme", "drtbs", "--shards", "2",
          "--batch-per-tick", "8", "--reservoir", "16", "--retrain-every", "2",
          "--retrain-steps", "1", "--train-batch", "4", "--seq-len", "16", "--ckpt-every", "2",
          "--lr", "1e-3"]


def test_driver_under_torch_distributed_run_over_two_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2`` of the LM
    driver at --preset smoke: each rank's log equals the one-process run's,
    rank 0's checkpoint (the gathered snapshot) equals the one-process
    run's byte for byte, and a run stopped at tick 2 and resumed to 4 over
    the ranks ends on the same checkpoint. The same ranks then run
    examples_torch/distributed_reservoir.py, each its row of the
    one-process run."""
    script = tmp_path / "drive.py"
    script.write_text(textwrap.dedent("""\
        import json, os, sys
        import torch
        import distributed_reservoir
        from repro_torch.launch.train import main
        torch.set_num_threads(1)
        out, argv = sys.argv[1], sys.argv[2:]
        logs = [main(argv + ["--ticks", "4", "--ckpt-dir", out + "/a"], device="cpu"),
                main(argv + ["--ticks", "2", "--ckpt-dir", out + "/b"], device="cpu"),
                main(argv + ["--ticks", "4", "--ckpt-dir", out + "/b", "--resume"],
                     device="cpu")]
        with open(os.path.join(out, "log%s.json" % os.environ["RANK"]), "w") as f:
            json.dump(logs, f)
        example = distributed_reservoir.main(EXAMPLE + ["--device", "cpu"])
        torch.save(example, os.path.join(out, "example%s.pt" % os.environ["RANK"]))
        """).replace("EXAMPLE", repr(EXAMPLE)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT / "examples_torch"),
                                                       os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", str(script), str(tmp_path)] + DRIVER
    done = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    logs = [json.loads((tmp_path / f"log{r}.json").read_text()) for r in range(2)]
    assert logs[0] == logs[1]
    full, _, resumed = logs[0]
    assert resumed == full[2:] and len(full) == 4

    from repro_torch.launch.train import main

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = main(DRIVER + ["--ticks", "4", "--ckpt-dir", str(tmp_path / "one")], device="cpu")
    finally:
        torch.set_num_threads(prev)
    assert one == full
    a = (tmp_path / "a" / "step_4" / "leaves.npz").read_bytes()
    assert a == (tmp_path / "one" / "step_4" / "leaves.npz").read_bytes()
    assert a == (tmp_path / "b" / "step_4" / "leaves.npz").read_bytes()
    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        import distributed_reservoir
    finally:
        sys.path.remove(str(ROOT / "examples_torch"))
    st, p, tr = distributed_reservoir.main(EXAMPLE + ["--device", "cpu"])
    for r in range(2):
        rst, rp, rtr = torch.load(tmp_path / f"example{r}.pt", weights_only=False)
        _same(rst, _row(st, r))
        _same((rp, rtr), (p, tr))


@pytest.mark.parametrize("dev, local, cards, want", [
    ("cpu", 4, 0, "gloo"), ("cpu", 1, 1, "gloo"), ("cuda:0", 4, 1, "gloo"),
    ("cuda:0", 1, 1, "nccl"), ("cuda:3", 8, 8, "nccl"), ("cuda:1", 8, 4, "gloo")])
def test_backend_follows_where_the_ranks_run(monkeypatch, dev, local, cards, want):
    """gloo on the CPU and where a host's ranks outnumber its cards (NCCL
    refuses two ranks on one GPU), NCCL with a card a rank."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert ranks.backend_for(torch.device(dev)) == want
