"""The port's checkpoint store (``repro_torch.checkpoint``) against the
JAX package's ``repro.checkpoint`` on the CPU: the same layout
(``<dir>/step_<n>/manifest.json + leaves.npz``, atomic publish, pruning to
``keep``), leaves in ``jax.tree_util`` order, so a checkpoint either package
writes restores into the other's tree of the same structure, bit for bit.
Covers the LM driver's own tree (the SGD adapter's state in JAX's layout,
an R-TBS state, a controller state, the tick) through
``convert.train_checkpoint_*``, and the background writer's host copy.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.core.api import make_sampler as j_make_sampler
from repro.decay import loss_ratio as j_loss_ratio
from repro.models import zoo as jzoo
from repro import config as jconfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch import config as tconfig
from repro_torch import convert
from repro_torch.checkpoint import (AsyncCheckpointer, host_tree, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.core.rtbs import RTBSState
from repro_torch.decay import loss_ratio
from repro_torch.models import zoo as tzoo
from repro_torch.optim import adamw_init

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_equal(a, b):
    """JAX's tree ``a`` against ``b``: a numpy dict tree (flattened as JAX
    flattens it, keys sorted) or a port state of dataclasses (whose fields
    are JAX's, in order)."""
    la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, a))
    if isinstance(b, dict):
        lb = jax.tree_util.tree_leaves(b)
    else:
        lb = [x.numpy() for x in pytree.tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(y, x)


def test_atomic_publish_and_pruning(tmp_path):
    """Twin of tests/test_system.py::test_checkpoint_atomicity: a step dir
    exists whole or not at all (no temporary dir is left), and pruning keeps
    the newest ``keep``."""
    tree = {"a": torch.arange(5), "b": (torch.ones(2, 2), 3)}
    for s in [1, 2, 3, 4]:
        save_checkpoint(tmp_path, s, tree, keep=2)
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4"]
    assert latest_step(tmp_path / "none") is None
    back = restore_checkpoint(tmp_path, 4, tree)
    assert torch.equal(back["a"], torch.arange(5)) and back["a"].dtype == torch.int64
    assert back["b"][1] == 3 and isinstance(back["b"][1], int)
    man = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert man["num_leaves"] == 3 and man["dtypes"] == ["int32", "float32", "int64"]
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, 4, {"a": tree["a"]})


def test_save_overwrites_a_stale_temporary_dir(tmp_path):
    (tmp_path / ".tmp_step_7").mkdir(parents=True)
    (tmp_path / ".tmp_step_7" / "junk").write_text("x")
    save_checkpoint(tmp_path, 7, {"x": torch.zeros(3)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_7"]


def test_async_save_takes_its_copy_before_returning(tmp_path):
    """A tensor changed in place after ``save()`` returns does not change
    what was written; ``host_tree`` copies too."""
    t = torch.arange(6, dtype=torch.float32)
    st = RTBSState(lat=make_sampler("rtbs", n=3, lam=0.1, device=CPU).init(
        torch.zeros(2)).lat, total_weight=torch.tensor(1.5))
    ck = AsyncCheckpointer(tmp_path, keep=5)
    ck.save(1, {"t": t, "st": st})
    snap = host_tree({"t": t})
    t.add_(100.0)
    st.total_weight.fill_(-1.0)
    ck.wait()
    back = restore_checkpoint(tmp_path, 1, {"t": t, "st": st})
    assert back["t"].tolist() == list(range(6))
    assert float(back["st"].total_weight) == 1.5
    assert snap["t"].tolist() == list(range(6))
    assert ck.last_path.endswith("step_1")


def test_jax_tree_order_and_dtypes(tmp_path):
    """Leaves go out in JAX's order (dict keys sorted, dataclass fields in
    order, None as no leaf) and in its 32-bit layout (int64 as int32); a
    restore casts back to the tree's dtypes."""
    tree = {"z": torch.tensor([1, 2], dtype=torch.int64), "a": None,
            "m": [torch.tensor(2.5), torch.ones(2, dtype=torch.bfloat16)]}
    save_checkpoint(tmp_path, 0, tree)
    data = np.load(tmp_path / "step_0" / "leaves.npz")
    assert [data[f"leaf_{i}"].dtype for i in range(3)] == [np.float32, np.float32, np.int32]
    assert data["leaf_2"].tolist() == [1, 2]
    back = restore_checkpoint(tmp_path, 0, tree)
    assert back["a"] is None and back["z"].dtype == torch.int64
    assert back["m"][1].dtype == torch.bfloat16
    jback = j_restore(tmp_path, 0, {"z": 0, "a": None, "m": [0, 0]})
    assert np.asarray(jback["z"]).tolist() == [1, 2]


def _port_leaves(tree):
    """A port tree's tensors with dict keys sorted (insertion order is not
    structure)."""
    from repro_torch.optim.adamw import sorted_tree
    return pytree.tree_leaves(sorted_tree(tree))


def _smoke(arch="mamba2_370m"):
    jcfg = dataclasses.replace(jconfig.get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfig.get_smoke_config(arch), dtype="float32")
    return jcfg, tcfg, jzoo.build(jcfg)


def _jax_tree(jcfg, japi, controller: bool):
    """A JAX driver checkpoint tree: ``(model_state, rtbs state[, cstate],
    tick)`` after one sampler step, the params and moments perturbed."""
    params = japi.init_params(jax.random.key(0))
    opt = j_adamw_init(params)
    rng = np.random.default_rng(0)
    bump = lambda a: a + jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
    model_state = {"params": jax.tree_util.tree_map(bump, params),
                   "opt": {"m": jax.tree_util.tree_map(bump, opt["m"]),
                           "v": jax.tree_util.tree_map(bump, opt["v"]),
                           "count": jnp.int32(7)}}
    sampler = j_make_sampler("rtbs", n=6, lam=0.1)
    st = sampler.init(jax.ShapeDtypeStruct((8,), jnp.int32))
    st = sampler.step(jax.random.key(1), st,
                      jnp.asarray(rng.integers(0, 50, (4, 8)), jnp.int32), jnp.int32(4))
    tail = (j_loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0).init(),) if controller else ()
    return (model_state, st) + tail + (12,)


def _port_like(tcfg, controller: bool):
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device=CPU)
    ms = {"params": params, "opt": adamw_init(params)}
    st = make_sampler("rtbs", n=6, lam=0.1, device=CPU).init(
        torch.zeros((8,), dtype=torch.int32))
    cs = loss_ratio(lam0=0.1, lam_min=0.01, lam_max=1.0).init(CPU) if controller else None
    return ms, st, cs


@pytest.mark.parametrize("controller", [False, True])
def test_jax_checkpoint_restores_into_the_port(tmp_path, controller):
    jcfg, tcfg, japi = _smoke()
    jtree = _jax_tree(jcfg, japi, controller)
    j_save(tmp_path, 12, jtree)
    like = convert.train_checkpoint_like(*_port_like(tcfg, controller))
    ms, st, cs, tick = convert.train_checkpoint_from_numpy(
        tcfg, restore_checkpoint(tmp_path, 12, like), device=CPU)
    assert tick == 12
    assert st.lat.nfull.dtype == torch.int64       # the port's dtypes, JAX's numbers
    _leaves_equal(jtree[1], st)
    _leaves_equal(jtree[0]["params"], convert.lm_params_to_numpy(ms["params"]))
    _leaves_equal(jtree[0]["opt"]["m"], convert.lm_params_to_numpy(ms["opt"]["m"]))
    _leaves_equal(jtree[0]["opt"]["v"], convert.lm_params_to_numpy(ms["opt"]["v"]))
    assert int(ms["opt"]["count"]) == 7 and ms["opt"]["count"].dtype == torch.int32
    if controller:
        _leaves_equal(jtree[2], cs)


@pytest.mark.parametrize("controller", [False, True])
def test_port_checkpoint_restores_into_jax(tmp_path, controller):
    jcfg, tcfg, japi = _smoke()
    ms, st, cs = _port_like(tcfg, controller)
    st = make_sampler("rtbs", n=6, lam=0.1, device=CPU).step(
        prng.key(1), st,
        torch.arange(32, dtype=torch.int32).reshape(4, 8), torch.tensor(4))
    tree = convert.train_checkpoint_to_numpy(ms, st, cs, 9)
    save_checkpoint(tmp_path, 9, tree)
    jlike = _jax_tree(jcfg, japi, controller)[:-1] + (0,)
    back = j_restore(tmp_path, 9, jlike)
    assert int(back[-1]) == 9
    _leaves_equal(back[1], st)
    _leaves_equal(back[0]["params"], convert.lm_params_to_numpy(ms["params"]))
    assert np.asarray(back[0]["opt"]["count"]).dtype == np.int32
    if controller:
        _leaves_equal(back[2], cs)
    # and the port reads its own file back bit for bit
    like = convert.train_checkpoint_like(ms, st, cs)
    ms2, st2, cs2, t2 = convert.train_checkpoint_from_numpy(
        tcfg, restore_checkpoint(tmp_path, 9, like), device=CPU)
    assert t2 == 9
    assert (cs2 is None) == (cs is None)
    for a, b in zip(_port_leaves((ms, st, cs or ())), _port_leaves((ms2, st2, cs2 or ()))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sgd_state_round_trip():
    _, tcfg, _ = _smoke("stablelm_12b")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(3, device=CPU)
    ms = {"params": params, "opt": adamw_init(params)}
    back = convert.sgd_state_from_numpy(tcfg, convert.sgd_state_to_numpy(ms), device=CPU)
    for a, b in zip(_port_leaves(ms), _port_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
