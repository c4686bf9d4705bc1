"""The port's optimizer (``repro_torch.optim``: ``cosine_schedule``,
``adamw_init``, ``global_norm``, ``clip_by_global_norm``, ``adamw_update``)
against the JAX package's ``repro.optim`` on the CPU, from the same seeded
numpy trees.

Tolerances: the schedule is held against JAX's jitted one, equal but on
counted steps where the two libraries' f32 ``cos`` differ (C.12).
The global norm sums each leaf's squares in its library's order, so it is
held within 2 ulps, and a clipped gradient within its scale's ulps; XLA
contracts some of AdamW's moment updates into fused multiply-adds under
jit, so params and moments are held within a few ulps (ROADMAP C.12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.optim import adamw as jad
from repro.optim import schedule as jsc
from repro_torch.optim import adamw as tad
from repro_torch.optim import schedule as tsc


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    """A params-like tree whose dict keys are inserted in sorted order, so
    torch's flatten order is JAX's (which sorts keys): the global norm sums
    the leaves in that order in both."""
    blocks = [{"a": (rng.normal(size=(13,)) * scale).astype(np.float32),
               "b": (rng.normal(size=(3, 4, 5)) * scale).astype(np.float32)}
              for _ in range(2)]
    return {"blocks": blocks, "w": (rng.normal(size=(9, 7)) * scale).astype(np.float32),
            "z": (rng.normal(size=(1,)) * scale).astype(np.float32)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    """Fresh tensors (the port updates in place; numpy's memory stays put)."""
    return pytree.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _ulps(a, b) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _equal(jtree, ttree, rtol=0.0, atol=0.0):
    """Leaf by leaf: exact, or within ``rtol`` and ``atol``."""
    jl, tl = jax.tree_util.tree_leaves(jtree), pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if rtol:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# steps in [0, total + 12) where the port's schedule differs from JAX's
# jitted one, and by at most how many ulps: only the f32 cos of XLA:CPU and
# of torch differ there (ROADMAP C.12); the warm-up, the progress and the
# fused multiply-add are bit-equal
SCHEDULE_GAPS = {(2, 4000, 0.1): (119, 4), (0, 50, 0.1): (2, 2), (10, 37, 0.25): (1, 1),
                 (100, 100, 0.0): (0, 0)}


@pytest.mark.parametrize("warmup,total,min_frac", list(SCHEDULE_GAPS))
def test_cosine_schedule_equals_jax(warmup, total, min_frac):
    """Against JAX's schedule jitted (as the train step runs it) at every
    step from 0 to total + 11: equal but on the counted steps, which differ
    by at most the counted ulps; int32 device counts and Python ints give
    one result."""
    j = jax.jit(lambda s: jsc.cosine_schedule(s, warmup=warmup, total=total,
                                              min_frac=min_frac))
    steps = np.arange(total + 12)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps, jnp.int32)))
    got = tsc.cosine_schedule(torch.from_numpy(steps.astype(np.int32)), warmup=warmup,
                              total=total, min_frac=min_frac)
    assert got.dtype == torch.float32
    d = _ulps(got.numpy(), want)
    assert (int((d > 0).sum()), int(d.max())) == SCHEDULE_GAPS[(warmup, total, min_frac)]
    for s in (0, warmup, total, total + 3):
        assert tsc.cosine_schedule(s, warmup=warmup, total=total, min_frac=min_frac) == \
            got[s]


def test_adamw_init_layout():
    st = tad.adamw_init(_t(_tree(np.random.default_rng(0))))
    js = jad.adamw_init(_j(_tree(np.random.default_rng(0))))
    assert sorted(st) == sorted(js) == ["count", "m", "v"]
    assert st["count"].dtype == torch.int32 and st["count"].shape == ()
    _equal(js["m"], st["m"])
    assert len(pytree.tree_leaves(st)) == len(jax.tree_util.tree_leaves(js))


@pytest.mark.parametrize("max_norm,scale", [(1.0, 1.0), (100.0, 1.0), (0.5, 1e-3),
                                            (1.0, 0.0)])
def test_clip_by_global_norm_equals_jax(max_norm, scale):
    """The norm within 2 ulps (C.12). Unclipped leaves (norm below
    ``max_norm``, or an all-zero tree under the 1e-12 floor) exact; clipped
    ones within rtol 5e-7, the scale's ulps."""
    g = _tree(np.random.default_rng(1), scale)
    jg, jn = jax.jit(lambda t: jad.clip_by_global_norm(t, max_norm))(_j(g))
    tg, tn = tad.clip_by_global_norm(_t(g), max_norm)
    assert _ulps(tn.numpy(), np.asarray(jn)) <= 2
    assert _ulps(tad.global_norm(_t(g)).numpy(), np.asarray(jad.global_norm(_j(g)))) <= 2
    clipped = float(jn) > max_norm
    assert clipped == (max_norm == 1.0 and scale == 1.0)
    _equal(jg, tg, rtol=5e-7 if clipped else 0.0)


@pytest.mark.parametrize("seed,cfg", [
    (0, dict()), (1, dict(lr=3e-3, weight_decay=0.0)),
    (2, dict(lr=1e-2, b1=0.8, b2=0.99, eps=1e-6, clip_norm=0.3)),
    (3, dict(weight_decay=0.5, clip_norm=100.0))])
def test_adamw_update_equals_jax_over_steps(seed, cfg):
    """Six steps of JAX's jitted ``adamw_update`` and the port's from the
    same params and gradients, each fed its own package's cosine LR scale
    (equal on these steps): the count exact; grad_norm within 2 ulps
    (C.12); params and both moments within rtol 2e-6 and atol 1e-8 (values
    are O(1)): XLA contracts some of the moments' ``b * m + (1 - b) * g``
    into fused multiply-adds under jit (1-ulp gaps even where the clip
    leaves the gradients alone, ``clip_norm=100``), and a clipped step
    carries the scale's ulps; six steps keep them within a few ulps."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    jcfg, tcfg = jad.AdamWConfig(**cfg), tad.AdamWConfig(**cfg)
    jp, tp = _j(p0), _t(p0)
    jo, to = jad.adamw_init(jp), tad.adamw_init(tp)
    upd = jax.jit(lambda g, o, p, s: jad.adamw_update(jcfg, g, o, p, s))
    for k in range(6):
        g = _tree(rng, 0.5)
        js = jsc.cosine_schedule(jo["count"], warmup=2, total=40)
        ts = tsc.cosine_schedule(to["count"], warmup=2, total=40)
        jp, jo, jm = upd(_j(g), jo, jp, js)
        tp, to, tm = tad.adamw_update(tcfg, _t(g), to, tp, ts)
        tol = (2e-6, 1e-8)
        _equal(jp, tp, *tol)
        _equal(jo["m"], to["m"], *tol)
        _equal(jo["v"], to["v"], *tol)
        assert int(to["count"]) == int(jo["count"]) == k + 1
        assert to["count"].dtype == torch.int32
        assert _ulps(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"])) <= 2


def test_adamw_update_is_in_place_and_visits_keys_sorted():
    """f32 params and moments are updated in place (the returned tensors are
    the given ones), the count is new; a bf16 leaf is computed in f32 and
    copied back; and a dict's key insertion order does not change the step
    (leaves are visited as JAX visits them, keys sorted)."""
    tree = _tree(np.random.default_rng(4))
    grads = _tree(np.random.default_rng(5))
    p = _t(tree)
    o = tad.adamw_init(p)
    p2, o2, m2 = tad.adamw_update(tad.AdamWConfig(), _t(grads), o, p, 0.5)
    assert p2["w"] is p["w"] and o2["m"]["w"] is o["m"]["w"]
    assert int(o["count"]) == 0 and int(o2["count"]) == 1
    assert not torch.equal(p["w"], torch.from_numpy(tree["w"]))
    rev = {k: tree[k] for k in reversed(sorted(tree))}
    q = _t(rev)
    q2, _, n2 = tad.adamw_update(tad.AdamWConfig(), _t({k: grads[k] for k in rev}),
                                 tad.adamw_init(q), q, 0.5)
    assert list(q2) == sorted(tree) and float(n2["grad_norm"]) == float(m2["grad_norm"])
    for a, b in zip(pytree.tree_leaves(p2), pytree.tree_leaves(q2)):
        assert torch.equal(a, b)
    pb = {"w": torch.from_numpy(tree["w"]).to(torch.bfloat16)}
    want = tad.adamw_update(tad.AdamWConfig(), {"w": torch.from_numpy(grads["w"])},
                            tad.adamw_init({"w": pb["w"].float()}), {"w": pb["w"].float()})[0]
    got = tad.adamw_update(tad.AdamWConfig(), {"w": torch.from_numpy(grads["w"])},
                           tad.adamw_init(pb), pb)[0]
    assert got["w"].dtype == torch.bfloat16 and got["w"] is pb["w"]
    assert torch.equal(got["w"], want["w"].to(torch.bfloat16))
