"""The port's dry-run grid and sharding rules (``config.cells``,
``zoo.input_specs``, ``sharding``, ``launch/mesh``'s logical meshes)
against the JAX package's on the CPU.

JAX's parameter and cache trees come from ``jax.eval_shape`` at full size,
the port's from the meta device. The port keeps each layer stack as a list
of per-layer trees where JAX stacks them on a leading layer axis, so a JAX
leaf [L, ...] with spec (None, *s) is L port leaves [...] with spec s;
every other leaf compares as it is. Bytes per device compare as sums over
the tree. Nothing here imports ``repro.launch.dryrun`` (it sets XLA_FLAGS
at import).
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro import config as jc
from repro import sharding as jsh
from repro.models import zoo as jzoo
from repro_torch import config as tc
from repro_torch import sharding as tsh
from repro_torch.convert import _STACKS
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import zoo as tzoo

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model")),
          "host42": ((4, 2), ("data", "model"))}
CELLS = list(jc.cells(include_skipped=True))
DECODE_CELLS = [(a, s) for a, s, skip in CELLS if not skip and jc.SHAPES[s].kind == "decode"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, axes = MESHES[name]
    tm = tmesh.make_mesh(shape, axes)
    return tm, tsh.mesh_info(tm), jsh.MeshInfo(axis_names=axes, axis_sizes=dict(zip(axes, shape)))


def _jax_cfg(tcfg):
    return jc.ModelConfig(**dataclasses.asdict(tcfg))


def _spec(spec):
    """A spec's entries, a tuple of one axis name as the name (JAX's
    normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _names(path):
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def _jax_bytes(leaf, spec, mi):
    n = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n *= mi.axis_sizes[ax]
    return math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize // n


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(JAX's abstract params, the port's meta params) at full size."""
    jp = jax.eval_shape(jzoo.build(jc.get_config(arch)).init_params, jax.random.key(0))
    tp = tzoo.build(tc.get_config(arch)).init_params(0, device="meta")
    return jp, tp


def test_production_meshes_are_jax_shapes():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.size) == ((16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == ((2, 16, 16),
                                                           ("pod", "data", "model"), 512)
    host = tmesh.make_host_mesh(4, 2)
    mi = tsh.mesh_info(host)
    assert (mi.tp, mi.fsdp, mi.batch_axes) == (2, 4, ("data",))
    assert tsh.mesh_info(multi).batch_axes == ("pod", "data")
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data",))


def test_cells_equal_jax():
    got = list(tc.cells(include_skipped=True))
    assert got == CELLS and len(got) == 40
    assert sum(skip is not None for _, _, skip in got) == 7
    assert list(tc.cells()) == list(jc.cells())


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in CELLS])
def test_input_specs_equal_jax(arch, shape):
    want = jzoo.input_specs(jc.get_config(arch), jc.SHAPES[shape])
    got = tzoo.input_specs(tc.get_config(arch), tc.SHAPES[shape])
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert (tuple(v.shape), str(v.dtype).split(".")[1]) == (tuple(want[k].shape),
                                                                str(want[k].dtype))


@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_head_mode_equal_jax(arch):
    for tp in (1, 2, 4, 8, 16):
        assert tsh.head_mode(tc.get_config(arch), tp) == jsh.head_mode(jc.get_config(arch), tp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_param_pspecs_equal_jax_leaf_for_leaf(arch, mesh):
    _, tmi, jmi = _meshes(mesh)
    jp, tp = _trees(arch)
    jspecs = jsh.param_pspecs(jc.get_config(arch), jp, jmi)
    tspecs = tsh.param_pspecs(tc.get_config(arch), tp, tmi)
    want = {}
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]):
        names = _names(path)
        stacked = names[0] in _STACKS
        want[tuple(names)] = (tuple(leaf.shape), _spec(spec), stacked)
    got = {}
    from torch.utils import _pytree as pytree
    tleaves = pytree.tree_flatten_with_path(tp)[0]
    sleaves = pytree.tree_leaves(tspecs, is_leaf=lambda x: isinstance(x, tsh.P))
    assert len(tleaves) == len(sleaves)
    for (path, leaf), spec in zip(tleaves, sleaves):
        names = _names(path)
        if names[0] in _STACKS:         # drop the layer index of the list
            names = [names[0]] + names[2:]
        got.setdefault(tuple(names), []).append((tuple(leaf.shape), _spec(spec)))
    assert set(got) == set(want)
    for key, (shape, spec, stacked) in want.items():
        if stacked:
            assert spec[0] is None
            assert got[key] == [(shape[1:], spec[1:])] * shape[0], key
        else:
            assert got[key] == [(shape, spec)], key
    jbytes = sum(_jax_bytes(leaf, spec, jmi) for leaf, spec in zip(
        jax.tree_util.tree_leaves(jp),
        jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    assert tsh.tree_bytes_per_device(tp, tspecs, tmi) == jbytes


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_specs_equal_jax(arch, shape, mesh):
    """batch_pspecs, cache_pspecs and logits_pspec under the config the
    port's ``build_cell`` makes (kv_replication where JAX's would set it),
    the caches against JAX's stacked tree (``scan_layers``)."""
    tm, tmi, jmi = _meshes(mesh)
    tcfg, tshape, _ = dryrun.cell_config(arch, shape, tm, overrides=dryrun.BASE_OVERRIDES)
    jcfg = _jax_cfg(tcfg)
    B, S = tshape.global_batch, tshape.seq_len
    jcache = jax.eval_shape(lambda: jzoo.build(jcfg).init_decode_state(
        B, max_len=S + 1, prefill_len=S))
    assert jcfg.scan_layers
    tcache = tsh.cache_layout(tzoo.build(tcfg).init_decode_state(B, S + 1, S, device="meta"))
    jspecs = jsh.cache_pspecs(jcfg, jcache, jmi)
    tspecs = tsh.cache_pspecs(tcfg, tcache, tmi)
    is_p = lambda x: isinstance(x, (jax.sharding.PartitionSpec, tsh.P))  # noqa: E731
    from torch.utils import _pytree as pytree
    want = [(tuple(leaf.shape), str(leaf.dtype), _spec(spec)) for leaf, spec in zip(
        jax.tree_util.tree_leaves(jcache), jax.tree_util.tree_leaves(jspecs, is_leaf=is_p))]
    got = [(tuple(leaf.shape), str(leaf.dtype).split(".")[1], _spec(spec)) for leaf, spec in zip(
        pytree.tree_leaves(tcache), pytree.tree_leaves(tspecs, is_leaf=is_p))]
    assert got == want
    jb = sum(_jax_bytes(leaf, spec, jmi) for leaf, spec in zip(
        jax.tree_util.tree_leaves(jcache), jax.tree_util.tree_leaves(jspecs, is_leaf=is_p)))
    assert tsh.tree_bytes_per_device(tcache, tspecs, tmi) == jb
    jtok = {"tok": jax.ShapeDtypeStruct((B, 1), np.int32)}
    ttok = {"tok": torch.empty((B, 1), dtype=torch.int32, device="meta")}
    assert _spec(tsh.batch_pspecs(tcfg, ttok, tmi)["tok"]) == _spec(
        jsh.batch_pspecs(jcfg, jtok, jmi)["tok"])
    tin = tzoo.input_specs(tcfg, tshape)
    jin = jzoo.input_specs(jcfg, jc.ShapeConfig(**dataclasses.asdict(tshape)))
    assert {k: _spec(v) for k, v in tsh.batch_pspecs(tcfg, tin, tmi).items()} == {
        k: _spec(v) for k, v in jsh.batch_pspecs(jcfg, jin, jmi).items()}
    assert _spec(tsh.logits_pspec(tmi)) == _spec(jsh.logits_pspec(jmi))


def test_bytes_per_device_divides_by_the_named_axes():
    _, mi, _ = _meshes("multi")
    t = torch.empty((64, 32, 8), dtype=torch.bfloat16, device="meta")
    assert tsh.shard_width(tsh.P(("pod", "data"), None, "model"), mi) == 512
    assert tsh.P(("data",), None) == ("data", None)
    assert tsh.bytes_per_device(t, tsh.P(("pod", "data"), None, "model"), mi) == 64 * 32 * 8 * 2 // 512
    assert tsh.bytes_per_device(t, tsh.P(None, None, None), mi) == 64 * 32 * 8 * 2
    assert repr(tsh.P("data", None)) == "P('data', None)"


def test_meta_params_and_caches_are_shapes_only():
    """``init_params`` / ``init_decode_state`` on the meta device: the
    shapes and dtypes of the CPU route, no data."""
    cfg = tc.get_smoke_config("zamba2_2p7b")
    api = tzoo.build(cfg)
    meta, cpu = api.init_params(0, device="meta"), api.init_params(0, device="cpu")
    from torch.utils import _pytree as pytree
    for m, c in zip(pytree.tree_leaves(meta), pytree.tree_leaves(cpu), strict=True):
        assert m.device.type == "meta" and (m.shape, m.dtype) == (c.shape, c.dtype)
    state = api.init_decode_state(2, 9, 8, device="meta")
    caches = tsh.cache_layout(state)
    G = cfg.num_layers // cfg.attn_every
    assert tuple(caches["ssm"]["state"].shape[:3]) == (G, cfg.attn_every, 2)
    assert caches["kv"]["length"].dtype == torch.int32
    assert tuple(caches["kv"]["length"].shape) == (G,)


@pytest.mark.parametrize("arch", ["stablelm_12b", "mamba2_370m", "zamba2_2p7b",
                                  "whisper_large_v3"])
@pytest.mark.parametrize("scan", [True, False])
def test_cache_layout_equals_jax_trees(arch, scan):
    """The port's one cache layout against JAX's trees at smoke size: its
    stacked tree (``scan_layers``) leaf for leaf in flatten order; its
    unrolled tree (a list of layers) in bytes per device under
    ``cache_pspecs`` on the (4, 2) mesh, the specs putting None on the
    layer axis."""
    tcfg = tc.get_smoke_config(arch)
    jcfg = dataclasses.replace(_jax_cfg(tcfg), scan_layers=scan)
    jcache = jax.eval_shape(lambda: jzoo.build(jcfg).init_decode_state(4, max_len=9,
                                                                       prefill_len=8))
    tcache = tsh.cache_layout(tzoo.build(tcfg).init_decode_state(4, 9, 8, device="meta"))
    from torch.utils import _pytree as pytree
    tleaves, jleaves = pytree.tree_leaves(tcache), jax.tree_util.tree_leaves(jcache)
    if scan:
        assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in tleaves] \
            == [(tuple(j.shape), str(j.dtype)) for j in jleaves]
        return
    assert len(jleaves) > len(tleaves)
    assert sum(math.prod(t.shape) for t in tleaves) == sum(math.prod(j.shape) for j in jleaves)
    _, tmi, jmi = _meshes("host42")
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    jb = sum(_jax_bytes(leaf, spec, jmi) for leaf, spec in zip(
        jleaves, jax.tree_util.tree_leaves(jsh.cache_pspecs(jcfg, jcache, jmi), is_leaf=is_p)))
    assert jb > 0 and tsh.tree_bytes_per_device(
        tcache, tsh.cache_pspecs(tcfg, tcache, tmi), tmi) == jb
