"""B2, reservoir compaction, on the CPU: the port's wrapper takes every leaf
of a sample and one mask in one call (one kernel launch on the card); its
plain path here is held bit for bit against the JAX package's
``compact_items`` and its ``reservoir_compact`` routes (``"ref"`` and the
Pallas kernel in ``"interpret"`` mode), on the callers' masks. Also the
port's ``materialize_view`` against JAX's, and the leaf tables the payload
kernels share (``kernels._common.check_leaves`` / ``plan``) as pure
functions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import latent as jl
from repro.kernels.reservoir_compact import ops as jrc
from repro_torch.core import api as tapi
from repro_torch.core import latent as tl
from repro_torch.kernels import _common
from repro_torch.kernels.reservoir_compact import bench, ops, ref

# x f32[., 2], y f32, i8[., 3], bf16, bool: one leaf of each kind
LEAVES = {"x": ((2,), np.float32), "y": ((), np.float32), "i8": ((3,), np.int8),
          "bf16": ((), "bf16"), "bool": ((), np.bool_)}
MASKS = ["uniform", "prefix", "block", "none", "all"]


def _leaves(cap: int, seed: int):
    """The same finite leaves for both packages: numpy (bf16 as its f32
    values), then JAX arrays and torch tensors of the leaf dtypes."""
    rs = np.random.RandomState(seed)
    jax_items, torch_items = {}, {}
    for k, (tail, dt) in LEAVES.items():
        shape = (cap,) + tail
        if dt == np.bool_:
            a = rs.rand(*shape) < 0.5
        elif dt == np.int8:
            a = rs.randint(-128, 128, shape).astype(np.int8)
        else:
            a = rs.randn(*shape).astype(np.float32)
        if dt == "bf16":
            jax_items[k] = jnp.asarray(a).astype(jnp.bfloat16)
            torch_items[k] = torch.from_numpy(a).to(torch.bfloat16)
            assert np.array_equal(np.asarray(jax_items[k].astype(jnp.float32)),
                                  torch_items[k].float().numpy())
        else:
            jax_items[k] = jnp.asarray(a)
            torch_items[k] = torch.from_numpy(a)
    return jax_items, torch_items


def _np(x):
    """A leaf of either package as numpy, bf16 as its f32 values."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _mask(kind: str, cap: int, seed: int) -> torch.Tensor:
    return bench.case_mask(kind, cap, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("cap", [1, 127, 1025, 4097])
def test_tree_compaction_equals_jax(cap, kind):
    """Exact: every leaf of the sample in one call against JAX's
    ``compact_items``, leaf by leaf against the Pallas kernel in interpret
    mode and the JAX oracle, and the count against the mask."""
    jitems, titems = _leaves(cap, cap)
    mask = _mask(kind, cap, cap + 1)
    jmask = jnp.asarray(mask.numpy())
    got, cnt = ops.reservoir_compact(titems, mask)
    assert cnt.dtype == torch.int32 and cnt.dim() == 0 and int(cnt) == int(mask.sum())
    want = jl.compact_items(jitems, jmask)
    for k in LEAVES:
        assert got[k].dtype == titems[k].dtype and got[k].shape == titems[k].shape
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
        flat = jitems[k].reshape(cap, -1)
        for impl in ("interpret", "ref"):
            w, wc = jrc.reservoir_compact(flat, jmask, impl=impl)
            assert int(wc) == int(cnt)
            np.testing.assert_array_equal(_np(got[k]).reshape(cap, -1), _np(w),
                                          err_msg=f"{k} {impl}")


@pytest.mark.parametrize("kind", ["uniform", "block"])
def test_single_leaf_call_keeps_its_signature(kind):
    """A tensor in, a tensor and the count out: the one-leaf call of the
    same wrapper, equal to the leaf of a tree call and to ``compact_ref``."""
    cap = 1025
    _, titems = _leaves(cap, 3)
    mask = _mask(kind, cap, 4)
    tree, cnt = ops.reservoir_compact(titems, mask)
    for k, x in titems.items():
        out, c = ops.reservoir_compact(x, mask)
        assert isinstance(out, torch.Tensor) and int(c) == int(cnt)
        assert torch.equal(out, tree[k])
        want, wc = ref.compact_ref(x.reshape(cap, -1), mask)
        assert torch.equal(out, want.reshape(x.shape)) and int(wc) == int(c)


def test_tree_structure_and_edges():
    """Lists and nested trees keep their structure; rows of 0 bytes and an
    empty tree still give the count; the kept rows come first, in order,
    and the rest is zero."""
    cap = 9
    mask = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0, 1]).bool()
    x = torch.arange(cap * 2, dtype=torch.float32).reshape(cap, 2)
    (a, (b,)), cnt = ops.reservoir_compact([x, (x[:, 0].to(torch.int64),)], mask)
    assert int(cnt) == 5
    assert a[:5].tolist() == [[0, 1], [6, 7], [8, 9], [12, 13], [16, 17]] and not a[5:].any()
    assert b.tolist() == [0, 6, 8, 12, 16, 0, 0, 0, 0]
    out, cnt = ops.reservoir_compact({}, mask)
    assert out == {} and int(cnt) == 5
    out, cnt = ops.reservoir_compact(torch.zeros(cap, 0), mask)
    assert out.shape == (cap, 0) and int(cnt) == 5
    out, cnt = ops.reservoir_compact(torch.zeros(0, 3), torch.zeros(0, dtype=torch.bool))
    assert out.shape == (0, 3) and int(cnt) == 0


@pytest.mark.parametrize("items,mask,err", [
    ({"x": torch.zeros(5, 2)}, torch.ones(5), ValueError),             # not bool
    ({"x": torch.zeros(5, 2)}, torch.ones(5, 1).bool(), ValueError),   # not [cap]
    ({"x": torch.zeros(5, 2), "y": torch.zeros(6)}, torch.ones(5).bool(), ValueError),
    ({"x": torch.zeros(())}, torch.ones(5).bool(), ValueError),        # no row dim
])
def test_wrapper_refuses_what_it_cannot_pack(items, mask, err):
    with pytest.raises(err, match="reservoir_compact"):
        ops.reservoir_compact(items, mask)


@pytest.mark.parametrize("c", [5.7, 3.0, 0.4])
def test_materialize_view_equals_jax(c):
    """The port's ``materialize_view`` against JAX's on the same realized
    sample (the same latent sample and mask): dense prefix, mask and size."""
    cap = 12
    rs = np.random.RandomState(int(c * 10))
    x = rs.randn(cap, 2).astype(np.float32)
    y = rs.randint(-50, 50, cap).astype(np.int32)
    lat = tl.Latent(items={"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                    nfull=torch.tensor(int(c)), weight=torch.tensor(np.float32(c)))
    mask, size = tl.realize(torch.tensor(np.float32(0.3)), lat)
    # a scattered view, as the distributed global extract gives: the kept
    # rows spread over the buffer
    perm = torch.from_numpy(rs.permutation(cap))
    mask = mask[perm]
    tview = tapi.materialize_view(tapi.SampleView(items=lat.items, mask=mask, size=size))
    jview = japi.materialize_view(japi.SampleView(
        items={"x": jnp.asarray(x), "y": jnp.asarray(y)}, mask=jnp.asarray(mask.numpy()),
        size=jnp.int32(int(size))))
    for k in ("x", "y"):
        np.testing.assert_array_equal(tview.items[k].numpy(), np.asarray(jview.items[k]))
    np.testing.assert_array_equal(tview.mask.numpy(), np.asarray(jview.mask))
    assert int(tview.size) == int(jview.size) == int(mask.sum())


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_payload_kernels_share_one_leaf_table():
    """B1's and B3's wrapper and B2's take ``check_leaves``, ``plan`` and
    ``MAX_LEAVES`` from ``kernels._common``: one copy."""
    from repro_torch.kernels.tbs_step import kernel as ts_kernel
    from repro_torch.kernels.tbs_step import ops as ts_ops

    assert ts_ops.check_leaves is _common.check_leaves and ts_ops.plan is _common.plan
    assert ts_kernel.MAX_LEAVES == _common.MAX_LEAVES == 8


def test_check_leaves_row_bytes_of_a_sample():
    """Exact: B2's use, each leaf against itself at lead (cap,): its row
    bytes, 400 for naive Bayes' f32[., 100] and 0 for an empty tail."""
    leaves = [_meta((7, 2)), _meta((7,)), _meta((7, 3), torch.int8), _meta((7,), torch.bfloat16),
              _meta((7,), torch.bool), _meta((7, 100)), _meta((7, 0)), _meta((7, 2, 5))]
    assert _common.check_leaves("f", leaves, leaves, (7,), (7,)) == [8, 4, 3, 2, 1, 400, 0, 40]
    with pytest.raises(ValueError, match="leaf 1"):
        _common.check_leaves("f", [_meta((7, 2)), _meta((8,))], [_meta((7, 2)), _meta((8,))],
                             (7,), (7,))


@pytest.mark.parametrize("row_bytes,ptrs,vec", [
    (8, (0, 256), 8),                 # x f32[., 2]
    (4, (0, 256), 4),                 # y f32
    (400, (0, 256), 16),              # naive Bayes' f32[., 100]: 25 16-byte words
    (400, (4, 256), 4),               # an offset view rules out 16 and 8
    (3, (0, 256), 1),                 # i8[., 3]
    (2, (0, 256), 2), (1, (0, 256), 1),
    (16, (0, 8), 8), (12, (0, 16), 4), (40, (0, 0), 8),
])
def test_plan_copy_width(row_bytes, ptrs, vec):
    """Exact: the widest of 16, 8, 4, 2, 1 bytes dividing the row and both
    of a leaf's pointers (items and out)."""
    assert _common.plan([row_bytes], [ptrs]) == [[(0, vec)]]


def test_plan_groups_past_the_table_and_drops_empty_rows():
    """Exact: leaves in order, at most MAX_LEAVES a launch; rows of 0 bytes
    are left out (a tree of only such leaves plans no table, and the
    wrapper then launches once for the count)."""
    n = _common.MAX_LEAVES
    widths = [8, 4, 0, 400, 3, 2, 1, 16, 12, 0, 8, 4]
    groups = _common.plan(widths, [(0, 1024)] * len(widths))
    assert [[i for i, _ in g] for g in groups] == [[0, 1, 3, 4, 5, 6, 7, 8], [10, 11]]
    assert dict(v for g in groups for v in g) == {0: 8, 1: 4, 3: 16, 4: 1, 5: 2, 6: 1,
                                                  7: 16, 8: 4, 10: 8, 11: 4}
    assert [len(g) for g in _common.plan([4] * (2 * n + 1), [()] * (2 * n + 1))] == [n, n, 1]
    assert _common.plan([0, 0], [(), ()]) == []



@pytest.mark.parametrize("row_bytes,ptrs,ok", [
    (16 * (2**19 - 1), (0, 256), True),      # 2^19 - 1 16-byte words: the widest row
    (16 * 2**19, (0, 256), False),           # 8 MiB rows at 16-byte words
    (2**19 - 1, (0, 256), True),             # odd bytes: 1-byte words
    (2**19 + 1, (0, 256), False),
    (4 * 2**19, (4, 256), False),            # an offset view: 4-byte words
])
def test_wrapper_refuses_rows_of_too_many_words(row_bytes, ptrs, ok):
    """Exact: B2's wrapper plans its tables like B1's and B3's, and refuses
    a leaf whose chunk of rows could not be indexed by word in 32 bits
    (kernel.MAX_ROW_WORDS words a row or more), before any launch."""
    if ok:
        assert ops.plan([8, row_bytes], [(0, 256), ptrs]) == _common.plan(
            [8, row_bytes], [(0, 256), ptrs])
    else:
        with pytest.raises(ValueError, match="leaf 1 has"):
            ops.plan([8, row_bytes], [(0, 256), ptrs])

def test_case_masks_are_the_callers():
    """The bench's masks: uniform near p = 0.6, the realized prefix, 8 shard
    prefixes each 15-35 % full, and the edges."""
    cap = 80_000
    g = torch.Generator().manual_seed(0)
    m = bench.case_mask("uniform", cap, g)
    assert abs(float(m.float().mean()) - 0.6) < 0.01
    m = bench.case_mask("prefix", cap, g)
    k = int(m.sum())
    assert m[:k].all() and not m[k:].any() and abs(k - 0.6 * cap) <= 1
    m = bench.case_mask("block", cap, g).reshape(bench.SHARDS, -1)
    fill = m.sum(1)
    assert all(m[s, :int(f)].all() and not m[s, int(f):].any() for s, f in enumerate(fill))
    assert ((fill >= 0.15 * m.shape[1] - 1) & (fill <= 0.35 * m.shape[1])).all()
    assert not bench.case_mask("none", cap, g).any() and bench.case_mask("all", cap, g).all()


def test_bound_bytes_counts_sectors_of_kept_rows():
    """Exact on small masks: the mask once, each 32-byte sector holding a
    kept row once, the whole output once."""
    mask = torch.zeros(64, dtype=torch.bool)
    assert bench.bound_bytes([4], mask) == 64 + 256
    mask[0] = mask[9] = True            # 4-byte rows: sectors 0 and 1
    assert bench.bound_bytes([4], mask) == 64 + 64 + 256
    assert bench.bound_bytes([400], mask) == 64 + 2 * 13 * 32 + 64 * 400
    mask[:] = True
    assert bench.bound_bytes([8, 4], mask) == 64 + 2 * 64 * 12
