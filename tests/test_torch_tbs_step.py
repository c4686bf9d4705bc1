"""The port's fused R-TBS tick against ``repro.core.rtbs`` and the JAX
``tbs_step`` kernel: B1's plain version is bit-equal to the kernel body;
``tick_map`` fed JAX's draws is bit-equal over streams that visit every
Alg. 2 branch; W_t/C_t are bit-equal with the decay factor fed; a JAX state
carried across mid-stream steps to the same state; Theorem 4.2 holds
through the leading trial dimension."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import id_stream, tick_draws
from repro.core import rtbs as jr
from repro.kernels.tbs_step import ops as jts_ops
from repro_torch import convert
from repro_torch.core import latent as tl
from repro_torch.core import prng
from repro_torch.core import rtbs as tr
from repro_torch.kernels.tbs_step import ops as ts_ops
from repro_torch.kernels.tbs_step import ref as ts_ref

PROTO = jax.ShapeDtypeStruct((), jnp.int32)
F32 = np.float32
STREAMS = [
    ([12, 0, 0, 3, 9, 1, 5, 7, 16, 2, 0, 8], 0.07, 8),
    ([4, 4, 4, 4, 4, 4, 4, 4], 0.3, 8),
    ([6, 6, 0, 0, 0, 0, 6, 2], 0.8, 8),       # heavy decay, undershoots
    ([16, 16, 16, 16, 16, 16], 0.1, 24),      # saturates, stays saturated
]


@pytest.mark.parametrize(
    "cap,bcap,D,block,dtype",
    [
        (128, 32, 8, 64, jnp.float32),
        (256, 64, 4, 128, jnp.int32),
        (65, 16, 8, 64, jnp.float32),
        (128, 128, 16, 32, jnp.bfloat16),
        (33, 8, 1, 128, jnp.int32),
    ],
)
def test_apply_plain_equals_jax_kernel(cap, bcap, D, block, dtype):
    """B1's plain version against the Pallas kernel body (interpret mode),
    on the reference's own parametrization."""
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    if dtype == jnp.int32:
        items = jax.random.randint(k1, (cap, D), 0, 10**6, jnp.int32)
        batch = jax.random.randint(k2, (bcap, D), 0, 10**6, jnp.int32)
    else:
        items = jax.random.normal(k1, (cap, D), dtype)
        batch = jax.random.normal(k2, (bcap, D), dtype)
    src = jax.random.randint(k3, (cap,), 0, cap + bcap, jnp.int32)
    want = jts_ops.tbs_step_apply(items, batch, src, block=block, impl="interpret")

    def tt(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) \
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))

    got = ts_ref.apply_ref(tt(items)[None], tt(batch)[None], tt(src)[None])[0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_apply_pytree_and_dtypes():
    """Arbitrary leaf shapes and dtypes move bit-exactly, without widening."""
    cap, bcap = 16, 4
    items = {"x": torch.arange(cap * 6, dtype=torch.float32).reshape(cap, 2, 3),
             "y": torch.arange(cap, dtype=torch.int8),
             "m": torch.zeros(cap, dtype=torch.bool)}
    batch = {"x": -torch.ones(bcap, 2, 3), "y": -torch.ones(bcap, dtype=torch.int8),
             "m": torch.ones(bcap, dtype=torch.bool)}
    src = torch.tensor([cap, cap + 1, 0, 5] + list(range(4, cap)))
    out = ts_ops.tbs_step_apply(items, batch, src)
    assert out["y"].dtype == torch.int8 and out["m"].dtype == torch.bool
    assert out["y"][:4].tolist() == [-1, -1, 0, 5]
    assert bool(out["m"][0]) and not bool(out["m"][2])
    assert torch.equal(out["x"][2], items["x"][0])
    # the same on the JAX route (which widens int8/bool for the MXU)
    jout = jts_ops.tbs_step_apply(
        {k: jnp.asarray(v.numpy()) for k, v in items.items()},
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        jnp.asarray(src.numpy(), jnp.int32), impl="ref")
    for k in items:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    # a leading reservoir dimension T (the banked form) is the same copy
    src2 = torch.stack([src, src.flip(0)])
    out2 = ts_ops.tbs_step_apply({"y": items["y"].expand(2, cap)},
                                 {"y": batch["y"].expand(2, bcap)}, src2)
    assert torch.equal(out2["y"][0], out["y"])


_jtick = jax.jit(jr.tick_map, static_argnames=("cap", "bcap", "n"))
_jstep = jax.jit(jr.step, static_argnames=("n",))


@pytest.mark.parametrize("batch_sizes,lam,n", STREAMS)
def test_tick_map_equals_jax(batch_sizes, lam, n):
    """Fed JAX's draws, the composed map and C/W are bit-equal on every tick
    (the four streams cover every Alg. 2 branch)."""
    bcap, cap = max(batch_sizes), n + 1
    d = F32(math.exp(-lam))
    batches, _ = id_stream(batch_sizes, bcap)
    st = jr.init(PROTO, n)
    for t, b in enumerate(batch_sizes):
        key = jax.random.fold_in(jax.random.key(5), t)
        src_j, c_j, w_j = _jtick(key, st.lat.nfull, st.lat.weight, st.total_weight,
                                 jnp.int32(b), d, cap=cap, bcap=bcap, n=n)
        src_t, c_t, w_t = tr.tick_map(
            tick_draws(key, cap, bcap), torch.tensor(int(st.lat.nfull)),
            torch.tensor(np.asarray(st.lat.weight)),
            torch.tensor(np.asarray(st.total_weight)), torch.tensor(b),
            torch.tensor(d), cap=cap, bcap=bcap, n=n)
        np.testing.assert_array_equal(src_t.numpy(), np.asarray(src_j), err_msg=f"t={t}")
        assert c_t.numpy() == np.asarray(c_j) and w_t.numpy() == np.asarray(w_j)
        st = _jstep(key, st, jnp.asarray(batches[t]), jnp.int32(b), n=n, decay=d)


@pytest.mark.parametrize("batch_sizes,lam,n", STREAMS)
def test_weight_trajectories_bit_equal(batch_sizes, lam, n):
    """C_t and W_t are deterministic: the port's own keys give the JAX
    trajectories bit for bit when both are fed the same f32 decay."""
    bcap = max(batch_sizes)
    d = F32(math.exp(-lam))
    batches, bcounts = id_stream(batch_sizes, bcap)
    sj = jr.init(PROTO, n)
    st = tr.init(torch.zeros((), dtype=torch.int32), n)
    for t, b in enumerate(batch_sizes):
        sj = _jstep(jax.random.key(t), sj, jnp.asarray(batches[t]), jnp.int32(b),
                    n=n, decay=d)
        st = tr.step(prng.key(t), st, torch.from_numpy(batches[t]),
                     torch.tensor(b), n=n, decay=torch.tensor(d))
        assert st.lat.weight.numpy() == np.asarray(sj.lat.weight), t
        assert st.total_weight.numpy() == np.asarray(sj.total_weight), t
        assert int(st.lat.nfull) == int(sj.lat.nfull), t


@pytest.mark.parametrize("batch_sizes,lam,n", STREAMS)
def test_state_carried_across_steps_equal(batch_sizes, lam, n):
    """A JAX state taken mid-stream, carried across by ``convert``, and
    stepped by both packages with the same draws gives bit-equal states."""
    bcap, cap = max(batch_sizes), n + 1
    d = F32(math.exp(-lam))
    batches, _ = id_stream(batch_sizes, bcap)
    half = len(batch_sizes) // 2
    sj = jr.init(PROTO, n)
    for t in range(half):
        sj = _jstep(jax.random.key(t), sj, jnp.asarray(batches[t]),
                    jnp.int32(batch_sizes[t]), n=n, decay=d)
    st = convert.rtbs_state_from_numpy(np.asarray(sj.lat.items), np.asarray(sj.lat.nfull),
                                       np.asarray(sj.lat.weight),
                                       np.asarray(sj.total_weight), device="cpu")
    for t in range(half, len(batch_sizes)):
        key = jax.random.key(100 + t)
        b = batch_sizes[t]
        sj = _jstep(key, sj, jnp.asarray(batches[t]), jnp.int32(b), n=n, decay=d)
        st = tr.step_with(tick_draws(key, cap, bcap), st, torch.from_numpy(batches[t]),
                          torch.tensor(b), n=n, decay=torch.tensor(d))
        back = convert.rtbs_state_to_numpy(st)
        np.testing.assert_array_equal(back["items"], np.asarray(sj.lat.items))
        assert back["nfull"] == np.asarray(sj.lat.nfull)
        assert back["weight"] == np.asarray(sj.lat.weight)
        assert back["total_weight"] == np.asarray(sj.total_weight)


def test_fused_step_theorem_4_2():
    """Theorem 4.2 at the reference's trials and tolerance
    (tests/test_tbs_step.py): Pr[i in S_t] == (C_t/W_t) w_t(i) for every batch
    age, with the trials as a leading dimension of one state."""
    batch_sizes, lam, n, trials = [4, 4, 4, 4, 4, 4, 4, 4], 0.3, 8, 12000
    T, bcap, cap = len(batch_sizes), 4, n + 1
    batches, _ = id_stream(batch_sizes, bcap)
    st = tr.RTBSState(
        lat=tl.Latent(items=torch.zeros(trials, cap, dtype=torch.int32),
                      nfull=torch.zeros(trials, dtype=torch.int64),
                      weight=torch.zeros(trials)),
        total_weight=torch.zeros(trials))
    d = torch.tensor(F32(math.exp(-lam)))
    key = prng.key(0)
    for t in range(T):
        dr = tr.draw_tick(prng.fold_in(key, t), cap=cap, bcap=bcap, device="cpu",
                          batch=(trials,))
        st = tr.step_with(dr, st, torch.from_numpy(batches[t]),
                          torch.tensor(batch_sizes[t]), n=n, decay=d)
    mask, _ = tl.realize(prng.uniform(prng.fold_in(key, T), (trials,), "cpu"), st.lat)
    batch_of = (st.lat.items // 1000).to(torch.int64)
    counts = torch.zeros(trials, T + 1).scatter_add_(1, batch_of, mask.float())
    probs = counts[:, 1:].mean(dim=0).numpy() / 4
    w, ws = 0.0, []
    for b in batch_sizes:
        w = math.exp(-lam) * w + b
        ws.append(w)
    C_T, W_T = min(n, ws[-1]), ws[-1]
    for j in range(T):
        expect = (C_T / W_T) * math.exp(-lam * (T - 1 - j))
        assert abs(probs[j] - expect) < 0.025, (j, probs[j], expect)


def test_step_valid_region_holds_distinct_streamed_items():
    """The fused port step never fabricates or duplicates items."""
    batch_sizes, lam, n = [12, 0, 0, 3, 9, 1, 5, 7, 16, 2, 0, 8], 0.07, 8
    batches, bcounts = id_stream(batch_sizes, max(batch_sizes))
    st, trace = tr.run_stream(prng.key(1), tr.init(torch.zeros((), dtype=torch.int32), n),
                              torch.from_numpy(batches), torch.from_numpy(bcounts),
                              n=n, lam=lam)
    k = int(st.lat.nfull)
    live = k + (1 if float(st.lat.weight) % 1.0 > 1e-5 else 0)
    got = st.lat.items[:live].tolist()
    assert all(1000 <= g < 1000 * (len(batch_sizes) + 1) for g in got)
    assert len(set(got)) == len(got)
    assert trace["C"].shape == (len(batch_sizes),) and float(trace["C"].max()) <= n


# ---------------------------------------------------------------------------
# the wrappers' leaf tables (B1 and B3 launch once for every leaf)
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("row_bytes,ptrs,vec", [
    (8, (0, 4096, 8192), 8),          # x f32[., 2]
    (4, (0, 16, 32), 4),              # y f32[.]
    (400, (0, 16, 32), 16),           # naive Bayes' f32[., 100]
    (12, (0, 16, 32), 4),
    (6, (0, 16, 32), 2),              # bf16[., 3]
    (3, (0, 16, 32), 1),
    (1, (0, 16, 32), 1),              # int8 / bool
    (8, (4, 16, 32), 4),              # an offset view rules out 8 and 16
    (16, (0, 8, 32), 8),
    (32, (0, 16, 2), 2),
    (8, (), 8),                       # no pointer (the CPU path): the row alone
])
def test_plan_copy_width(row_bytes, ptrs, vec):
    """Exact: the widest of 16, 8, 4, 2, 1 bytes dividing the row and every
    pointer of the leaf."""
    assert ts_ops.plan([row_bytes], [ptrs]) == [[(0, vec)]]


def test_plan_groups_mixed_widths_past_the_table():
    """Exact: leaves in order, at most the kernel's table a launch; rows of
    0 bytes are left out; each leaf keeps its own width."""
    from repro_torch.kernels.tbs_step import kernel as ts_kernel

    widths = [1, 4, 8, 12, 400, 0, 6, 3, 16, 2, 8, 4]
    ptrs = [(0, 1024, 2048)] * len(widths)
    groups = ts_ops.plan(widths, ptrs, max_leaves=4)
    assert [[i for i, _ in g] for g in groups] == [[0, 1, 2, 3], [4, 6, 7, 8], [9, 10, 11]]
    assert dict(v for g in groups for v in g) == {0: 1, 1: 4, 2: 8, 3: 4, 4: 16, 6: 2,
                                                  7: 1, 8: 16, 9: 2, 10: 8, 11: 4}
    n = ts_kernel.MAX_LEAVES
    assert [len(g) for g in ts_ops.plan([4] * (2 * n + 1), [()] * (2 * n + 1))] == [n, n, 1]
    assert ts_ops.plan([0, 0], [(), ()]) == []


def test_check_leaves_row_bytes_of_mixed_pytrees():
    """Exact: each leaf's row bytes after its tail and dtype agree."""
    leaves = [_meta((2, 9)), _meta((2, 9, 2)), _meta((2, 9, 3)), _meta((2, 9, 100)),
              _meta((2, 9), torch.int8), _meta((2, 9, 3), torch.bfloat16),
              _meta((2, 9, 0))]
    others = [_meta((2, 5) + tuple(x.shape[2:]), x.dtype) for x in leaves]
    assert ts_ops.check_leaves("f", leaves, others, (2, 9), (2, 5)) == [4, 8, 12, 400, 1,
                                                                       6, 0]
    bank = [_meta((7, 65)), _meta((7, 65, 2))]
    pay = [_meta((11,)), _meta((11, 2))]
    assert ts_ops.check_leaves("g", bank, pay, (7, 65), (11,)) == [4, 8]


@pytest.mark.parametrize("leaf,other,lead,other_lead,err", [
    (((2, 9, 3), torch.float32), ((2, 5, 2), torch.float32), (2, 9), (2, 5), ValueError),
    (((2, 9, 3), torch.float32), ((2, 5, 3), torch.int32), (2, 9), (2, 5), TypeError),
    (((3, 9, 3), torch.float32), ((3, 5, 3), torch.float32), (2, 9), (2, 5), ValueError),
    (((2, 8), torch.float32), ((2, 5), torch.float32), (2, 9), (2, 5), ValueError),
    (((7, 65, 2), torch.float32), ((12, 2), torch.float32), (7, 65), (11,), ValueError),
    (((6, 65), torch.float32), ((11,), torch.float32), (7, 65), (11,), ValueError),
])
def test_check_leaves_refuses_leaves_that_do_not_agree(leaf, other, lead, other_lead, err):
    """A leaf whose lead dims, tail or dtype disagree with its partner's (or
    with the table's, e.g. another cap or K) is refused on the host."""
    ok = (_meta((2, 9)), _meta((2, 5))) if len(lead) == 2 and lead[0] == 2 else \
        (_meta(lead), _meta(other_lead))
    with pytest.raises(err, match="leaf 1"):
        ts_ops.check_leaves("f", [ok[0], _meta(*leaf)], [ok[1], _meta(*other)], lead,
                            other_lead)


def test_apply_refuses_pytrees_that_do_not_agree():
    """B1's wrapper refuses, before any work, batch leaves of another tail,
    dtype or pytree structure, and leaves of another cap than the first."""
    cap, bcap = 8, 3
    src = torch.arange(cap)
    with pytest.raises(ValueError, match="tbs_step_apply"):
        ts_ops.tbs_step_apply({"x": torch.zeros(cap, 2)}, {"x": torch.zeros(bcap, 3)}, src)
    with pytest.raises(TypeError, match="tbs_step_apply"):
        ts_ops.tbs_step_apply({"x": torch.zeros(cap)},
                              {"x": torch.zeros(bcap, dtype=torch.int32)}, src)
    with pytest.raises(ValueError, match="differ"):
        ts_ops.tbs_step_apply({"x": torch.zeros(cap)}, {"z": torch.zeros(bcap)}, src)
    with pytest.raises(ValueError, match="leaf 1"):
        ts_ops.tbs_step_apply([torch.zeros(cap), torch.zeros(cap + 1)],
                              [torch.zeros(bcap), torch.zeros(bcap)], src)
