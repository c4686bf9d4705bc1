"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` (a CUDA kernel has no
interpret mode) and skips without one. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import prng
from repro_torch.kernels.reservoir_compact import ops as rc_ops
from repro_torch.kernels.reservoir_compact import ref as rc_ref
from repro_torch.kernels.swap_delete import kernel as sd_kernel
from repro_torch.kernels.swap_delete import ops as sd_ops
from repro_torch.kernels.swap_delete import ref as sd_ref
from repro_torch.kernels.tbs_step import ops as ts_ops
from repro_torch.kernels.tbs_step import ref as ts_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _payload(shape, dtype, g, dev):
    if dtype == torch.bool:
        return torch.rand(shape, generator=g, device=dev) < 0.5
    if dtype in (torch.int8, torch.int32, torch.int64):
        return torch.randint(-100, 100, shape, generator=g, device=dev).to(dtype)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("T,cap,bcap,tail,dtype", [
    (1, 1025, 64, (2,), torch.float32),     # 8-byte rows
    (1, 33, 8, (3,), torch.int8),           # 3-byte rows: 1-byte words
    (2, 300, 40, (3,), torch.bfloat16),     # 6-byte rows, banked T = 2
    (3, 128, 16, (), torch.bool),
    (1, 2000, 100, (100,), torch.float32),  # 400-byte rows: 16-byte words
    (1, 77, 9, (5,), torch.int64),
])
def test_tbs_step_kernel_equals_plain(dev, T, cap, bcap, tail, dtype):
    g = torch.Generator(device=dev).manual_seed(cap)
    items = _payload((T, cap) + tail, dtype, g, dev)
    batch = _payload((T, bcap) + tail, dtype, g, dev)
    # includes out-of-range entries, which both clamp
    src = torch.randint(-3, cap + bcap + 3, (T, cap), generator=g, device=dev)
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(items, batch, src)
    want = ts_ref.apply_ref(items.reshape(T, cap, -1), batch.reshape(T, bcap, -1),
                            src).reshape(items.shape)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply.launches == n0 + 1
    assert torch.equal(got, want)


# the leaves of one call: the main path's x + y, then every row kind at once
# (1, 2, 3, 4, 8, 40 and 400 bytes; one-word rows and groups of threads)
RC_LEAVES = {
    "xy": {"x": ((2,), torch.float32), "y": ((), torch.float32)},
    "mixed": {"x": ((2,), torch.float32), "y": ((), torch.float32), "i8": ((3,), torch.int8),
              "bf16": ((), torch.bfloat16), "bool": ((), torch.bool),
              "i64": ((5,), torch.int64), "wide": ((100,), torch.float32)},
}


def _check_compact(items, mask, launches=1):
    """One wrapper call on a pytree against ``compact_ref`` leaf by leaf and
    ``items[mask]``, bit for bit, with its count of launches."""
    n0 = rc_ops.reservoir_compact.launches
    got, cnt = rc_ops.reservoir_compact(items, mask)
    torch.cuda.synchronize()
    assert rc_ops.reservoir_compact.launches == n0 + launches
    kept = int(mask.sum())
    assert cnt.dtype == torch.int32 and cnt.device == mask.device and int(cnt) == kept
    for k in items:
        want, wcnt = rc_ref.compact_ref(items[k].reshape(mask.shape[0], -1), mask)
        assert int(wcnt) == kept
        assert torch.equal(got[k], want.reshape(items[k].shape)), k
        assert torch.equal(got[k][:kept], items[k][mask]), k


@pytest.mark.parametrize("kind", ["uniform", "prefix", "block", "none", "all"])
@pytest.mark.parametrize("cap,leaves", [
    (1, "mixed"), (1023, "mixed"), (1025, "mixed"),
    (70_001, "mixed"),                     # not a multiple of a CTA's span
    (2**20 + 1, "xy"),                     # the main path's sample
    (2**21 + 3, "mixed"),                  # spans of two chunks, the last one partial
])
def test_reservoir_compact_kernel_equals_plain(dev, cap, leaves, kind):
    """Every leaf of the sample in one launch, on the callers' masks and the
    edges p = 0 and p = 1."""
    from repro_torch.kernels.reservoir_compact.bench import case_mask

    g = torch.Generator(device=dev).manual_seed(cap)
    items = {k: _payload((cap,) + tail, dt, g, dev) for k, (tail, dt) in RC_LEAVES[leaves].items()}
    _check_compact(items, case_mask(kind, cap, g))


def test_reservoir_compact_wide_rows_at_full_size(dev):
    """Naive Bayes' 400-byte rows, f32[2^20, 100] alone, on a uniform mask:
    25 16-byte words a row, a thread a word."""
    g = torch.Generator(device=dev).manual_seed(5)
    cap = 1 << 20
    x = torch.randn(cap, 100, generator=g, device=dev)
    mask = torch.rand(cap, generator=g, device=dev) < 0.6
    n0 = rc_ops.reservoir_compact.launches
    got, cnt = rc_ops.reservoir_compact(x, mask)
    torch.cuda.synchronize()
    assert rc_ops.reservoir_compact.launches == n0 + 1
    kept = int(mask.sum())
    assert int(cnt) == kept
    assert torch.equal(got[:kept], x[mask]) and not got[kept:].any()


def test_reservoir_compact_widest_rows_and_the_refusal_past_them(dev):
    """Rows of just under kernel.MAX_ROW_WORDS copy words (1-byte words)
    move bit for bit; a row of as many words as the limit raises before
    any launch."""
    from repro_torch.kernels.reservoir_compact import kernel as rc_kernel

    g = torch.Generator(device=dev).manual_seed(15)
    n = rc_kernel.MAX_ROW_WORDS
    items = {"x": torch.randint(0, 255, (3, n - 1), generator=g, device=dev, dtype=torch.uint8),
             "y": torch.randn(3, generator=g, device=dev)}
    _check_compact(items, torch.tensor([True, False, True], device=dev))
    n0 = rc_ops.reservoir_compact.launches
    with pytest.raises(ValueError, match="words a row"):
        rc_ops.reservoir_compact(torch.zeros(2, 4 * n, device=dev),
                                 torch.ones(2, dtype=torch.bool, device=dev))
    assert rc_ops.reservoir_compact.launches == n0


def test_reservoir_compact_groups_leaves_past_the_table(dev):
    """More leaves than the kernel's table, of mixed widths: one launch per
    group of them, each leaf bit for bit."""
    from repro_torch.kernels import _common

    g = torch.Generator(device=dev).manual_seed(7)
    cap, n = 4099, _common.MAX_LEAVES + 3
    items = {f"l{i}": _payload((cap,) + ((), (2,), (3,), (100,))[i % 4],
                               (torch.float32, torch.int8, torch.bfloat16)[i % 3], g, dev)
             for i in range(n)}
    _check_compact(items, torch.rand(cap, generator=g, device=dev) < 0.3, launches=2)


def test_reservoir_compact_offset_views_and_strided_leaves(dev):
    """Leaves at offsets that rule out wide copy words, and a transposed
    (non-contiguous) leaf, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(9)
    cap = 3001
    base = torch.randn(cap * 4 + 3, generator=g, device=dev)
    items = {"odd": base[1:1 + cap * 2].view(cap, 2), "off4": base[3:3 + cap],
             "t": torch.randn(2, cap, generator=g, device=dev).t(),
             "u8": torch.randint(0, 255, (cap + 1, 5), generator=g, device=dev,
                                 dtype=torch.uint8)[1:]}
    _check_compact(items, torch.rand(cap, generator=g, device=dev) < 0.5)


def test_reservoir_compact_count_alone_and_side_stream(dev):
    """With no bytes to move (an empty tree, rows of 0 bytes) one launch
    still writes the count; a call on another stream is right too (its own
    scratch)."""
    g = torch.Generator(device=dev).manual_seed(11)
    mask = torch.rand(5000, generator=g, device=dev) < 0.4
    for items in ({}, {"empty": torch.zeros(5000, 0, device=dev)}):
        n0 = rc_ops.reservoir_compact.launches
        out, cnt = rc_ops.reservoir_compact(items, mask)
        torch.cuda.synchronize()
        assert rc_ops.reservoir_compact.launches == n0 + 1 and int(cnt) == int(mask.sum())
    side = torch.cuda.Stream()
    items = {"x": torch.randn(5000, 2, generator=g, device=dev)}
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        _check_compact(items, mask)


def test_reservoir_compact_without_host_sync(dev):
    """A materialization of the main path's x + y makes no host sync."""
    from repro_torch.core import latent

    g = torch.Generator(device=dev).manual_seed(13)
    cap = 2**20 + 1
    items = {"x": torch.randn(cap, 2, generator=g, device=dev),
             "y": torch.randn(cap, generator=g, device=dev)}
    mask = torch.rand(cap, generator=g, device=dev) < 0.6
    latent.compact_items(items, mask)          # built and scratch made outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = latent.compact_items(items, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k in items:
        want, _ = rc_ref.compact_ref(items[k].reshape(cap, -1), mask)
        assert torch.equal(got[k], want.reshape(items[k].shape)), k


# (L, D, trips, k): the rows route (L <= 256, D <= 64) and the forest route
SWAP_DELETE_CASES = [
    (64, 8, [8, 0, 3], [40, 40, 5]),
    (5000, 300, [300, 17], [4999, 320]),
    (5000, 300, [300], [300]),                 # trips = k: the whole prefix
    (64, 8, [8], [8]),
    (5000, 300, [300, 250], [5000, 5000]),     # k = L
    (64, 64, [64], [64]),
    (5000, 300, [290, 300, 40], [7000, 5000, 60]),   # a k > L row among others
    (64, 8, [8, 5], [90, 64]),
    (3000, 512, [0, 512, 100], [3000, 2999, 0]),     # T = 3 mixed rows
    (300, 40, [40, 12, 0], [300, 13, 7]),
]


def _check_swap_delete(L, D, trips, k, bits, want=None, route=None):
    """The wrapper (and, for a given route, that route's launch on the same
    inputs) against ``want`` or the plain loop, bit for bit."""
    n0 = sd_ops.swap_delete.launches
    got = sd_ops.swap_delete(L, trips, k, bits, D)
    if want is None:
        want = sd_ref.swap_delete_ref(L, trips, k, bits, D)
    torch.cuda.synchronize()
    assert sd_ops.swap_delete.launches == n0 + 1
    assert torch.equal(got, want)
    if route is not None:
        out = torch.empty_like(want.reshape(-1, L))
        getattr(sd_kernel, route)(out, trips.reshape(-1), k.reshape(-1),
                                  bits.reshape(out.shape[0], -1), D)
        torch.cuda.synchronize()
        assert torch.equal(out, want.reshape(-1, L)), route


@pytest.mark.parametrize("L,D,trips,k", SWAP_DELETE_CASES)
def test_swap_delete_kernel_equals_plain(dev, L, D, trips, k):
    trips = torch.tensor(trips, device=dev)
    k = torch.tensor(k, device=dev)
    bits = prng.bits(prng.key(L), (trips.numel(), D + 2), dev)
    _check_swap_delete(L, D, trips, k, bits, route="forest")
    if L + D <= sd_kernel.ROWS_MAX_LD:   # what the rows route's shared memory holds
        _check_swap_delete(L, D, trips, k, bits, route="rows")


@pytest.mark.parametrize("L,D,k", [(64, 62, 64), (300, 250, 260), (5000, 1000, 4000),
                                   (70_000, 65_536, 65_538)])
def test_swap_delete_kernel_equals_plain_on_deep_chains(dev, L, D, k):
    """bits[j] = k - 2 - j: every step moves the value the step before
    placed, so one chain spans all D steps; both routes where they fit."""
    j = torch.arange(D + 2, device=dev)
    bits = (k - 2 - j).clamp(min=0)[None]
    trips = torch.tensor([D], device=dev)
    kt = torch.tensor([k], device=dev)
    want = (sd_ref.swap_delete_forest_ref if D > 4096 else sd_ref.swap_delete_ref)(
        L, trips, kt, bits, D)
    _check_swap_delete(L, D, trips, kt, bits, want,
                       route="rows" if L + D <= sd_kernel.ROWS_MAX_LD else "forest")
    _check_swap_delete(L, D, trips, kt, bits, want, route="forest")


@pytest.mark.parametrize("L,k", [(65, 65), (97, 97)])
def test_swap_delete_kernel_equals_plain_at_the_bank_shape(dev, L, k):
    """The bank's regime: 17,000 rows, D = 32, on the rows route, with
    collision-heavy bits on every third row."""
    T, D = 17_000, 32
    g = torch.Generator(device=dev).manual_seed(L)
    kk = torch.randint(0, k + 1, (T,), generator=g, device=dev)
    trips = (torch.rand((T,), generator=g, device=dev)
             * (torch.clamp(kk, max=D) + 1)).long()
    bits = torch.randint(0, 2**32, (T, D + 2), generator=g, device=dev)
    bits[::3] %= 3
    assert sd_ops.route(L, D) == "rows"
    f0 = sd_ops.swap_delete.forest_launches
    _check_swap_delete(L, D, trips, kk, bits, route="forest")
    assert sd_ops.swap_delete.forest_launches == f0


def test_swap_delete_forest_at_full_size_equals_forest_ref_without_sync(dev):
    """L = 2^20, D = 65,536 at 65,536 trips, as the main path's stage-1 map
    is shaped, against the plain forest; the call runs with every host sync
    an error."""
    L, D = 1 << 20, 65_536
    bits = prng.bits(prng.key(3), (D + 2,), dev)
    trips = torch.tensor(D, device=dev)
    k = torch.tensor(L - 1, device=dev)
    want = sd_ref.swap_delete_forest_ref(L, trips, k, bits, D)
    f0 = sd_ops.swap_delete.forest_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sd_ops.swap_delete(L, trips, k, bits, D)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sd_ops.swap_delete.forest_launches == f0 + 1
    assert torch.equal(got, want)


def test_tick_on_card_equals_cpu_and_does_not_sync(dev):
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    outs = {}
    for d in (dev, torch.device("cpu")):
        batches, bcounts = materialize_stream(
            LinRegStream(seed=2), 12, batch_size=lambda t: 64 if t < 6 else 8,
            bcap=64, device=d)
        sampler = make_sampler("rtbs", n=255, lam=0.05, device=d)
        run = make_run_loop(sampler, make_model("linreg", device=d), retrain_every=3)
        outs[d.type] = run(prng.key(1), batches, bcounts)
    (sg, _, tg), (sc, _, tc) = outs["cuda"], outs["cpu"]
    for a, b in zip(torch.utils._pytree.tree_leaves(sg),
                    torch.utils._pytree.tree_leaves(sc)):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(tg["size"].cpu(), tc["size"])

    from repro_torch.manage import make_manage_step

    sampler = make_sampler("rtbs", n=255, lam=0.05)
    model = make_model("linreg")
    tick = make_manage_step(sampler, model, retrain_every=3)
    batch = {"x": torch.rand(64, 2, device=dev), "y": torch.rand(64, device=dev)}
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(prng.key(0), 0, sg, model.init(), batch, torch.full((), 64, device=dev))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launches()["tbs_step_apply"] == 1


def _src(kind, shape, cap, bcap, g, dev):
    """A tick map: "random" over [-3, cap + bcap + 3) (out-of-range entries
    clamp), or "bank" with about 95 % of the slots their own row."""
    src = torch.randint(-3, cap + bcap + 3, shape, generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "bank":
        keep = torch.rand(shape, generator=g, device=dev) < 0.95
        src = torch.where(keep, torch.arange(shape[-1], device=dev, dtype=torch.int32), src)
    return src


# one leaf of each width: 1, 4, 8, 12 and 400 bytes a row
_MIXED = {"b": ((), torch.int8), "y": ((), torch.float32), "x": ((2,), torch.float32),
          "w": ((3,), torch.float32), "nb": ((100,), torch.float32)}


@pytest.mark.parametrize("kind", ["random", "bank"])
@pytest.mark.parametrize("T,cap,bcap", [(1, 4099, 300), (2, 1023, 64), (1, 65, 32)])
def test_tbs_step_mixed_leaves_in_one_launch(dev, kind, T, cap, bcap):
    """B1 moves a pytree of 1-, 4-, 8-, 12- and 400-byte rows in one launch,
    bit for bit, at caps that are not a multiple of its 4 rows a thread."""
    g = torch.Generator(device=dev).manual_seed(cap + T)
    items = {k: _payload((T, cap) + tail, dt, g, dev) for k, (tail, dt) in _MIXED.items()}
    batch = {k: _payload((T, bcap) + tail, dt, g, dev) for k, (tail, dt) in _MIXED.items()}
    src = _src(kind, (T, cap), cap, bcap, g, dev)
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(items, batch, src)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply.launches == n0 + 1
    for k in items:
        want = ts_ref.apply_ref(items[k].reshape(T, cap, -1), batch[k].reshape(T, bcap, -1),
                                src).reshape(items[k].shape)
        assert torch.equal(got[k], want), k


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_tbs_step_offset_views(dev, offset):
    """Views whose storage offset rules out the 16-byte copy (x f32[., 2] at
    4, 8 or 12 bytes past a 16-byte boundary; y one element in) and a
    [rows] src that starts off a 16-byte boundary: bit for bit, one launch."""
    g = torch.Generator(device=dev).manual_seed(offset)
    cap, bcap = 5003, 77
    xb = torch.randn(2 * cap + 8, generator=g, device=dev)
    yb = torch.randn(cap + 8, generator=g, device=dev)
    items = {"x": xb[offset:offset + 2 * cap].view(cap, 2), "y": yb[offset:offset + cap]}
    batch = {"x": torch.randn(bcap, 2, generator=g, device=dev),
             "y": torch.randn(bcap, generator=g, device=dev)}
    sb = torch.randint(0, cap + bcap, (cap + 4,), generator=g, device=dev, dtype=torch.int32)
    src = sb[offset:offset + cap]
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(items, batch, src)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply.launches == n0 + 1
    for k in items:
        want = ts_ref.apply_ref(items[k].reshape(1, cap, -1), batch[k].reshape(1, bcap, -1),
                                src[None]).reshape(items[k].shape)
        assert torch.equal(got[k], want), k


def test_tbs_step_groups_leaves_past_the_table(dev):
    """More leaves than the kernel's table: one launch per group of them."""
    from repro_torch.kernels.tbs_step import kernel as ts_kernel

    g = torch.Generator(device=dev).manual_seed(3)
    n, cap, bcap = ts_kernel.MAX_LEAVES + 3, 999, 50
    items = [torch.randn(cap, 1 + i % 3, generator=g, device=dev) for i in range(n)]
    batch = [torch.randn(bcap, 1 + i % 3, generator=g, device=dev) for i in range(n)]
    src = torch.randint(0, cap + bcap, (cap,), generator=g, device=dev)
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(items, batch, src)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply.launches == n0 + 2
    for a, b, o in zip(items, batch, got):
        assert torch.equal(o, ts_ref.apply_ref(a[None], b[None], src[None])[0])


def _banked_case(dev, K, b, cap, bcap, tail, dtype, seed):
    from repro_torch.bank import route

    g = torch.Generator(device=dev).manual_seed(seed)
    bank = _payload((K, cap) + tail, dtype, g, dev)
    payload = _payload((b,) + tail, dtype, g, dev)
    keys = torch.randint(-1, K + 1, (b,), generator=g, device=dev)
    r = route(keys, b - 5, num_keys=K, bcap=bcap)
    # includes out-of-range entries, which both clamp
    src = torch.randint(-3, cap + bcap + 3, (b, cap), generator=g, device=dev,
                        dtype=torch.int32)
    return bank, payload, src, r


@pytest.mark.parametrize("K,b,cap,bcap,tail,dtype", [
    (4096, 2048, 65, 32, (3,), torch.float32),     # 12-byte rows
    (512, 700, 65, 32, (100,), torch.float32),     # 400-byte rows
    (300, 1000, 65, 8, (), torch.int8),            # 1-byte rows
    (1 << 18, 70_000, 9, 4, (2,), torch.float32),  # b > 65,535 rows
])
def test_tbs_step_banked_kernel_equals_plain(dev, K, b, cap, bcap, tail, dtype):
    bank, payload, src, r = _banked_case(dev, K, b, cap, bcap, tail, dtype, cap + b)
    want = bank.clone()
    ts_ref.banked_ref(want.reshape(K, cap, -1), payload.reshape(b, -1), src, r.order,
                      r.starts, r.touched, r.ntouched, bcap)
    n0 = ts_ops.tbs_step_apply_banked.launches
    ts_ops.tbs_step_apply_banked(bank, payload, src, order=r.order, starts=r.starts,
                                 touched=r.touched, ntouched=r.ntouched, bcap=bcap)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply_banked.launches == n0 + 1
    assert torch.equal(bank, want)


@pytest.mark.parametrize("kind", ["random", "bank"])
@pytest.mark.parametrize("K,b,cap,bcap", [
    (4096, 2048, 65, 32),    # the bank's cap: groups of 16 lanes
    (500, 700, 128, 16),     # WARP_CAP: 16 lanes of 8 slots
    (700, 900, 200, 16),     # past WARP_CAP: a CTA a key, staged
    (300, 500, 300, 8),      # a CTA a key, staged
    (64, 100, 1, 4),
])
def test_tbs_step_banked_mixed_leaves_in_one_launch(dev, kind, K, b, cap, bcap):
    """B3 updates a pytree of 1-, 4-, 8-, 12- and 400-byte rows in one
    launch, bit for bit, on random maps and on bank-like ones (~95 % of the
    slots their own row), with out-of-range keys and padded routing rows."""
    from repro_torch.bank import route

    g = torch.Generator(device=dev).manual_seed(cap + b)
    bank = {k: _payload((K, cap) + tail, dt, g, dev) for k, (tail, dt) in _MIXED.items()}
    payload = {k: _payload((b,) + tail, dt, g, dev) for k, (tail, dt) in _MIXED.items()}
    keys = torch.randint(-1, K + 1, (b,), generator=g, device=dev)
    r = route(keys, b - 5, num_keys=K, bcap=bcap)
    src = _src(kind, (b, cap), cap, bcap, g, dev)
    want = {k: v.clone() for k, v in bank.items()}
    for k, v in want.items():
        ts_ref.banked_ref(v.view(K, cap, -1), payload[k].reshape(b, -1), src, r.order,
                          r.starts, r.touched, r.ntouched, bcap)
    n0 = ts_ops.tbs_step_apply_banked.launches
    ts_ops.tbs_step_apply_banked(bank, payload, src, order=r.order, starts=r.starts,
                                 touched=r.touched, ntouched=r.ntouched, bcap=bcap)
    torch.cuda.synchronize()
    assert ts_ops.tbs_step_apply_banked.launches == n0 + 1
    for k in bank:
        assert torch.equal(bank[k], want[k]), k


def test_tbs_step_banked_refuses_a_reservoir_past_shared_memory(dev):
    from repro_torch.kernels.tbs_step import kernel as ts_kernel

    limit = ts_kernel.banked_smem_limit(dev)
    cap = limit // 400 + 1                         # f32[100] rows: 400 bytes
    bank, payload, src, r = _banked_case(dev, 4, 8, cap, 4, (100,), torch.float32, 1)
    with pytest.raises(ValueError, match="shared"):
        ts_ops.tbs_step_apply_banked(bank, payload, src, order=r.order,
                                     starts=r.starts, touched=r.touched,
                                     ntouched=r.ntouched, bcap=4)


def test_bank_on_card_equals_cpu_and_does_not_sync(dev):
    from repro_torch.bank import make_bank
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.manage import make_bank_manage_step, make_model, materialize_stream

    outs = {}
    for d in (dev, torch.device("cpu")):
        batches, bcounts = materialize_stream(
            KeyedStream(LinRegStream(seed=2), num_keys=512, alpha=1.1), 6,
            batch_size=256, fields=("key", "x", "y"), device=d)
        bank = make_bank("rtbs", num_keys=512, n=16, lam=0.05, bcap=8, device=d)
        tick = make_bank_manage_step(bank, make_model("linreg", device=d),
                                     retrain_every=3, train_keys=range(8))
        st = bank.init({"x": torch.zeros(2, device=d), "y": torch.zeros((), device=d)})
        p = torch.zeros(3, device=d)
        for tt in range(6):
            st, p, m = tick(prng.key(1), tt, st, p, {f: v[tt] for f, v in batches.items()},
                            bcounts[tt])
        outs[d.type] = (st, batches, bcounts, tick, p)
    sg, sc = outs["cuda"][0], outs["cpu"][0]
    for a, b in zip(torch.utils._pytree.tree_leaves(sg),
                    torch.utils._pytree.tree_leaves(sc)):
        assert torch.equal(a.cpu(), b)
    st, batches, bcounts, tick, p = outs["cuda"]
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(prng.key(1), 6, st, p, {f: v[5] for f, v in batches.items()}, bcounts[5])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launches()["tbs_step_apply_banked"] == 1


# ---------------------------------------------------------------------------
# B4, flash attention, and the dense LM's serve path
# ---------------------------------------------------------------------------
# bf16 B4 against attention_ref in f32 on the same bf16 inputs, row by row
# ((b, s, h): hd values): rounding p and o to bf16 (each off by at most 2^-8
# of itself) leaves about 3e-3 of a row's norm at hd >= 64 and up to 6.7e-3
# at hd 8 (NVIDIA H100), while the late rows of a long sequence have |o| near
# 0.04, so a plain 2e-2 bound on |diff| is loose there
_B4_BF16_ROW_REL = 8e-3


def _assert_bf16_rows_close(got, q, k, v, **mask):
    from repro_torch.kernels.flash_attention import ref as fa_ref

    want = fa_ref.attention_ref(q.float(), k.float(), v.float(), **mask)
    d = (got.double() - want.double()).norm(dim=-1)
    rel = float((d / want.double().norm(dim=-1).clamp_min(1e-30)).max())
    assert rel <= _B4_BF16_ROW_REL, f"a row is {rel} of its norm off the f32 reference"


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal,window,atol", [
    (8, 2048, 32, 8, 160, torch.bfloat16, True, 0, 2e-2),   # the served prefill
    (2, 256, 4, 2, 160, torch.float32, True, 0, 2e-5),
    (1, 256, 4, 1, 128, torch.float32, True, 0, 2e-5),      # MQA, granite_20b's head
    (1, 256, 4, 2, 160, torch.float32, True, 64, 2e-5),     # sliding window
    (2, 256, 4, 4, 160, torch.float32, False, 0, 2e-5),     # MHA, bidirectional
    (1, 77, 6, 3, 24, torch.bfloat16, True, 0, 2e-2),       # ragged tiles
    (2, 100, 4, 2, 8, torch.float32, True, 40, 2e-5),       # hd 8 (command-r smoke)
    # bf16, the tensor-core kernel: every head-dim box layout, both masks,
    # MQA / GQA 4 / MHA, ragged and one-row sequences
    (2, 65, 4, 1, 8, torch.bfloat16, True, 0, 2e-2),        # hd 8, MQA
    (1, 64, 2, 1, 40, torch.bfloat16, True, 0, 2e-2),       # hd 40: a part box
    (2, 256, 8, 2, 64, torch.bfloat16, False, 0, 2e-2),     # GQA 4, bidirectional
    (1, 130, 4, 2, 96, torch.bfloat16, True, 0, 2e-2),
    (1, 300, 4, 4, 128, torch.bfloat16, True, 64, 2e-2),    # MHA, window 64
    (2, 333, 8, 2, 160, torch.bfloat16, True, 100, 2e-2),   # window 100, ragged
    (1, 2048, 8, 2, 160, torch.bfloat16, False, 0, 2e-2),
    (1, 2048, 8, 2, 160, torch.bfloat16, True, 100, 2e-2),  # long, window 100
    (1, 1, 4, 2, 256, torch.bfloat16, True, 0, 2e-2),       # S 1
    (1, 200, 4, 1, 256, torch.bfloat16, False, 100, 2e-2),  # hd 256, window only
])
def test_flash_attention_kernel_equals_plain(dev, B, S, H, KV, hd, dtype, causal, window,
                                             atol):
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    n0 = fa_ops.flash_attention.launches
    t0 = fa_ops.flash_attention.tensor_core_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n0 + 1
    # bf16 runs on the tensor cores, f32 on the CUDA cores
    assert fa_ops.flash_attention.tensor_core_launches == t0 + (dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        _assert_bf16_rows_close(got, q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("S,T,causal,window", [
    (100, 260, True, 0), (96, 50, False, 0), (200, 130, True, 0), (70, 150, False, 32)])
def test_flash_attention_tensor_cores_other_key_length(dev, S, T, causal, window):
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    g = torch.Generator(device=dev).manual_seed(S + T)
    q = torch.randn((2, S, 8, 160), generator=g, device=dev).bfloat16()
    k = torch.randn((2, T, 2, 160), generator=g, device=dev).bfloat16()
    v = torch.randn((2, T, 2, 160), generator=g, device=dev).bfloat16()
    t0 = fa_ops.flash_attention.tensor_core_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.tensor_core_launches == t0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    _assert_bf16_rows_close(got, q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("H,KV,hd,S", [(8, 2, 160, 150), (8, 2, 64, 130), (4, 4, 24, 77)])
def test_flash_attention_tensor_cores_read_fused_projection(dev, H, KV, hd, S):
    """bf16 q, k and v as views of one fused [B, S, (H + 2 KV) hd]
    projection, read in place through their tensor maps."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    g = torch.Generator(device=dev).manual_seed(hd)
    qkv = torch.randn((2, S, (H + 2 * KV) * hd), generator=g, device=dev).bfloat16()
    q = qkv[..., :H * hd].reshape(2, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].reshape(2, S, KV, hd)
    v = qkv[..., (H + KV) * hd:].reshape(2, S, KV, hd)
    assert not q.is_contiguous() and k.data_ptr() != k.contiguous().data_ptr()
    t0 = fa_ops.flash_attention.tensor_core_launches
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.tensor_core_launches == t0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    _assert_bf16_rows_close(got, q, k, v)


def test_flash_attention_tensor_cores_are_deterministic(dev):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((2, 700, 8, 160), generator=g, device=dev).bfloat16()
    k = torch.randn((2, 700, 2, 160), generator=g, device=dev).bfloat16()
    v = torch.randn((2, 700, 2, 160), generator=g, device=dev).bfloat16()
    a = fa_ops.flash_attention(q, k, v, window=300)
    b = fa_ops.flash_attention(q, k, v, window=300)
    assert torch.equal(a, b)


def _tma_unfit(kind, dtype, dev):
    """q, k, v whose layout the tensor maps cannot take: a base 8 bytes past
    a 16-byte boundary, or an h stride of 20 elements (40 bytes)."""
    if kind == "base":
        buf = torch.zeros((1, 16, 2, 32), dtype=dtype, device=dev)
        x = buf[..., 4:20]
    else:
        buf = torch.zeros((1, 16, 2, 20), dtype=dtype, device=dev)
        x = buf[..., :16]
    return x, x[:, :, :1], x[:, :, :1]


@pytest.mark.parametrize("kind", ["base", "stride"])
def test_flash_attention_refuses_tma_unfit_bf16_before_launch(dev, kind):
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    n0, t0 = fa_ops.flash_attention.launches, fa_ops.flash_attention.tensor_core_launches
    with pytest.raises(ValueError, match="TMA"):
        fa_ops.flash_attention(*_tma_unfit(kind, torch.bfloat16, dev))
    assert fa_ops.flash_attention.launches == n0
    assert fa_ops.flash_attention.tensor_core_launches == t0
    # the same layout in f32 goes to the CUDA-core kernel
    q, k, v = _tma_unfit(kind, torch.float32, dev)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n0 + 1
    assert fa_ops.flash_attention.tensor_core_launches == t0
    torch.testing.assert_close(got, fa_ref.attention_ref(q, k, v), atol=2e-5, rtol=0)


def test_flash_attention_reads_strided_inputs(dev):
    """q, k and v as views of one fused projection (no copies made)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 64, 8, 32), generator=g, device=dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("hd", [12, 264])
def test_flash_attention_refuses_unsupported_head_dims(dev, hd):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = torch.zeros((1, 16, 2, hd), device=dev)
    n0 = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert fa_ops.flash_attention.launches == n0


def test_serve_two_layers_full_width_on_card_equals_cpu(dev):
    """stablelm_12b at full width, 2 layers, f32 compute: greedy tokens from
    the card (B4) equal the CPU's (B4's plain version)."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("stablelm_12b"), num_layers=2, dtype="float32",
                              param_dtype="bfloat16", attention_impl="pallas")
    api = zoo.build(cfg)
    tree = convert.lm_params_to_numpy(api.init_params(5, device=dev))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 64))
    out = {}
    for d in (dev, torch.device("cpu")):
        params = convert.lm_params_from_numpy(cfg, tree, device=d)
        res = serve_batch(api, params, {"tokens": torch.from_numpy(toks).to(d)}, 4)
        out[d.type] = res
    assert out["cuda"].prefill_launches["flash_attention"] == 2
    assert out["cuda"].decode_launches["flash_attention"] == 0
    np.testing.assert_array_equal(out["cuda"].tokens, out["cpu"].tokens)


# ---------------------------------------------------------------------------
# B5, the SSD chunked scan, and the Mamba2 serve path
# ---------------------------------------------------------------------------
def _ssd_operands(B, S, H, G, N, P, dtype, dev, seed, *, strided=False):
    """x, B and C as views into one [B, S, H*P + 2*G*N (+ 8)] buffer, as the
    model's conv output holds them; dt = softplus(normal) / 2 and a distinct
    A < 0 per head, as ``tests/test_kernels.py`` draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = H * P + 2 * G * N + (8 if strided else 0)
    buf = torch.randn((B, S, width), generator=g, device=dev)
    buf[..., H * P:] *= 0.5
    buf = buf.to(dtype)
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = buf[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev)) * 0.5
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    return x, dt, a, Bm, Cm


# bf16 B5 against the recurrence in f32 on the same bf16 inputs: the
# largest |y - want| / |want| over the rows (b, s, h) of P values. The
# kernel rounds four things to bf16 (each off by at most u = 2^-8 of
# itself): the decayed scores, w_j x_j, the state's snapshot and y. Where
# the terms of a row do not cancel that is at most 3u = 1.2e-2 (the state's
# path: w x, snapshot, y); where they cancel, the errors add in quadrature
# and rows of few values (P 8) spread the most. 2e-2 leaves that tail room
# (PERF.md Sec. 6 derives it).
_B5_BF16_ROW_REL = 2e-2


def _assert_b5_rows_close(got, x, dt, a, Bm, Cm, tail=None):
    """Each row of bf16 ``got`` within _B5_BF16_ROW_REL of its norm of the
    f32 recurrence over (x, dt, a, Bm, Cm); ``tail``: got holds only the
    last ``tail`` positions."""
    from repro_torch.kernels.ssd_scan import ref as ss_ref

    want, _ = ss_ref.ssd_ref_model_layout(x.float(), dt, a, Bm.float(), Cm.float())
    want = want[:, want.shape[1] - (tail or want.shape[1]):]
    d = (got.double() - want.double()).norm(dim=-1)
    rel = float((d / want.double().norm(dim=-1).clamp_min(1e-30)).max())
    assert rel <= _B5_BF16_ROW_REL, f"a row is {rel} of its norm off the f32 recurrence"


def test_ssd_scan_kernel_equals_plain_at_the_prefill_shape(dev):
    """mamba2_370m's prefill (x bf16 [4, 32768, 32, 64], G = 1, N = 128,
    Q = 256) with strided x, B and C, against the plain version in f32 cast
    once (tests/test_kernels.py's bf16 tolerance), on the tensor-core route;
    each row also against the f32 recurrence."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _ssd_operands(4, 32768, 32, 1, 128, 64, torch.bfloat16, dev, 0,
                                     strided=True)
    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    y, st = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=256)
    want_y, want_st = ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert ss_ops.ssd_scan.launches == n0 + 1
    assert ss_ops.ssd_scan.tensor_core_launches == t0 + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, want_st, atol=5e-2, rtol=5e-2)
    del want_y, want_st
    _assert_b5_rows_close(y, x, dt, a, Bm, Cm)


@pytest.mark.parametrize("B,S,H,G,N,P,Q,strided,init", [
    (1, 512, 8, 2, 128, 64, 64, False, False),    # G = 2, rep 4, the model's N and P
    (1, 512, 8, 2, 128, 64, 256, True, False),    # the model's chunk, conv-output views
    (2, 288, 8, 2, 32, 16, 96, False, False),     # ragged: Q 96, tiles into the next chunk
    (2, 100, 4, 4, 8, 8, 20, True, False),        # N 8, P 8, Q 20, rep 1
    (2, 400, 8, 2, 32, 16, 20, False, True),      # Q 20 from a carried state
    (1, 512, 8, 2, 128, 64, 128, True, True),     # init_state, conv-output views
    (2, 256, 4, 1, 8, 64, 256, False, False),     # N 8 (one k-step), P 64
    (1, 256, 4, 2, 128, 8, 64, True, False),      # N 128, P 8
    (2, 192, 4, 2, 64, 40, 192, False, False),    # N 64 (one box), P 40, three tiles
    (1, 128, 4, 1, 96, 24, 32, True, True),       # N 96 (a part box), P 24
    (1, 16, 2, 1, 16, 16, 1, False, False),       # Q 1: a chunk a token
])
def test_ssd_scan_tensor_cores_equal_plain_and_recurrence(dev, B, S, H, G, N, P, Q, strided,
                                                          init):
    """bf16 on the tensor-core kernel across the wrapper's range, against the
    plain version at tests/test_kernels.py's 5e-2 and each row against the
    f32 recurrence; ``init``: the second half from the first half's state."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _ssd_operands(B, S, H, G, N, P, torch.bfloat16, dev, S + N + P,
                                     strided=strided)
    t0 = ss_ops.ssd_scan.tensor_core_launches
    if init:
        h = S // 2
        _, mid = ss_ops.ssd_scan(x[:, :h], dt[:, :h], a, Bm[:, :h], Cm[:, :h], chunk=Q)
        assert mid.abs().max() > 0.1
        args = (x[:, h:], dt[:, h:], a, Bm[:, h:], Cm[:, h:])
    else:
        mid, args = None, (x, dt, a, Bm, Cm)
    y, st = ss_ops.ssd_scan(*args, chunk=Q, init_state=mid)
    want_y, want_st = ss_ref.ssd_scan_ref(*args, chunk=Q, init_state=mid)
    torch.cuda.synchronize()
    assert ss_ops.ssd_scan.tensor_core_launches == t0 + 1 + int(init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, want_st, atol=5e-2, rtol=5e-2)
    _assert_b5_rows_close(y, x, dt, a, Bm, Cm, tail=y.shape[1])


def test_ssd_scan_tensor_cores_are_deterministic(dev):
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    x, dt, a, Bm, Cm = _ssd_operands(2, 1024, 8, 2, 128, 64, torch.bfloat16, dev, 12,
                                     strided=True)
    init = torch.randn((2, 8, 128, 64), generator=torch.Generator(device=dev).manual_seed(13),
                       device=dev)
    y1, s1 = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=256, init_state=init)
    y2, s2 = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=256, init_state=init)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def _ssd_tma_unfit(kind, dtype, dev):
    """x, dt, a, Bm, Cm whose layout the tensor maps cannot take: Bm based 8
    bytes past a 16-byte boundary, or Cm with a g stride of 20 elements."""
    S, H, G, N, P = 64, 4, 2, 16, 16
    x = torch.randn((1, S, H, P), device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((1, S, H), device=dev)) * 0.5
    a = -torch.ones((H,), device=dev)
    Cm = torch.randn((1, S, G, N), device=dev).to(dtype) * 0.5
    if kind == "base":
        flat = torch.randn((S * G * N + 8,), device=dev).to(dtype) * 0.5
        Bm = flat[8 // flat.element_size():][:S * G * N].view(1, S, G, N)
    else:
        Bm = (torch.randn((1, S, G, N + 4), device=dev).to(dtype) * 0.5)[..., :N]
        Cm = (torch.randn((1, S, G, N + 4), device=dev).to(dtype) * 0.5)[..., :N]
    return x, dt, a, Bm, Cm


@pytest.mark.parametrize("kind", ["base", "stride"])
def test_ssd_scan_refuses_tma_unfit_bf16_before_launch(dev, kind):
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    with pytest.raises(ValueError, match="TMA"):
        ss_ops.ssd_scan(*_ssd_tma_unfit(kind, torch.bfloat16, dev), chunk=32)
    assert ss_ops.ssd_scan.launches == n0
    assert ss_ops.ssd_scan.tensor_core_launches == t0
    # the same layout in f32 goes to the CUDA-core kernel
    args = _ssd_tma_unfit(kind, torch.float32, dev)
    y, st = ss_ops.ssd_scan(*args, chunk=32)
    want_y, want_st = ss_ref.ssd_ref_model_layout(*args)
    torch.cuda.synchronize()
    assert ss_ops.ssd_scan.launches == n0 + 1
    assert ss_ops.ssd_scan.tensor_core_launches == t0
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("B,S,H,G,N,P,Q,strided", [
    (1, 512, 8, 2, 128, 64, 64, False),     # G = 2, rep = 4, the model's N and P
    (1, 512, 8, 2, 128, 64, 256, True),     # the model's chunk, strided views
    (2, 288, 8, 2, 32, 16, 96, False),      # Q not a power of two: a ragged tile
    (2, 100, 4, 4, 8, 8, 20, True),         # rep 1, Q 20
    (2, 64, 4, 1, 16, 16, 16, False),       # tests/test_kernels.py's cases
    (1, 128, 4, 2, 32, 16, 32, False),
    (2, 64, 2, 2, 16, 32, 64, False),
])
def test_ssd_scan_kernel_equals_recurrence(dev, B, S, H, G, N, P, Q, strided):
    """f32, on the CUDA-core kernel, against the recurrence."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _ssd_operands(B, S, H, G, N, P, torch.float32, dev, S + Q,
                                     strided=strided)
    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    y, st = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)
    want_y, want_st = ss_ref.ssd_ref_model_layout(x, dt, a, Bm, Cm)
    torch.cuda.synchronize()
    assert ss_ops.ssd_scan.launches == n0 + 1
    assert ss_ops.ssd_scan.tensor_core_launches == t0
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


def test_ssd_scan_kernel_carries_init_state(dev):
    """The second half of the sequence from the first half's state equals the
    recurrence over the whole sequence (y of the second half, final state)."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _ssd_operands(2, 512, 8, 2, 128, 64, torch.float32, dev, 9)
    _, mid = ss_ops.ssd_scan(x[:, :256], dt[:, :256], a, Bm[:, :256], Cm[:, :256],
                             chunk=128)
    assert mid.abs().max() > 0.1
    y2, st = ss_ops.ssd_scan(x[:, 256:], dt[:, 256:], a, Bm[:, 256:], Cm[:, 256:],
                             chunk=128, init_state=mid)
    want_y, want_st = ss_ref.ssd_ref_model_layout(x, dt, a, Bm, Cm)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, want_y[:, 256:], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("N,P,Q", [(12, 16, 16), (256, 16, 16), (16, 72, 16),
                                   (16, 16, 512)])
def test_ssd_scan_refuses_unsupported_shapes(dev, N, P, Q):
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    x, dt, a, Bm, Cm = (t.cuda() for t in (torch.zeros(1, 512, 2, P), torch.zeros(1, 512, 2),
                                           torch.zeros(2), torch.zeros(1, 512, 1, N),
                                           torch.zeros(1, 512, 1, N)))
    n0 = ss_ops.ssd_scan.launches
    with pytest.raises(ValueError):
        ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)
    assert ss_ops.ssd_scan.launches == n0


def test_serve_mamba2_two_layers_full_width_on_card_equals_cpu(dev):
    """mamba2_370m at full width, 2 layers, f32 compute, 2 x 512 prompts (two
    chunks): prefill logits of the card (B5) within 1e-3 of the CPU's (the
    jnp twin) and equal greedy tokens; B5 once a layer in the prefill only."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2_370m"), num_layers=2, dtype="float32",
                              param_dtype="bfloat16")
    api = zoo.build(cfg)
    tree = convert.lm_params_to_numpy(api.init_params(5, device=dev))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 512))
    out = {}
    for d in (dev, torch.device("cpu")):
        params = convert.lm_params_from_numpy(cfg, tree, device=d)
        batch = {"tokens": torch.from_numpy(toks).to(d)}
        with torch.no_grad():
            logits, _ = api.prefill(params, batch, 0)
        out[d.type] = (logits.float().cpu(), serve_batch(api, params, batch, 4))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-3, rtol=0)
    assert out["cuda"][1].prefill_launches["ssd_scan"] == 2
    assert out["cuda"][1].decode_launches["ssd_scan"] == 0
    np.testing.assert_array_equal(out["cuda"][1].tokens, out["cpu"][1].tokens)


# ---------------------------------------------------------------------------
# H2 (binomial) and H3 (hypergeometric)
# ---------------------------------------------------------------------------
def test_binomial_kernel_equals_plain(dev):
    """H2 on 16,384 rows of both routes, the route boundary, counts up to
    2^22 and the edges: bit for bit its plain version on the card, in one
    launch."""
    from repro_torch.kernels.variates import cases, ops as va_ops, ref as va_ref

    keys, count, p = cases.binomial_rows(16_384, dev, seed=3)
    n0 = va_ops.binomial.launches
    got = va_ops.binomial(keys, count, p)
    want = va_ref.binomial_ref(keys, count, p)
    torch.cuda.synchronize()
    assert va_ops.binomial.launches == n0 + 1
    assert torch.equal(got, want)
    assert ((got >= 0) & (got <= count)).all()


def test_hypergeometric_kernel_equals_plain(dev):
    """H3 on 4,096 rows (B-RS-like supports up to 65,537, small and edge
    populations) and on its block-edge rows (``cases.hypergeometric_edge_rows``:
    hits on the first and last trip of a block, hi mid-block, supports of
    exactly one block and one more trip, the guard), the latter also under
    trips caps inside and at the end of the first block: bit for bit its
    plain version on the card, one launch a call."""
    from repro_torch.kernels.variates import cases, kernel, ops as va_ops, ref as va_ref

    u, k, a, b = cases.hypergeometric_rows(4096, dev, seed=4)
    eu, ek, ea, eb, _ = cases.hypergeometric_edge_rows(dev)
    calls = [(u, k, a, b, cases.H3_TRIPS)] + [
        (eu, ek, ea, eb, trips) for trips in (cases.H3_TRIPS, cases.H3_CAP_MID_BLOCK, 1, 31,
                                              kernel.H3_BLOCK, kernel.H3_BLOCK + 1)]
    for cu, ck, ca, cb, trips in calls:
        n0 = va_ops.hypergeometric.launches
        got = va_ops.hypergeometric(cu, ck, ca, cb, trips)
        want = va_ref.hypergeometric_ref(cu, ck, ca, cb, trips)
        torch.cuda.synchronize()
        assert va_ops.hypergeometric.launches == n0 + 1
        assert torch.equal(got, want), trips
        assert ((got >= torch.clamp(ck - cb, min=0)) & (got <= torch.minimum(ca, ck))).all()


def test_variates_without_host_sync(dev):
    from repro_torch.kernels.variates import cases, ops as va_ops

    keys, count, p = cases.binomial_rows(1024, dev)
    u, k, a, b = cases.hypergeometric_rows(1024, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = va_ops.binomial(keys, count, p)
        y = va_ops.hypergeometric(u, k, a, b, cases.H3_TRIPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert x.shape == (1024,) and y.shape == (1024,)


@pytest.mark.parametrize("scheme,hyper", [
    ("ttbs", dict(n=255, lam=0.05, batch_size=32)), ("btbs", dict(lam=0.05, cap=1024)),
    ("brs", dict(n=255)), ("sw", dict(n=255))])
def test_simple_schemes_card_equal_cpu(dev, scheme, hyper):
    """Each scheme's loop over 16 ticks on the card (B1, H2, H3) equals the
    CPU's (their plain versions) bit for bit: items, count, overflow, W."""
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    out = {}
    for d in (dev, torch.device("cpu")):
        batches, bcounts = materialize_stream(LinRegStream(seed=4), 16,
                                              batch_size=lambda t: 32 if t < 8 else 5,
                                              bcap=32, device=d)
        run = make_run_loop(make_sampler(scheme, **hyper, device=d),
                            make_model("linreg", dim=2, device=d), retrain_every=4)
        out[d.type] = run(prng.key(2), batches, bcounts)
    (sg, _, tg), (sc, _, tc) = out["cuda"], out["cpu"]
    for f in ("x", "y"):
        assert torch.equal(sg.items[f].cpu(), sc.items[f])
    for a, b in ((sg.count, sc.count), (sg.overflow, sc.overflow),
                 (sg.total_weight, sc.total_weight), (tg["size"], tc["size"])):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_gradients_are_the_plain_forms(dev, dtype):
    """B5 under autograd on the card: the forward launches the kernel once,
    the backward launches none and returns exactly
    ``ops.ssd_scan_backward``'s gradients (the plain chunked form's, given
    the same cotangent), and two backward passes agree bit for bit."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    g = torch.Generator(device=dev).manual_seed(26)
    B, S, H, G, N, P, Q = 2, 512, 8, 1, 64, 64, 256
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=dev))
    a = -torch.ones(H, device=dev)
    Bm = torch.randn(B, S, G, N, generator=g, device=dev).to(dtype)
    Cm = torch.randn(B, S, G, N, generator=g, device=dev).to(dtype)
    gy = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    outs = []
    for _ in range(2):
        live = [t.clone().requires_grad_(True) for t in (x, dt, a, Bm, Cm)]
        n0 = ss_ops.ssd_scan.launches
        y, _ = ss_ops.ssd_scan(*live, chunk=Q)
        assert ss_ops.ssd_scan.launches == n0 + 1
        outs.append(torch.autograd.grad(y, live, gy))
        assert ss_ops.ssd_scan.launches == n0 + 1
    want = ss_ops.ssd_scan_backward(x, dt, a, Bm, Cm, None, Q, gy, None)
    for u, v, w in zip(outs[0], outs[1], want):
        assert torch.isfinite(u).all() and torch.equal(u, v) and torch.equal(u, w)


def test_flash_attention_refuses_gradients_on_the_card(dev):
    """B4 has no backward: a CUDA call whose inputs require grad raises under
    grad mode instead of returning an output cut off from the graph; without
    grad mode it runs."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, q, q)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, q, q).shape == q.shape
