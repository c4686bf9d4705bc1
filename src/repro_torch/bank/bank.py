"""Keyed multi-tenant sampler banks (the JAX package's ``repro.bank.bank``).

K independent per-key samples, R-TBS reservoirs (``"rtbs"``) or T-TBS
buffers (``"ttbs"``), stored as one stacked structure of arrays (payload
leaves [K, cap, ...] plus per-key [K] columns) behind an
``init / step / extract`` protocol, advanced in work proportional to the
tick's BATCH, not to K:

  * **routing** (:mod:`.routing`): one stable argsort buckets the tick's
    ``(keys, payload)`` arrivals into at most b per-key segments with a
    static per-key sub-batch capacity ``bcap``;
  * **touched keys** are advanced by the scheme's own tick, composed per
    key: :func:`repro_torch.core.rtbs.tick_map` or T-TBS's slot map
    broadcast over the b routed rows, each row drawing from its own key
    (the tick key with the key id folded in, on the device; T-TBS's two
    binomials of all b rows in one H2 launch), then ONE banked payload pass
    for every item leaf, the B3 kernel (:func:`repro_torch.kernels.tbs_step.
    ops.tbs_step_apply_banked`), which reads the sub-batches straight from
    the tick's payload and rewrites the touched reservoirs in place;
  * **inactive keys** take the pure-decay fast path: every key's
    ``pending`` factor is multiplied by the tick's decay, one [K] op and no
    payload movement. The deferred downsample is composed into the key's
    next touch (the tick map runs with ``d_eff = pending``) or into its
    extract view; Theorem 4.1 makes the composition exact in distribution.

**A step consumes its state.** The JAX scan carry aliases the bank in
place; a functional copy here would move the whole bank (about 0.8 GB at
K = 2^20, cap 65) every tick. So ``step`` writes the touched reservoirs
into the input state's item tensors and returns a state that shares them:
the state passed in must not be used afterwards. The [K] columns are new
tensors. The CPU path has the same semantics.

Nothing in a step is read on the host: the touched count, the scalar
columns and the decay stay device tensors, and the scalar columns scatter
through a ``[K + 1]`` buffer whose last row takes the sentinel rows (JAX's
``mode="drop"``).

**Key-sharded banks** (:func:`shard_bank`, for the JAX package's
``make_sharded_bank_loop``): S banks of K_s keys each, every state leaf with
a leading [S] dimension, stepped together. A step takes the co-partitioned
tick (local key ids, a count a shard), compacts the shards' valid rows into
one batch with global ids (:func:`.routing.compact_shards`) and runs the
scheme's tick once over the S K_s keys, so the payload pass (B3) launches
once a tick for all shards. Each key draws from the tick key with its LOCAL
id folded in, as JAX's shards do with the replicated tick key (ROADMAP
C.18): local key j of every shard draws the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.core import latent as lt
from repro_torch.core import prng, rng, rtbs, simple
from repro_torch.core.api import SampleView
from repro_torch.decay import DecaySchedule
from repro_torch.decay import resolve as _resolve_schedule
from repro_torch.kernels.tbs_step import ops as tbs_ops
from repro_torch.obs.profile import scope as _scope

from . import routing

_I32, _I64, _F32 = torch.int32, torch.int64, torch.float32


@dataclasses.dataclass
class BankState:
    """K stacked per-key reservoirs in structure-of-arrays form.

    ``items`` leaves are [K, cap, ...]. For ``rtbs``: ``nfull`` = floor(C)
    of the STORED latent, ``weight`` = stored sample weight C,
    ``total_weight`` = W as of the key's last touch; for ``ttbs``:
    ``nfull`` = the buffer count (``weight`` mirrors it as f32). ``pending``
    is the per-key composed decay factor since the key's last touch (1.0
    right after a touch); the key's effective totals are
    ``W_eff = pending * total_weight`` and, for rtbs,
    ``C_eff = min(weight, W_eff)``. ``overflow`` counts per-key items
    dropped by the routing ``bcap`` or the buffer's capacity.
    ``dstate`` is the shared decay-schedule bookkeeping (None for
    constant-rate schedules)."""

    items: Any
    nfull: torch.Tensor         # [K] int32
    weight: torch.Tensor        # [K] float32
    total_weight: torch.Tensor  # [K] float32
    pending: torch.Tensor       # [K] float32
    overflow: torch.Tensor      # [K] int32
    dstate: Any


pytree.register_dataclass(BankState)


@dataclasses.dataclass(frozen=True, eq=False)
class SamplerBank:
    """K per-key sampling schemes bound to their hyperparameters and device.

      * ``init(item_proto) -> BankState``
      * ``step(key, state, keys, payload, bcount, dt=None) -> BankState``:
        consume one keyed batch (``keys`` [b], payload leaves [b, ...],
        valid prefix ``bcount``); ``dt`` is the wall-clock gap the tick
        spans. Consumes ``state`` (see the module docstring).
      * ``step_decayed(key, state, keys, payload, bcount, d)``: the step
        with the tick's decay factor given from outside (scalar or [K]).
      * ``step_stats`` / ``step_decayed_stats``: the same, returning
        ``(state, stats)`` with the tick's ``overflow``, ``ntouched``,
        ``invalid`` and ``decay``, all device tensors, and its
        ``routing`` (:class:`.routing.Routing`).
      * ``extract(key, state, key_ids) -> SampleView``: the listed keys'
        realized samples, stacked (leaves [Q, cap, ...], mask [Q, cap],
        size [Q]), pending decay settled in the view.
      * ``size(key, state, key_ids) -> [Q]``: payload-free, equal to
        ``extract``'s sizes for the same key.
      * ``base_rate(state, dt=None)``: the schedule's factor this tick.

    ``key_ids`` is a host sequence, checked on the host (an id outside
    [0, K) raises), or a device tensor, clamped into range; neither form
    syncs.

    A key-sharded bank (:func:`shard_bank`) keeps ``num_keys`` = K_s, the
    keys of ONE shard, and ``hyper["shards"]`` = S: its state's leaves are
    [S, K_s, ...]; a step takes ``keys`` [S * b_s] (local ids, shard s
    owning rows [s b_s, (s + 1) b_s)), payload leaves [S * b_s, ...],
    ``bcount`` [S] and ``rows=``, the routed batch size (default S * b_s;
    at least the tick's valid count; a local bank ignores it); its
    stats' ``overflow``,
    ``ntouched`` and ``invalid`` are [S] and it adds ``payload``, the
    routed rows; ``extract`` / ``size`` take local ids and return leaves
    [S, Q, ...]. ``step_decayed`` takes a scalar or [S, K_s] factor."""

    scheme: str
    num_keys: int
    cap: int
    bcap: int
    init: Callable[[Any], BankState]
    step: Callable[..., BankState]
    step_decayed: Callable[..., BankState]
    step_stats: Callable[..., tuple]
    step_decayed_stats: Callable[..., tuple]
    extract: Callable[..., SampleView]
    size: Callable[..., torch.Tensor]
    base_rate: Callable[..., torch.Tensor]
    hyper: Mapping[str, Any]
    device: torch.device

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"SamplerBank({self.scheme}, K={self.num_keys}, {hp})"


_REGISTRY: dict[str, Callable[..., SamplerBank]] = {}


def register_bank(name: str):
    """Decorator: register a ``(num_keys=..., device=..., **hyper) ->
    SamplerBank`` builder under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_bank_schemes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_bank(scheme: str, *, num_keys: int, device=None, **hyper) -> SamplerBank:
    """Construct a registered bank scheme, e.g.
    ``make_bank("rtbs", num_keys=2**20, n=64, lam=0.05, bcap=32)``.
    ``device=None`` means the CUDA card (raises without one)."""
    builder = _REGISTRY.get(scheme)
    if builder is None:
        raise ValueError(f"unknown bank scheme {scheme!r}; available: "
                         f"{available_bank_schemes()}")
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1; got {num_keys}")
    return builder(num_keys=num_keys, device=_device.resolve(device), **hyper)


def shard_bank(bank: SamplerBank, shards: int) -> SamplerBank:
    """``shards`` banks like ``bank`` (its ``num_keys`` keys each, its
    hyperparameters and device) as ONE key-sharded bank whose state's
    leaves carry a leading [shards] dimension (see :class:`SamplerBank`)."""
    if "shards" in bank.hyper:
        raise ValueError(f"{bank!r} is already key-sharded")
    if int(shards) < 1:
        raise ValueError(f"shards must be at least 1; got {shards}")
    hyper = {k: v for k, v in bank.hyper.items() if k != "lam"}
    return _REGISTRY[bank.scheme](num_keys=bank.num_keys, device=bank.device,
                                  shards=int(shards), **hyper)


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------
def _init_bank_state(item_proto: Any, num_keys: int, cap: int, init_dstate,
                     device, shards: int | None = None) -> BankState:
    """The zeroed K-key state (leaves [S, K, ...] for ``shards`` = S)."""
    lead = (num_keys,) if shards is None else (shards, num_keys)
    items = pytree.tree_map(
        lambda p: torch.zeros(lead + (cap,) + tuple(p.shape), dtype=p.dtype,
                              device=device), item_proto)
    return BankState(
        items=items,
        nfull=torch.zeros(lead, dtype=_I32, device=device),
        weight=torch.zeros(lead, dtype=_F32, device=device),
        total_weight=torch.zeros(lead, dtype=_F32, device=device),
        pending=torch.ones(lead, dtype=_F32, device=device),
        overflow=torch.zeros(lead, dtype=_I32, device=device),
        dstate=init_dstate(),
    )


_COLUMNS = ("nfull", "weight", "total_weight", "pending", "overflow")


def _flat(state: BankState, shards: int | None) -> BankState:
    """A key-sharded state's S K_s keys as one bank's (views of its
    tensors, so the payload pass still writes in place); a local state as
    it is."""
    if shards is None:
        return state
    items = pytree.tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), state.items)
    return BankState(items, *(getattr(state, f).reshape(-1) for f in _COLUMNS),
                     dstate=state.dstate)


def _unflat(state: BankState, shards: int | None) -> BankState:
    if shards is None:
        return state
    items = pytree.tree_map(lambda a: a.reshape((shards, -1) + tuple(a.shape[1:])),
                            state.items)
    return BankState(items, *(getattr(state, f).reshape(shards, -1) for f in _COLUMNS),
                     dstate=state.dstate)


def _fold_ids(ids: torch.Tensor, local: int | None) -> torch.Tensor:
    """The ids a key's draws fold in: its own, or its LOCAL id in a
    key-sharded bank of ``local`` keys a shard (ROADMAP C.18)."""
    return ids if local is None else torch.remainder(ids, local)


def _as_f32(d, device) -> torch.Tensor:
    """A decay factor (float, 0-d or [K] tensor) as an f32 device tensor,
    without a host-to-device copy for a float."""
    if isinstance(d, torch.Tensor):
        return d.to(device=device, dtype=_F32)
    return torch.full((), float(d), dtype=_F32, device=device)


def _make_steps(sched_tick, advance, device, *, num_keys: int, bcap: int,
                shards: int | None):
    """(step, step_decayed, step_stats, step_decayed_stats) from a scheme's
    ``advance(key, state, routing, payload, d, new_dstate, local) ->
    (state, dropped)`` (``dropped``: the items each routed row drops):
    ``step`` pulls the tick's factor from the shared schedule (over a
    wall-clock gap ``dt`` if given); ``step_decayed`` applies an external
    factor while the schedule's bookkeeping still advances. A step routes
    the tick, then advances; a key-sharded one compacts it first and
    advances the shards' keys as one bank."""
    K = num_keys

    def routed(key, state, keys, payload, bcount, d, new_dstate, rows):
        if shards is None:
            with _scope("bank.route"):
                r = routing.route(keys, bcount, num_keys=K, bcap=bcap)
            state, dropped = advance(key, state, r, payload, d, new_dstate, None)
            return state, _tick_stats(r, d, dropped.sum())
        with _scope("bank.route"):
            c = routing.compact_shards(keys, bcount, num_keys=K, rows=rows)
            payload = pytree.tree_map(lambda a: a[c.rows], payload)
            r = routing.route(c.keys, c.count, num_keys=shards * K, bcap=bcap)
        new, dropped = advance(key, _flat(state, shards), r, payload,
                               d if d.dim() == 0 else d.reshape(-1), new_dstate, K)
        # per shard: the shard of a routed row's key (the sentinel's is S)
        of = torch.div(r.touched, K, rounding_mode="floor")

        def per_shard(v):
            return v.new_zeros(shards + 1).index_add_(0, of, v)[:shards]

        stats = _tick_stats(r, d, per_shard(dropped))
        stats.update(ntouched=per_shard(torch.ones_like(of)), invalid=c.invalid,
                     payload=payload)
        return _unflat(new, shards), stats

    def step_stats(key, state, keys, payload, bcount, dt=None, *, rows=None):
        d, new_dstate = sched_tick(state.dstate, dt)
        return routed(key, state, keys, payload, bcount, d, new_dstate, rows)

    def step_decayed_stats(key, state, keys, payload, bcount, d, *, rows=None):
        _, new_dstate = sched_tick(state.dstate, None)
        return routed(key, state, keys, payload, bcount, _as_f32(d, device), new_dstate,
                      rows)

    def step(key, state, keys, payload, bcount, dt=None, *, rows=None):
        return step_stats(key, state, keys, payload, bcount, dt, rows=rows)[0]

    def step_decayed(key, state, keys, payload, bcount, d, *, rows=None):
        return step_decayed_stats(key, state, keys, payload, bcount, d, rows=rows)[0]

    return step, step_decayed, step_stats, step_decayed_stats


def _key_ids(key_ids, num_keys: int, device) -> torch.Tensor:
    """extract/size key lists: a device tensor is clamped into [0, K) (the
    JAX package's traced branch); a host sequence is checked on the host,
    since a clamp would alias a bad id onto another tenant's reservoir, and
    copied to the device without a sync."""
    if isinstance(key_ids, torch.Tensor) and key_ids.device.type != "cpu":
        return key_ids.to(_I64).clamp(0, num_keys - 1)
    ids = np.asarray(key_ids, np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= num_keys):
        raise ValueError(f"key_ids must lie in [0, {num_keys}); got range "
                         f"[{ids.min()}, {ids.max()}]")
    return torch.from_numpy(ids).to(device, non_blocking=True)


def _view_ids(key_ids, num_keys: int, shards: int | None, device):
    """extract/size ids: ``(rows, fold ids, out)``, the listed keys' rows of
    the (flat) state, the ids their draws fold in, and ``out`` reshaping a
    result's [S * Q, ...] rows to [S, Q, ...] (identity for a local bank)."""
    ids = _key_ids(key_ids, num_keys, device)
    if shards is None:
        return ids, ids, lambda a: a
    Q = ids.shape[0]
    base = torch.arange(shards, dtype=_I64, device=device).unsqueeze(-1) * num_keys
    return ((base + ids).reshape(-1), ids.repeat(shards),
            lambda a: a.reshape((shards, Q) + tuple(a.shape[1:])))


def _schedule_fns(sched: DecaySchedule, device, shards: int | None = None):
    """(init_dstate, tick): the bank's shared-schedule decay source.
    Constant-rate schedules carry no state (``dstate`` stays None) and bake
    the factor in as one f32 device tensor made here, not per tick. A
    key-sharded bank keeps S copies of the schedule's state (JAX's
    gathered form), ticked as one."""
    if sched.static_rate is not None:
        d0 = torch.full((), sched.static_rate, dtype=_F32, device=device)
        t0 = torch.zeros((), dtype=_F32, device=device)

        def tick(dstate, dt):
            return (d0 if dt is None else sched.factor_dt(t0, dt)), None

        return (lambda: None), tick
    if shards is None:
        return (lambda: sched.init(device)), sched.tick

    def stacked(tree):
        return pytree.tree_map(
            lambda a: a.unsqueeze(0).expand((shards,) + tuple(a.shape)).clone(), tree)

    def tick(dstate, dt):
        d, new = sched.tick(pytree.tree_map(lambda a: a[0], dstate), dt)
        return d, stacked(new)

    return (lambda: stacked(sched.init(device))), tick


def _scatter(a: torch.Tensor, touched: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a.at[touched].set(v, mode="drop")`` for a [K] column: the sentinel
    rows (key K) land in a trash row past the end."""
    K = a.shape[0]
    buf = torch.cat([a, a.new_zeros(1)])
    return buf.index_copy_(0, touched, v.to(a.dtype))[:K]


def _scatter_add(a: torch.Tensor, touched: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a.at[touched].add(v, mode="drop")`` for a [K] column."""
    K = a.shape[0]
    buf = torch.cat([a, a.new_zeros(1)])
    return buf.index_add_(0, touched, v.to(a.dtype))[:K]


def _tick_stats(r: routing.Routing, d, overflow) -> dict:
    return {"overflow": overflow, "ntouched": r.ntouched,
            "invalid": r.invalid, "decay": d, "routing": r}


def _rtbs_tick_map(key, state: BankState, keys, bcount, pending, *, n: int,
                   bcap: int):
    """An R-TBS bank tick up to its payload pass: route the arrivals, then
    compose each touched key's tick map from its own draws (the tick key
    with the key id folded in). ``pending`` is the [K] deferred factor with
    this tick's decay already composed in. Returns ``(routing, src [b, cap],
    nfull, C, W)``, the last three per routed row."""
    with _scope("bank.route"):
        r = routing.route(keys, bcount, num_keys=state.nfull.shape[0], bcap=bcap)
    return (r,) + _rtbs_routed_map(key, state, r, pending, n=n, bcap=bcap)


def _rtbs_routed_map(key, state: BankState, r: routing.Routing, pending, *, n: int,
                     bcap: int, local: int | None = None):
    """:func:`_rtbs_tick_map` past its routing ``r``; a key's draws fold
    in :func:`_fold_ids` of its id."""
    K, cap = state.nfull.shape[0], n + 1
    with _scope("bank.tick_map"):
        idx = torch.clamp(r.touched, max=K - 1)   # clipped gather; rows drop
        draws = rtbs.draw_tick(prng.fold_in(key, _fold_ids(r.touched, local)), cap=cap,
                               bcap=bcap, device=state.nfull.device)
        src, C3, w_new = rtbs.tick_map(
            draws, state.nfull[idx], state.weight[idx], state.total_weight[idx],
            r.counts, pending[idx], cap=cap, bcap=bcap, n=n)
        k3, _ = lt.floor_frac(C3)
    return src, k3, C3, w_new


# ---------------------------------------------------------------------------
# R-TBS bank
# ---------------------------------------------------------------------------
@register_bank("rtbs")
def _make_rtbs_bank(*, num_keys: int, n: int, lam: float | None = None,
                    decay: DecaySchedule | None = None, bcap: int = 64,
                    device: torch.device, shards: int | None = None) -> SamplerBank:
    """K independent R-TBS reservoirs (paper Alg. 2 per key): bounded size n
    and exact time bias for every key, whatever its arrival pattern.
    ``bcap`` is the static per-key sub-batch capacity (arrivals beyond it
    are dropped and counted). ``shards``: the key-sharded form
    (:func:`shard_bank`)."""
    sched = _resolve_schedule(lam, decay)
    cap = n + 1
    K = num_keys
    init_dstate, sched_tick = _schedule_fns(sched, device, shards)

    def init(item_proto: Any) -> BankState:
        return _init_bank_state(item_proto, K, cap, init_dstate, device, shards)

    def _advance(key, state: BankState, r, payload, d, new_dstate, local):
        # inactive keys: every key's deferred factor composes the tick's
        # decay, one [K] multiply and no payload movement
        with _scope("bank.decay"):
            pending = state.pending * d
        src, k3, C3, w_new = _rtbs_routed_map(key, state, r, pending, n=n, bcap=bcap,
                                              local=local)
        with _scope("bank.payload"):
            tbs_ops.tbs_step_apply_banked(
                state.items, payload, src, order=r.order, starts=r.starts,
                touched=r.touched, ntouched=r.ntouched, bcap=bcap)
        new_state = BankState(
            items=state.items,
            nfull=_scatter(state.nfull, r.touched, k3),
            weight=_scatter(state.weight, r.touched, C3),
            total_weight=_scatter(state.total_weight, r.touched, w_new),
            pending=_scatter(pending, r.touched, torch.ones_like(C3)),
            overflow=_scatter_add(state.overflow, r.touched, r.dropped),
            dstate=new_dstate,
        )
        return new_state, r.dropped

    step, step_decayed, step_stats, step_decayed_stats = _make_steps(
        sched_tick, _advance, device, num_keys=K, bcap=bcap, shards=shards)

    def _effective(state: BankState, ids):
        w_eff = state.pending[ids] * state.total_weight[ids]
        return torch.minimum(state.weight[ids], w_eff)

    def extract(key, state: BankState, key_ids) -> SampleView:
        ids, fids, out = _view_ids(key_ids, K, shards, device)
        state = _flat(state, shards)
        k_ds, k_re = prng.split(prng.fold_in(key, fids))
        lat = lt.Latent(items=pytree.tree_map(lambda a: a[ids], state.items),
                        nfull=state.nfull[ids].to(_I64), weight=state.weight[ids])
        # settle the deferred decay in the view: ONE composed Thm 4.1
        # downsample C_stored -> C_eff (the identity when W_eff >= C)
        draws = lt.draw_downsample(k_ds, cap, device, max_deleted=bcap)
        lat = lt.downsample(draws, lat, _effective(state, ids), max_deleted=bcap)
        mask, size = lt.realize(prng.uniform(k_re, ()), lat)
        return SampleView(items=pytree.tree_map(out, lat.items), mask=out(mask),
                          size=out(size))

    def size(key, state: BankState, key_ids) -> torch.Tensor:
        ids, fids, out = _view_ids(key_ids, K, shards, device)
        _, k_re = prng.split(prng.fold_in(key, fids))
        k, take, _ = lt.partial_draw(prng.uniform(k_re, ()),
                                     _effective(_flat(state, shards), ids))
        return out(k + take.to(_I64))

    hyper = {"n": n, "decay": sched, "bcap": bcap}
    if lam is not None:
        hyper["lam"] = lam
    if shards is not None:
        hyper["shards"] = shards
    return SamplerBank(
        scheme="rtbs", num_keys=K, cap=cap, bcap=bcap, init=init, step=step,
        step_decayed=step_decayed, step_stats=step_stats,
        step_decayed_stats=step_decayed_stats, extract=extract, size=size,
        base_rate=lambda state, dt=None: sched_tick(state.dstate, dt)[0],
        hyper=hyper, device=device,
    )


# ---------------------------------------------------------------------------
# T-TBS bank
# ---------------------------------------------------------------------------
def _ttbs_key_map(draws: simple.TTBSDraws, count, bcount, *, cap: int, bcap: int):
    """Each routed row's T-TBS tick (paper Alg. 1) as a slot map over
    (buffer, sub-batch), from the row's draws: keep a uniform m-subset of
    the buffer at its head and append k uniform sub-batch items. Returns
    ``(src [..., cap] int32, new_count, dropped)``; ``dropped`` counts
    inserts past the buffer's capacity."""
    perm = rng.prefix_permutation_fast(draws.rb_perm, cap, count)
    picks = rng.prefix_permutation_fast(draws.rb_pick, bcap, bcount)
    src = simple.compose_map(perm, picks, draws.m, draws.k)
    total = draws.m + draws.k
    return src, torch.clamp(total, max=cap), torch.clamp(total - cap, min=0)


def _ttbs_tick_map(key, state: BankState, keys, bcount, d, *, n: int, batch_size,
                   bcap: int):
    """A T-TBS bank tick up to its payload pass: route the arrivals, then
    :func:`_ttbs_routed_map`. Returns ``(routing,) +`` its result."""
    with _scope("bank.route"):
        r = routing.route(keys, bcount, num_keys=state.nfull.shape[0], bcap=bcap)
    return (r,) + _ttbs_routed_map(key, state, r, d, n=n, batch_size=batch_size, bcap=bcap)


def _ttbs_routed_map(key, state: BankState, r: routing.Routing, d, *, n: int, batch_size,
                     bcap: int, local: int | None = None):
    """A T-TBS bank tick past its routing ``r``, up to its payload pass:
    compose the tick's factor ``d`` (0-d or [K]) into every key's
    ``pending``, set each key's
    acceptance probability ``q = clip(n (1 - d) / batch_size, 0, 1)``
    (``batch_size`` an f32 0-d tensor or a float), then compose each
    touched key's slot map (:func:`_ttbs_key_map`) from its own draws,
    :func:`repro_torch.core.simple.draw_ttbs` of the tick key with
    :func:`_fold_ids` of the key id folded in (both binomials of all b rows
    in one launch, then the keep and pick permutations), the draws a
    standalone ``ttbs_step`` of that key makes. Returns ``(src [b, cap],
    new_count, dropped, w_new, pending, binomial_rows)``: the first four
    per routed row, ``pending`` [K], and the operands of the tick's one
    binomial launch ``(keys [2b, 2], counts [2b], probs [2b])``."""
    K, cap = state.nfull.shape[0], pytree.tree_leaves(state.items)[0].shape[1]
    with _scope("bank.decay"):
        pending = state.pending * d
        bs = torch.as_tensor(batch_size, dtype=_F32, device=pending.device)
        q = torch.clamp(n * (1.0 - d.expand(K)) / bs, 0.0, 1.0)
    with _scope("bank.tick_map"):
        idx = torch.clamp(r.touched, max=K - 1)   # clipped gather; rows drop
        count = state.nfull[idx].to(_I64)
        p_eff = pending[idx]                      # composed retention since last touch
        draws, rows = simple.draw_ttbs_rows(prng.fold_in(key, _fold_ids(r.touched, local)),
                                            count, r.counts, p_eff, q[idx])
        src, new_count, dropped = _ttbs_key_map(draws, count, r.counts, cap=cap,
                                                bcap=bcap)
        w_new = lt.fma_f32(p_eff, state.total_weight[idx], r.counts.to(_F32))
    return src, new_count, dropped, w_new, pending, rows


@register_bank("ttbs")
def _make_ttbs_bank(*, num_keys: int, n: int, lam: float | None = None,
                    decay: DecaySchedule | None = None, batch_size: float,
                    cap: int | None = None, bcap: int = 64,
                    device: torch.device, shards: int | None = None) -> SamplerBank:
    """K independent T-TBS buffers (paper Alg. 1 per key).

    Binomial thinning composes exactly (rate p1 then p2 is one thinning at
    p1 p2), so a key's ``pending`` factor is its retention probability at
    its next touch. The acceptance probability is set per tick from the
    tick's factor, ``q_t = clip(n (1 - d_t) / batch_size, 0, 1)`` per key,
    ``batch_size`` being a key's mean arrivals per touched tick. A key's W
    is ``p_eff W + B`` rounded once to f32, as XLA rounds the jitted JAX
    bank's (:func:`repro_torch.core.latent.fma_f32`). ``shards``: the
    key-sharded form (:func:`shard_bank`)."""
    sched = _resolve_schedule(lam, decay)
    cap = 4 * n if cap is None else cap
    K = num_keys
    init_dstate, sched_tick = _schedule_fns(sched, device, shards)
    bs = torch.full((), float(batch_size), dtype=_F32, device=device)

    def init(item_proto: Any) -> BankState:
        return _init_bank_state(item_proto, K, cap, init_dstate, device, shards)

    def _advance(key, state: BankState, r, payload, d, new_dstate, local):
        src, new_count, dropped_cap, w_new, pending, _ = _ttbs_routed_map(
            key, state, r, d, n=n, batch_size=bs, bcap=bcap, local=local)
        with _scope("bank.payload"):
            tbs_ops.tbs_step_apply_banked(
                state.items, payload, src, order=r.order, starts=r.starts,
                touched=r.touched, ntouched=r.ntouched, bcap=bcap)
        new_state = BankState(
            items=state.items,
            nfull=_scatter(state.nfull, r.touched, new_count),
            weight=_scatter(state.weight, r.touched, new_count.to(_F32)),
            total_weight=_scatter(state.total_weight, r.touched, w_new),
            pending=_scatter(pending, r.touched, torch.ones_like(w_new)),
            overflow=_scatter_add(state.overflow, r.touched, r.dropped + dropped_cap),
            dstate=new_dstate,
        )
        live = torch.arange(dropped_cap.shape[0], device=device) < r.ntouched
        return new_state, r.dropped + torch.where(live, dropped_cap, 0)

    step, step_decayed, step_stats, step_decayed_stats = _make_steps(
        sched_tick, _advance, device, num_keys=K, bcap=bcap, shards=shards)

    def _keep_mask(key, state: BankState, ids, fids):
        # the T-TBS sample is the buffer; the pending retention (a composed
        # Binomial thinning: a Bernoulli at rate ``pending`` per item)
        # settles in the view
        pend = state.pending[ids].unsqueeze(-1)
        keep = prng.uniform(prng.fold_in(key, fids), (cap,)) < pend
        valid = torch.arange(cap, device=device) < state.nfull[ids].unsqueeze(-1)
        return valid & (keep | (pend >= 1.0))

    def extract(key, state: BankState, key_ids) -> SampleView:
        ids, fids, out = _view_ids(key_ids, K, shards, device)
        state = _flat(state, shards)
        mask = out(_keep_mask(key, state, ids, fids))
        return SampleView(items=pytree.tree_map(lambda a: out(a[ids]), state.items),
                          mask=mask, size=mask.sum(-1))

    def size(key, state: BankState, key_ids) -> torch.Tensor:
        ids, fids, out = _view_ids(key_ids, K, shards, device)
        return out(_keep_mask(key, _flat(state, shards), ids, fids).sum(-1))

    hyper = {"n": n, "decay": sched, "batch_size": batch_size, "cap": cap, "bcap": bcap}
    if lam is not None:
        hyper["lam"] = lam
    if shards is not None:
        hyper["shards"] = shards
    return SamplerBank(
        scheme="ttbs", num_keys=K, cap=cap, bcap=bcap, init=init, step=step,
        step_decayed=step_decayed, step_stats=step_stats,
        step_decayed_stats=step_decayed_stats, extract=extract, size=size,
        base_rate=lambda state, dt=None: sched_tick(state.dstate, dt)[0],
        hyper=hyper, device=device,
    )
