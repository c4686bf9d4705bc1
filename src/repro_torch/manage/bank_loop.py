"""Bank-level model-management loop (the JAX package's
``repro.manage.bank_loop``, local mode).

The paper's stream -> sample -> retrain -> eval loop lifted to a
:class:`repro_torch.bank.SamplerBank`: every tick consumes a KEYED batch
(the ``"key"`` column plus payload fields) and advances K per-key
time-biased samples at once. Two retraining regimes:

  * **shared model** (default): one model, retrained every
    ``retrain_every`` ticks on the POOLED extract of ``train_keys``;
  * **per-key farm** (``per_key=True``): one model per train key (params
    with a leading [Q] dimension), each fit on ITS key's sample and
    prequentially evaluated on ITS key's arrivals, through
    ``torch.func.vmap`` over the adapter's ``fit`` / ``evaluate``.

``controller=`` (a :class:`repro_torch.decay.AdaptiveDecay`) closes the
loop between the prequential loss and the decay rate through the bank's
``step_decayed``: in shared mode one controller observes the shared
metric and its rate decays every key; with ``per_key=True`` each train key
has its own controller (state fields [Q]) fed by its own loss, and the
tick's [K] factor is the schedule's base rate everywhere but at the train
keys, which take their controllers' rates. The adjustment is gated on
retrain ticks, as in :mod:`.loop`.

As in :mod:`.loop`, the loop is a Python loop over the tick body that
:func:`make_bank_manage_step` returns, so driving the tick by hand is bit
identical to the loop, and tick t uses :func:`.loop.tick_keys`. ``t`` and
the retrain decision are host ints; nothing else is read on the host.

``telemetry=`` adds JAX's bank row a tick (:func:`_make_bank_stats`:
routing gauges, the probed tenant's Thm 4.1 columns, the laziest key's
pending decay, the controller's gauges), drained as in :mod:`.loop`; the
outputs stay bit-identical.

The key-sharded loop (:func:`make_sharded_bank_loop`, JAX's
``make_sharded_bank_loop``) splits the KEYS over S shards instead of the
batch: shard s owns the contiguous key range [s K_s, (s + 1) K_s) with its
own local bank and model (farm), the stream co-partitioned by key
ownership (:func:`shard_keyed_stream`). A process's banks are one
key-sharded bank (:func:`repro_torch.bank.shard_bank`) whose state carries
a leading shard dimension, all S shards on the stacked mesh or the rank's
one over a process group, so one bank step a tick covers the process's
shards (one B3 launch); the tick routes only the tick's valid rows, at
most the stream's largest tick (read on the host once, before the first
tick). Each shard's models are evaluated and fit on its own rows and keys:
the fits stay with their shard, and the shared metric's sum is the only
traffic between ranks.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.bank import Routing, SamplerBank, shard_bank
from repro_torch.core import distributed, prng
from repro_torch.core.api import SampleView
from repro_torch.manage.loop import (_check_mesh, _check_telemetry, _drive, _shard0,
                                     _stacked, _telemetry_hook, item_proto, tick_keys)
from repro_torch.manage.models import ModelAdapter
from repro_torch.obs import probe as _obs_probe
from repro_torch.obs.profile import scope as _scope

KEY_FIELD = "key"


def _split_keyed(batch: Any):
    """A keyed tick batch is a dict with the ``"key"`` column plus payload
    fields; a single payload field is unwrapped to its bare leaf."""
    keys = batch[KEY_FIELD]
    payload = {k: v for k, v in batch.items() if k != KEY_FIELD}
    if len(payload) == 1:
        payload = next(iter(payload.values()))
    return keys, payload


def keyed_item_proto(batches: Any) -> Any:
    """ONE-item payload prototype from stacked keyed-stream tensors (the
    ``"key"`` column excluded)."""
    return item_proto(_split_keyed(batches)[1])


def pooled_view(view: SampleView) -> SampleView:
    """Flatten a stacked per-key view (leaves [Q, cap, ...]) into one pooled
    view (leaves [Q * cap, ...]): the union of the keys' realized samples."""
    items = pytree.tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                            view.items)
    return SampleView(items=items, mask=view.mask.reshape(-1),
                      size=view.size.sum())


def _train_windows(r: Routing, payload, bcap: int, train_keys):
    """Each train key's slice of the tick routed by ``r``: ``(windows,
    counts)`` with window leaves [Q, bcap, ...] whose first counts[q] rows
    are that key's arrivals (0 when the key did not arrive). Rows past the
    count are ZEROED: the raw windows are slices of the key-sorted batch
    whose tails belong to OTHER tenants, and an adapter that ignores
    ``bcount`` must never see another key's data."""
    b = r.order.shape[0]
    pos = torch.searchsorted(r.touched, train_keys).clamp(0, b - 1)
    found = r.touched[pos] == train_keys
    counts = torch.where(found, r.counts[pos], 0)
    starts = torch.where(found, r.starts[pos], 0)
    j = torch.arange(bcap, dtype=torch.int64, device=train_keys.device)
    idx = (starts.unsqueeze(-1) + j).clamp(0, b - 1)
    valid = j < counts.unsqueeze(-1)

    def one(a):
        w = a[r.order][idx]
        return torch.where(valid.reshape(valid.shape + (1,) * (w.dim() - 2)),
                           w, torch.zeros_like(w))

    return pytree.tree_map(one, payload), counts


def _as_train_keys(train_keys, num_keys: int, device) -> torch.Tensor:
    """The train keys checked on the host, then copied to the device once."""
    tk = np.asarray(list(train_keys), np.int64).reshape(-1)
    if tk.shape[0] < 1:
        raise ValueError("train_keys must be a non-empty key list")
    if tk.min() < 0 or tk.max() >= num_keys:
        raise ValueError(f"train_keys must lie in [0, {num_keys}); got range "
                         f"[{tk.min()}, {tk.max()}]")
    return torch.from_numpy(tk).to(device)


def make_bank_manage_step(bank: SamplerBank, model: ModelAdapter, *,
                          retrain_every: int = 1, train_keys,
                          per_key: bool = False, controller=None,
                          _with_obs: bool = False) -> Callable:
    """One tick of the bank loop: ``(key, t, state, params, batch, bcount)
    -> (state, params, metrics)`` with ``t`` a host int, ``batch`` a keyed
    tick batch (``"key"`` [b] plus payload fields) and ``metrics`` =
    {"metric", "size" [Q], "overflow"}. Consumes ``state`` (the bank's step
    updates its reservoirs in place). The same tick body
    :func:`make_bank_run_loop` runs.

    With a ``controller`` the tick carries its state (fields [Q] when
    ``per_key``): ``(key, t, state, params, cstate, batch, bcount) ->
    (state, params, cstate, metrics)``; ``metrics`` gains the controllers'
    factor ``"decay"`` (0-d shared, the train keys' [Q] per key)."""
    tk = _as_train_keys(train_keys, bank.num_keys, bank.device)
    Q = tk.shape[0]
    v_eval = torch.func.vmap(model.evaluate)
    v_fit = torch.func.vmap(model.fit)

    def decay_of(state, cstate):
        """(the tick's factor for the bank, the controllers' rates)."""
        d = controller.rate(cstate)
        if not per_key:
            return d, d
        base = bank.base_rate(state)
        return base.expand(bank.num_keys).clone().index_copy_(0, tk, d), d

    def body(key, t: int, state, params, cstate, batch, bcount):
        k_step, k_extract, k_fit = tick_keys(key, t)
        keys_t, payload = _split_keyed(batch)
        do_fit = (t + 1) % retrain_every == 0
        # the step leaves params alone, so evaluating after it is still
        # prequential, and the per-key windows reuse the step's routing
        with _scope("manage.sampler_step"):
            if controller is None:
                state, bstats = bank.step_stats(k_step, state, keys_t, payload, bcount)
            else:
                d_bank, d = decay_of(state, cstate)
                state, bstats = bank.step_decayed_stats(k_step, state, keys_t, payload,
                                                        bcount, d_bank)
        with _scope("manage.eval"):
            if per_key:
                windows, counts = _train_windows(bstats["routing"], payload,
                                                 bank.bcap, tk)
                metric = v_eval(params, windows, counts)
            else:
                metric = model.evaluate(params, payload, bcount)
        if controller is not None:
            with _scope("manage.controller"):
                cstate = controller.observe(cstate, metric, do_fit)
        if do_fit:
            with _scope("manage.retrain"):
                view = bank.extract(k_extract, state, tk)
                if per_key:
                    params = v_fit(prng.key_rows(k_fit, Q, bank.device), params, view)
                else:
                    params = model.fit(k_fit, params, pooled_view(view))
        with _scope("manage.size"):
            metrics = {"metric": metric, "size": bank.size(k_extract, state, tk),
                       "overflow": bstats["overflow"]}
        if controller is not None:
            metrics["decay"] = d
        if _with_obs:   # telemetry's routing gauges, kept out of the trace
            metrics["_obs"] = {k: bstats[k] for k in ("ntouched", "invalid", "decay")}
        return state, params, cstate, metrics

    if controller is not None:
        return body

    def tick(key, t: int, state, params, batch, bcount):
        state, params, _, metrics = body(key, t, state, params, None, batch, bcount)
        return state, params, metrics

    return tick


def make_bank_run_loop(bank: SamplerBank, model: ModelAdapter, *,
                       retrain_every: int = 1, train_keys,
                       per_key: bool = False, superbatch: int | None = None,
                       controller=None, telemetry=None) -> Callable:
    """Returns ``run(key, batches, bcounts) -> (state, params, trace)``:

      * ``batches``: a dict with the ``"key"`` column [T, b] plus payload
        fields (leaves [T, b, ...]), as :func:`repro_torch.manage.
        materialize_stream` makes it for a ``KeyedStream`` with
        ``fields=("key", ...)``; ``bcounts`` [T];
      * ``train_keys``: the keys retrained on and traced (``range(Q)`` are
        the popular keys of a Zipf stream);
      * shared mode: ``trace = {"metric" [T], "size" [T, Q], "overflow"
        [T]}``, fit on the pooled extract of ``train_keys``;
      * ``per_key=True``: params gain a leading [Q] dimension and
        ``trace["metric"]`` is [T, Q], each key's prequential loss on its
        own arrivals (NaN on ticks it did not arrive);
      * ``controller``: the decay controller (module docstring); the trace
        gains ``"decay"``, [T] shared or the train keys' [T, Q] per key.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`) adds the bank's
    stats row a tick, its probe on ``telemetry.probe_key`` (default 0); the
    outputs stay bit-identical. Anything else raises ``TypeError``.

    ``superbatch`` is accepted for the JAX package's signature and changes
    nothing (there is no compiled scan body to chunk here)."""
    del superbatch
    _check_telemetry(telemetry)
    train_keys = list(train_keys)
    tick = make_bank_manage_step(bank, model, retrain_every=retrain_every,
                                 train_keys=train_keys, per_key=per_key,
                                 controller=controller, _with_obs=telemetry is not None)
    Q = len(train_keys)
    stats_fn = None
    if telemetry is not None:
        pk = telemetry.probe_key if telemetry.probe_key is not None else 0
        stats_fn = _make_bank_stats(bank, controller, per_key, retrain_every, pk)

    def run(key: prng.Key, batches: Any, bcounts: torch.Tensor):
        params = model.init()
        carry = () if controller is None else (controller.init(bank.device),)
        if per_key:
            params, carry = _stacked(params, Q), _stacked(carry, Q)
        state = bank.init(keyed_item_proto(batches))
        on_tick = finish = None
        if telemetry is not None:
            on_tick, finish = _telemetry_hook(
                telemetry, stats_fn, bank.device,
                {"scheme": f"bank.{bank.scheme}", "ticks": int(bcounts.shape[0]),
                 "state_bytes": _obs_probe.tree_nbytes(state)})
        state, params, *_, trace = _drive(tick, key, state, params, carry, batches, bcounts,
                                          on_tick)
        if finish is not None:
            finish()
        return state, params, trace

    return run


def _make_bank_stats(bank: SamplerBank, controller, per_key: bool,
                     retrain_every: int, probe_key: int) -> Callable:
    """The bank loop's telemetry row (JAX's ``_make_bank_stats``): per-tick
    routing gauges (touched keys, invalid ids, overflow drops), the probed
    tenant's Thm 4.1 self-check columns (:func:`repro_torch.obs.probe.
    make_bank_probe_stats`), the pending-decay magnitude across the bank
    (the smallest composed factor: the deferred decay the laziest key
    carries), and the controller's gauges (the first train key's lane under
    ``per_key``)."""
    probe = _obs_probe.make_bank_probe_stats(bank, probe_key)
    cstats = getattr(controller, "stats", None)

    def stats_fn(t: int, batch, bcount, state, carry, m) -> dict:
        keys_t, _ = _split_keyed(batch)
        obs = m["_obs"]
        row = {"t": t, "bcount": bcount.to(torch.int32),
               "metric": m["metric"].to(torch.float32),
               "size": m["size"].to(torch.int32),
               "overflow": m["overflow"].to(torch.int32),
               "retrain": (t + 1) % retrain_every == 0,
               "ntouched": obs["ntouched"].to(torch.int32),
               "invalid": obs["invalid"].to(torch.int32)}
        d = torch.as_tensor(obs["decay"], dtype=torch.float32, device=bank.device)
        # a [K] per-key factor vector reports the probed tenant's lane
        row["decay"] = d if d.dim() == 0 else d[probe_key]
        row.update(probe(state, keys_t, bcount))
        row["pending_min"] = state.pending.min().to(torch.float32)
        if cstats is not None:
            cs = carry[0]
            if per_key:
                cs = pytree.tree_map(lambda a: a[0], cs)
            row.update(cstats(cs))
        return row

    return stats_fn


# ---------------------------------------------------------------------------
# the key-sharded loop: keys split over S shards, one bank step for all
# ---------------------------------------------------------------------------
def _shard_of(tree: Any, s: int) -> Any:
    return pytree.tree_map(lambda a: a[s], tree)


def _stack_shards(trees: list) -> Any:
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _shards_metric(model: ModelAdapter, axis) -> Callable:
    """The key-sharded loop's shared metric: shard s's model evaluated on
    shard s's rows, the shards' metrics (all-gathered over the shard axis)
    weighted by their shares of the tick's arrivals ``w_s / sum(w)``, NaN
    only when the GLOBAL tick is empty. JAX divides the weighted sum by
    ``sum(w)`` instead (``loop.py:_psum_metric``); taking the shares first
    keeps one shard's metric exact, so at S = 1 the metric is the local
    loop's bit for bit (ROADMAP C.19)."""

    def metric_of(params, batch_s, bcount):
        L = bcount.shape[-1]
        m_s = torch.stack([model.evaluate(_shard_of(params, s), _shard_of(batch_s, s),
                                          bcount[s]) for s in range(L)])
        m_s, w_s = axis.all_gather_many((torch.where(bcount > 0, m_s, 0.0),
                                         bcount.to(torch.float32)))
        den = w_s.sum()
        share = w_s / torch.clamp(den, min=1.0)
        return torch.where(den > 0, (m_s * share).sum(), torch.nan)

    return metric_of


def make_sharded_bank_manage_step(bank: SamplerBank, model: ModelAdapter, mesh, *,
                                  retrain_every: int = 1, train_keys,
                                  per_key: bool = False, rows: int | None = None,
                                  _with_obs: bool = False) -> Callable:
    """ONE tick of the key-sharded loop: ``(key, t, state, params, batch,
    bcount) -> (state, params, metrics)``, the tick :func:`make_sharded_bank_loop`
    runs. ``state`` is the process's rows of the gathered key-sharded bank
    state (leaves [S_local, K_s, ...]), ``params`` [S_local, ...]
    ([S_local, Q, ...] per key), ``batch`` a co-partitioned keyed tick
    (``"key"`` [S_local * b_s], local ids) and ``bcount`` [S_local].
    ``metrics``: ``"metric"`` [S_local] (the global metric on every shard;
    [S_local, Q] per key, shard-local), ``"size"`` [S_local, Q],
    ``"overflow"`` [S_local]. ``rows`` is the routed batch size (default
    S_local * b_s), at least the tick's valid count. Consumes ``state``."""
    ax = mesh.shard_axis
    L = ax.local
    sbank = shard_bank(bank, L)
    tk = _as_train_keys(train_keys, bank.num_keys, bank.device)
    Q = tk.shape[0]
    gk = (torch.arange(L, device=bank.device).unsqueeze(-1) * bank.num_keys + tk).reshape(-1)
    v_eval = torch.func.vmap(model.evaluate)
    v_fit = torch.func.vmap(model.fit)
    shared_metric = _shards_metric(model, ax)

    def tick(key, t: int, state, params, batch, bcount):
        k_step, k_extract, k_fit = tick_keys(key, t)
        keys_t, payload = _split_keyed(batch)
        do_fit = (t + 1) % retrain_every == 0
        with _scope("manage.sampler_step"):
            state, bstats = sbank.step_stats(k_step, state, keys_t, payload, bcount,
                                             rows=rows)
        with _scope("manage.eval"):
            if per_key:
                windows, counts = _train_windows(bstats["routing"], bstats["payload"],
                                                 bank.bcap, gk)
                windows = pytree.tree_map(lambda a: a.reshape((L, Q) + tuple(a.shape[1:])),
                                          windows)
                counts = counts.reshape(L, Q)
                metric = torch.stack([v_eval(_shard_of(params, s), _shard_of(windows, s),
                                             counts[s]) for s in range(L)])
            else:
                metric = shared_metric(params, distributed.split_batch(payload, L),
                                       bcount).expand(L)
        if do_fit:
            with _scope("manage.retrain"):
                view = sbank.extract(k_extract, state, tk)
                if per_key:
                    ks = prng.key_rows(k_fit, Q, bank.device)
                    params = _stack_shards([v_fit(ks, _shard_of(params, s), _shard_of(view, s))
                                            for s in range(L)])
                else:
                    params = _stack_shards([model.fit(k_fit, _shard_of(params, s),
                                                      pooled_view(_shard_of(view, s)))
                                            for s in range(L)])
        with _scope("manage.size"):
            metrics = {"metric": metric, "size": sbank.size(k_extract, state, tk),
                       "overflow": bstats["overflow"]}
        if _with_obs:
            metrics["_obs"] = {k: bstats[k] for k in ("ntouched", "invalid", "decay")}
        return state, params, metrics

    return tick


def make_sharded_bank_loop(bank: SamplerBank, model: ModelAdapter, mesh, *,
                           retrain_every: int = 1, train_keys,
                           per_key: bool = False, superbatch: int | None = None,
                           telemetry=None) -> Callable:
    """The key-sharded bank loop (module docstring): ``run(key, batches,
    bcounts) -> (state, params, trace)``.

      * ``bank`` is the LOCAL bank of one shard (``num_keys`` = K_s = K /
        S), ``mesh`` the port's :func:`repro_torch.launch.mesh.make_data_mesh`
        of S shards (stacked, or one a rank of its group);
      * ``batches`` / ``bcounts``: the co-partitioned keyed stream of
        :func:`shard_keyed_stream` (leaves [T, S_local * b_s, ...], local
        key ids; [T, S_local]; a rank's segment with ``rank=``);
      * ``train_keys``: LOCAL ids, the same subset on every shard; every
        shard uses tick t's same keys (:func:`.loop.tick_keys`), and each
        key draws from them with its local id folded in (ROADMAP C.18);
      * outputs in JAX's gathered form, the process's rows of it: ``state``
        leaves [S_local, K_s, ...], ``params`` [S_local, ...] (per key
        [S_local, Q, ...]), every ``trace`` leaf [S_local, T, ...]: ``"metric"`` (shared: the |B_t|-weighted global
        metric, the same row on every shard; per key: each shard's keys'
        own), ``"size"`` [S, T, Q], ``"overflow"`` [S, T].

    ``bcounts`` is read on the host once, before the first tick, to size
    the routed batch (the largest tick). ``telemetry`` drains shard 0's
    view (its bank, its key range, its rows; rank 0 over a group), as
    :func:`.loop.make_sharded_run_loop` does; the outputs stay
    bit-identical. ``superbatch`` is accepted for JAX's signature and
    changes nothing."""
    del superbatch
    _check_telemetry(telemetry)
    if mesh.rank != 0:
        telemetry = None
    train_keys = list(train_keys)
    stats_fn = None
    if telemetry is not None:
        pk = telemetry.probe_key if telemetry.probe_key is not None else 0
        base = _make_bank_stats(bank, None, per_key, retrain_every, pk)

        def stats_fn(t, batch, bcount, state, carry, m):
            b_s = batch[KEY_FIELD].shape[0] // bcount.shape[-1]
            m0 = {k: m[k][0] for k in ("metric", "size", "overflow")}
            m0["_obs"] = {"ntouched": m["_obs"]["ntouched"][0],
                          "invalid": m["_obs"]["invalid"][0], "decay": m["_obs"]["decay"]}
            return base(t, {f: v[:b_s] for f, v in batch.items()}, bcount[0],
                        _shard0(state), carry, m0)

    def run(key: prng.Key, batches: Any, bcounts: torch.Tensor):
        L = _check_mesh(mesh, bcounts)
        rows = max(int(bcounts.sum(-1).max()), 1)   # the one host read
        tick = make_sharded_bank_manage_step(
            bank, model, mesh, retrain_every=retrain_every, train_keys=train_keys,
            per_key=per_key, rows=rows, _with_obs=telemetry is not None)
        params = _stacked(model.init(), len(train_keys)) if per_key else model.init()
        params = _stacked(params, L)
        state = shard_bank(bank, L).init(keyed_item_proto(batches))
        on_tick = finish = None
        if telemetry is not None:
            on_tick, finish = _telemetry_hook(
                telemetry, stats_fn, bank.device,
                {"scheme": f"bank.{bank.scheme}", "ticks": int(bcounts.shape[0]),
                 "state_bytes": _obs_probe.tree_nbytes(_shard0(state))})
        state, params, trace = _drive(tick, key, state, params, (), batches, bcounts,
                                      on_tick)
        if finish is not None:
            finish()
        return state, params, {k: v.movedim(0, 1) for k, v in trace.items()}

    return run


def shard_keyed_stream(batches: Any, bcounts, num_shards: int, num_keys: int, *,
                       bcap_s: int | None = None, device=None, rank: int | None = None):
    """Re-pack a materialized KEYED stream into the key-ownership layout
    :func:`make_sharded_bank_loop` consumes (the JAX package's
    ``shard_keyed_stream``).

    Keys are split into ``num_shards`` contiguous ranges of ``num_keys //
    num_shards`` (which must divide; an id past the last range belongs to
    the last shard, a negative one to the first); tick t's valid items
    move into their owning shard's segment in arrival order, key ids
    LOCALIZED to the shard's range. Returns ``(batches, bcounts)`` on
    ``device`` (None: the CUDA card): leaves [T, S * bcap_s, ...]
    zero-padded per segment and [T, S] int64; ``bcap_s`` defaults to the
    largest per-shard count. With ``rank``, only that shard's segment:
    leaves [T, bcap_s, ...] and [T, 1]."""
    if num_keys % num_shards:
        raise ValueError(f"num_keys={num_keys} must divide evenly over "
                         f"num_shards={num_shards} contiguous key ranges")
    dev = _device.resolve(device)
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    ks = num_keys // num_shards
    keys = host(batches[KEY_FIELD])
    bcounts = host(bcounts)
    T, S = bcounts.shape[0], num_shards
    counts = np.zeros((T, S), np.int64)
    sel = []
    for t in range(T):
        owner = np.clip(keys[t, :int(bcounts[t])] // ks, 0, S - 1)
        order = np.argsort(owner, kind="stable")      # arrival order within a shard
        counts[t] = np.bincount(owner, minlength=S)
        sel.append(order)
    need = int(counts.max()) if T else 0
    bcap_s = max(need, 1) if bcap_s is None else bcap_s
    if need > bcap_s:
        raise ValueError(f"per-shard keyed batch {need} exceeds bcap_s={bcap_s}")
    if rank is not None and not 0 <= rank < S:
        raise ValueError(f"rank {rank} is not a shard of {S}")
    keep = range(S) if rank is None else [rank]

    def repack(leaf, localize=False):
        leaf = host(leaf)
        out = np.zeros((T, len(keep) * bcap_s) + leaf.shape[2:], leaf.dtype)
        for t in range(T):
            starts = np.concatenate([[0], np.cumsum(counts[t])])
            for i, s in enumerate(keep):
                c = int(counts[t, s])
                seg = leaf[t, sel[t][starts[s]:starts[s] + c]]
                if localize:
                    seg = seg - leaf.dtype.type(s * ks)
                out[t, i * bcap_s:i * bcap_s + c] = seg
        return torch.from_numpy(out).to(dev)

    out = {f: repack(v, localize=(f == KEY_FIELD)) for f, v in batches.items()}
    return out, torch.from_numpy(np.ascontiguousarray(counts[:, list(keep)])).to(dev)
