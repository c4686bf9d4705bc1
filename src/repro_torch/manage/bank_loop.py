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
outputs stay bit-identical. Not ported yet: the key-sharded loop and
``shard_keyed_stream`` (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.bank import Routing, SamplerBank
from repro_torch.core import prng
from repro_torch.core.api import SampleView
from repro_torch.manage.loop import (_check_telemetry, _drive, _stacked, _telemetry_hook,
                                     item_proto, tick_keys)
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
