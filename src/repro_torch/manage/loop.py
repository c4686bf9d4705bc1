"""The paper's online model-management loop (local, one device):

    for each tick t:
      1. metric_t = model.evaluate(params, B_t)      # prequential: eval BEFORE
      2. state    = sampler.step(key_t, state, B_t)  # the model/sampler see B_t
      3. if (t+1) % retrain_every == 0:
           params = model.fit(key_t', params, sampler.extract(key_t'', state))

The JAX package scans this in one compiled ``lax.scan``; here it is a Python
loop over ticks that runs the SAME tick body as :func:`make_manage_step`, so
driving the tick by hand is bit-identical to the loop. ``t`` and the retrain
decision are host ints, so a tick never syncs to the host: every metric and
size stays a device tensor until the trace is stacked at the end.

Key discipline: tick t uses ``split(fold_in(key, t), 3)`` as its (step,
extract, fit) keys (:func:`tick_keys`); ``size`` and ``extract`` consume the
same extract key, so the logged size is the size of the sample a retrain
would see.

Closed-loop adaptive decay: ``controller=`` (a
:class:`repro_torch.decay.AdaptiveDecay`) drives ``sampler.step_decayed``
with the controller's rate each tick and feeds the prequential metric back;
the rate's adjustment is gated on retrain ticks, and the trace gains the
applied factor under ``"decay"``.

Monte-Carlo farms (:func:`make_run_farm`): trials share one stream, each
with its own key from ``split(key, trials)``, and run as a leading
dimension of the sampler's state; the trace gains a leading [trials] axis.

Telemetry (``telemetry=``, a :class:`repro_torch.obs.Telemetry`): each
tick adds one stats row (:func:`_make_loop_stats`, JAX's columns) computed
on the device under the ``obs.stats`` scope; rows drain in ``every``-tick
blocks without a host sync in the tick (:mod:`repro_torch.obs.telemetry`),
after one ``kind="run"`` header a run. ``(state, params, trace)`` is
bit-identical to ``telemetry=None``.

Not ported yet: the sharded loops (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.core.api import Sampler
from repro_torch.manage.models import ModelAdapter
from repro_torch.obs import probe as _obs_probe
from repro_torch.obs.profile import scope as _scope
from repro_torch.obs.telemetry import Telemetry


def tick_keys(key: prng.Key, t: int) -> tuple[prng.Key, prng.Key, prng.Key]:
    """The loop's per-tick (step, extract, fit) keys."""
    return prng.split(prng.fold_in(key, t), 3)


def item_proto(batches: Any) -> Any:
    """ONE-item prototype (tensors on the batches' device) from stacked
    stream tensors (leaves [T, bcap, ...])."""
    return pytree.tree_map(lambda a: torch.zeros(a.shape[2:], dtype=a.dtype,
                                                 device=a.device), batches)


def _check_controllable(sampler: Sampler) -> None:
    if sampler.step_decayed is None:
        raise ValueError(
            f"sampler {sampler.scheme!r} has no decay to control (no "
            "step_decayed closure): the adaptive controller drives the "
            "time-biased schemes (rtbs/ttbs/btbs), not the decay-free baselines")


def make_manage_step(sampler: Sampler, model: ModelAdapter, *,
                     retrain_every: int = 1, controller=None) -> Callable:
    """One tick of the loop: ``(key, t, state, params, batch, bcount) ->
    (state, params, metrics)`` with ``t`` a host int. The same tick body
    :func:`make_run_loop` runs, so driving it tick by tick is bit-identical
    to the loop.

    With a ``controller`` the tick carries its state too: ``(key, t, state,
    params, cstate, batch, bcount) -> (state, params, cstate, metrics)``,
    and ``metrics`` gains the applied factor ``"decay"``."""
    if controller is not None:
        _check_controllable(sampler)

    def body(key, t: int, state, params, cstate, batch_items, bcount):
        k_step, k_extract, k_fit = tick_keys(key, t)
        do_fit = (t + 1) % retrain_every == 0
        with _scope("manage.eval"):
            metric = model.evaluate(params, batch_items, bcount)
        with _scope("manage.sampler_step"):
            if controller is None:
                state = sampler.step(k_step, state, batch_items, bcount)
            else:
                d = controller.rate(cstate)
                state = sampler.step_decayed(k_step, state, batch_items, bcount, d)
        if controller is not None:
            with _scope("manage.controller"):
                cstate = controller.observe(cstate, metric, do_fit)
        if do_fit:
            with _scope("manage.retrain"):
                params = model.fit(k_fit, params, sampler.extract(k_extract, state))
        with _scope("manage.size"):
            metrics = {"metric": metric, "size": sampler.size(k_extract, state)}
        if controller is not None:
            metrics["decay"] = d
        return state, params, cstate, metrics

    if controller is not None:
        return body

    def tick(key, t: int, state, params, batch_items, bcount):
        state, params, _, metrics = body(key, t, state, params, None, batch_items, bcount)
        return state, params, metrics

    return tick


def _stacked(tree: Any, n: int) -> Any:
    """``n`` copies of a pytree's tensors along a new leading dimension."""
    return pytree.tree_map(
        lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).clone(), tree)


def _drive(tick: Callable, key, state, params, carry: tuple, batches: Any,
          bcounts: torch.Tensor, on_tick: Callable | None = None):
    """Run ``tick`` over every tick of a stream (leaves [T, ...]); returns
    ``(state, params, trace)``, the trace's columns stacked over ticks.
    ``carry`` is ``()`` or ``(cstate,)``, as the tick takes it.
    ``on_tick(t, batch_t, bcount_t, state, carry, m)``, when given, sees each
    tick's outputs (telemetry); a reserved ``"_obs"`` entry of ``m`` goes to
    it and never to the trace."""
    ms = []
    for t in range(bcounts.shape[0]):
        batch_t = pytree.tree_map(lambda a: a[t], batches)
        state, params, *carry, m = tick(key, t, state, params, *carry, batch_t, bcounts[t])
        if on_tick is not None:
            on_tick(t, batch_t, bcounts[t], state, carry, m)
            m = {k: v for k, v in m.items() if k != "_obs"}
        ms.append(m)
    return state, params, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _check_telemetry(telemetry) -> None:
    if telemetry is not None and not isinstance(telemetry, Telemetry):
        raise TypeError(f"telemetry= takes a repro_torch.obs.Telemetry (see "
                        f"repro_torch.obs.make_telemetry); got {type(telemetry).__name__}")


def _make_loop_stats(sampler: Sampler, controller, retrain_every: int) -> Callable:
    """The single-sampler loop's telemetry row (JAX's ``_make_loop_stats``):
    per-tick sample size, the stored mass C / decayed weight W gauges
    (:func:`repro_torch.obs.probe.make_state_stats`), the retrain flag, the
    applied decay factor (the controller's trace entry, else the schedule's
    static rate) and the controller's lambda / hold / pulse gauges when one
    is in the carry. ``t``, the retrain flag and a static decay are host
    values; everything else stays on the device."""
    state_stats = _obs_probe.make_state_stats(sampler)
    d0 = _obs_probe.static_decay(sampler)
    cstats = getattr(controller, "stats", None)

    def stats_fn(t: int, batch, bcount, state, carry, m) -> dict:
        del batch
        row = {"t": t, "bcount": bcount.to(torch.int32),
               "metric": m["metric"].to(torch.float32),
               "size": m["size"].to(torch.int32),
               "retrain": (t + 1) % retrain_every == 0}
        row.update(state_stats(state))
        if "decay" in m:
            row["decay"] = m["decay"].to(torch.float32)
        elif d0 is not None:
            row["decay"] = d0
        if cstats is not None:
            row.update(cstats(carry[0]))
        return row

    return stats_fn


def _telemetry_hook(telemetry, stats_fn: Callable, device, meta: dict):
    """(on_tick, finish) for one instrumented run: opens the run's header
    (JAX's ``_wrap_run_header``: ``jax`` is None here, ``torch`` the
    version) and pushes each tick's row into a drain."""
    telemetry.open_run({**meta, "superbatch": 1, "every": telemetry.every,
                        "backend": torch.device(device).type, "jax": None,
                        "torch": torch.__version__})
    drain = telemetry.drain(device)

    def on_tick(t, batch_t, bcount, state, carry, m):
        with _scope("obs.stats"):
            drain.push(stats_fn(t, batch_t, bcount, state, carry, m))

    return on_tick, drain.finish


def make_run_loop(sampler: Sampler, model: ModelAdapter, *,
                  retrain_every: int = 1, superbatch: int | None = None,
                  controller=None, telemetry=None) -> Callable:
    """Returns ``run(key, batches, bcounts) -> (state, params, trace)``:
    ``batches`` leaves [T, bcap, ...] and ``bcounts`` [T] on the device,
    ``trace`` = {"metric": f32 [T], "size": int64 [T]}.

    ``controller`` (a :class:`repro_torch.decay.AdaptiveDecay`) closes the
    loop between the prequential metric and the sampler's decay rate (see
    the module docstring); the trace gains ``"decay"`` f32 [T]. The sampler
    must be decay-capable (rtbs/ttbs/btbs).

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`) adds one stats
    row a tick and drains them in ``telemetry.every``-tick blocks (module
    docstring); the outputs stay bit-identical. Anything else raises
    ``TypeError``.

    ``superbatch`` is accepted for the JAX package's signature and changes
    nothing (there is no compiled scan body to chunk here)."""
    del superbatch
    _check_telemetry(telemetry)
    tick = make_manage_step(sampler, model, retrain_every=retrain_every,
                            controller=controller)
    stats_fn = (None if telemetry is None
                else _make_loop_stats(sampler, controller, retrain_every))

    def run(key: prng.Key, batches: Any, bcounts: torch.Tensor):
        carry = () if controller is None else (controller.init(sampler.device),)
        state = sampler.init(item_proto(batches))
        on_tick = finish = None
        if telemetry is not None:
            on_tick, finish = _telemetry_hook(
                telemetry, stats_fn, sampler.device,
                {"scheme": sampler.scheme, "ticks": int(bcounts.shape[0]),
                 "state_bytes": _obs_probe.tree_nbytes(state)})
        out = _drive(tick, key, state, model.init(), carry, batches, bcounts, on_tick)
        if finish is not None:
            finish()
        return out

    return run


def run_loop(key: prng.Key, sampler: Sampler, model: ModelAdapter,
             batches: Any, bcounts: torch.Tensor, *, retrain_every: int = 1,
             superbatch: int | None = None, controller=None):
    """One-shot convenience wrapper over :func:`make_run_loop`."""
    return make_run_loop(sampler, model, retrain_every=retrain_every,
                         superbatch=superbatch,
                         controller=controller)(key, batches, bcounts)


def _per_trial(model: ModelAdapter, trials: int) -> ModelAdapter:
    """``model`` over a list of ``trials`` params: ``evaluate`` stacks the
    trials' metrics, ``fit`` refits trial i on row i of the view with row i
    of the fit keys (a key tensor row gives the draws its host key does)."""

    def fit(key, params, view):
        return [model.fit(key[i], p, pytree.tree_map(lambda a: a[i], view))
                for i, p in enumerate(params)]

    def evaluate(params, batch, bcount):
        return torch.stack([model.evaluate(p, batch, bcount) for p in params])

    return ModelAdapter(name=model.name, init=lambda: [model.init() for _ in range(trials)],
                        fit=fit, evaluate=evaluate, hyper=model.hyper, device=model.device)


def make_run_farm(sampler: Sampler, model: ModelAdapter, *,
                  retrain_every: int = 1, superbatch: int | None = None,
                  controller=None) -> Callable:
    """Monte-Carlo farm: ``farm(key, trials, batches, bcounts) -> trace``,
    trace leaves with a leading [trials] axis, bit-equal to stacking
    :func:`make_run_loop`'s ``run(k_i, batches, bcounts)`` over
    ``k_i = split(key, trials)[i]``: the trials share the stream, each with
    its own sampler, model and controller randomness.

    :func:`make_manage_step`'s tick runs once for all trials: they are a
    leading dimension of the sampler's state, of the controller's state and
    of the tick keys (a key tensor whose row i is trial i's key), so a tick
    steps every trial in one pass (one B1 launch). The model adapters take
    no trial dimension yet, so ``evaluate`` and ``fit`` run once a trial."""
    del superbatch
    if controller is not None:
        _check_controllable(sampler)

    def farm(key: prng.Key, trials: int, batches: Any, bcounts: torch.Tensor):
        tick = make_manage_step(sampler, _per_trial(model, trials),
                                retrain_every=retrain_every, controller=controller)
        dev = sampler.device
        carry = () if controller is None else (_stacked(controller.init(dev), trials),)
        _, _, trace = _drive(tick, prng.key_rows(key, trials, dev),
                            _stacked(sampler.init(item_proto(batches)), trials),
                            [model.init() for _ in range(trials)], carry, batches, bcounts)
        return {k: v.movedim(0, 1) for k, v in trace.items()}

    return farm


def run_farm(key: prng.Key, trials: int, sampler: Sampler, model: ModelAdapter,
             batches: Any, bcounts: torch.Tensor, *, retrain_every: int = 1,
             superbatch: int | None = None, controller=None):
    """One-shot convenience wrapper over :func:`make_run_farm`."""
    return make_run_farm(sampler, model, retrain_every=retrain_every,
                         superbatch=superbatch,
                         controller=controller)(key, trials, batches, bcounts)


def materialize_stream(stream: Any, T: int, *, batch_size: int | Callable,
                       mode: int | Callable = 0, bcap: int | None = None,
                       fields: tuple[str, ...] = ("x", "y"), device=None):
    """Stack ``stream.batch(t, size, mode)`` for t in [0, T) into device
    tensors: ``(batches, bcounts)`` with leaves [T, bcap, ...] (zero-padded
    up to ``bcap``, default the largest tick) and [T] int64.
    ``device=None`` means the CUDA card (raises without one)."""
    dev = _device.resolve(device)
    size_of = batch_size if callable(batch_size) else (lambda t: batch_size)
    mode_of = mode if callable(mode) else (lambda t: mode)
    sizes = [int(size_of(t)) for t in range(T)]
    bcap = max(sizes) if bcap is None else bcap
    if max(sizes) > bcap:
        raise ValueError(f"batch size {max(sizes)} exceeds bcap={bcap}")

    raw = [stream.batch(t, sizes[t], mode_of(t)) for t in range(T)]
    as_dict = isinstance(raw[0], tuple)
    if as_dict:
        raw = [dict(zip(fields, r)) for r in raw]

    def pad_stack(leaves):
        out = np.zeros((T, bcap) + leaves[0].shape[1:], leaves[0].dtype)
        for t, leaf in enumerate(leaves):
            out[t, : leaf.shape[0]] = leaf
        return torch.from_numpy(out).to(dev)

    if as_dict:
        batches = {f: pad_stack([r[f] for r in raw]) for f in raw[0]}
    else:
        batches = pad_stack(raw)
    return batches, torch.tensor(sizes, dtype=torch.int64).to(dev)
