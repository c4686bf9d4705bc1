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

The sharded loops (paper Sec. 5; :func:`make_sharded_run_loop`,
:func:`make_sharded_manage_step`, :func:`make_sharded_run_farm`,
:func:`make_sharded_resume_loop`) run the same tick over a distributed
sampler (drtbs, dttbs) along the mesh's shard axis
(:mod:`repro_torch.core.distributed`): the S reservoir shards a leading
dimension of one process's state, or one a rank of the mesh's process
group. Tick t's arrivals are co-partitioned: batch leaves ``[S_local *
bcap_s, ...]`` with the process's shard l owning rows ``[l * bcap_s, (l +
1) * bcap_s)`` and ``bcount`` ``[S_local]`` (:func:`shard_stream` builds
the layout, a rank's segment with ``rank=``). The metric is the
|B_t|-weighted sum of the shards' metrics, NaN only when the global tick
is empty; retraining fits the global sample (``extract_global``, the same
on every rank) and the logged size is ``size_global``. The state they take
and return is the process's rows of the gathered snapshot (every leaf
``[S_local, ...]``), so fused, per-tick and resumed runs compose bit for
bit, and a rank's equals row ``rank`` of the stacked run's.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.core import distributed, prng
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


def _tick_body(sampler: Sampler, retrain_every: int, controller, *, evaluate: Callable,
               fit: Callable, extract: Callable, size: Callable) -> Callable:
    """The tick ``(key, t, state, params, cstate, batch, bcount) -> (state,
    params, cstate, metrics)`` every loop runs; the sharded loops pass
    their summed metric and global extract / size closures."""

    def body(key, t: int, state, params, cstate, batch_items, bcount):
        k_step, k_extract, k_fit = tick_keys(key, t)
        do_fit = (t + 1) % retrain_every == 0
        with _scope("manage.eval"):
            metric = evaluate(params, batch_items, bcount)
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
                params = fit(k_fit, params, extract(k_extract, state))
        with _scope("manage.size"):
            metrics = {"metric": metric, "size": size(k_extract, state)}
        if controller is not None:
            metrics["decay"] = d
        return state, params, cstate, metrics

    return body


def _carry_form(body: Callable, controller) -> Callable:
    """The tick's public signature: the body itself with a controller,
    else without the controller state."""
    if controller is not None:
        return body

    def tick(key, t: int, state, params, batch_items, bcount):
        state, params, _, metrics = body(key, t, state, params, None, batch_items, bcount)
        return state, params, metrics

    return tick


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
    return _carry_form(_tick_body(sampler, retrain_every, controller, evaluate=model.evaluate,
                                  fit=model.fit, extract=sampler.extract, size=sampler.size),
                       controller)


def _stacked(tree: Any, n: int) -> Any:
    """``n`` copies of a pytree's tensors along a new leading dimension."""
    return pytree.tree_map(
        lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).clone(), tree)


def _drive(tick: Callable, key, state, params, carry: tuple, batches: Any,
          bcounts: torch.Tensor, on_tick: Callable | None = None, t0: int = 0):
    """Run ``tick`` over every tick of a stream (leaves [T, ...]), the
    first of them global tick ``t0``; returns ``(state, params, *carry,
    trace)``, the trace's columns stacked over ticks. ``carry`` is ``()``
    or ``(cstate,)``, as the tick takes it.
    ``on_tick(t, batch_t, bcount_t, state, carry, m)``, when given, sees each
    tick's outputs (telemetry); a reserved ``"_obs"`` entry of ``m`` goes to
    it and never to the trace."""
    ms = []
    for i in range(bcounts.shape[0]):
        batch_t = pytree.tree_map(lambda a: a[i], batches)
        state, params, *carry, m = tick(key, t0 + i, state, params, *carry, batch_t,
                                        bcounts[i])
        if on_tick is not None:
            on_tick(t0 + i, batch_t, bcounts[i], state, carry, m)
            m = {k: v for k, v in m.items() if k != "_obs"}
        ms.append(m)
    return (state, params, *carry, {k: torch.stack([m[k] for m in ms]) for k in ms[0]})


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
        state, params, *_, trace = _drive(tick, key, state, model.init(), carry, batches,
                                          bcounts, on_tick)
        if finish is not None:
            finish()
        return state, params, trace

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
        *_, trace = _drive(tick, prng.key_rows(key, trials, dev),
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


# ---------------------------------------------------------------------------
# the sharded loops (paper Sec. 5): the same tick over a distributed sampler
# ---------------------------------------------------------------------------
def _check_sharded(sampler: Sampler) -> None:
    if not sampler.distributed or sampler.extract_global is None:
        raise ValueError(
            f"sampler {sampler.scheme!r} is a local scheme: the sharded manage loop needs "
            "per-shard step/extract_global closures (drtbs/dttbs) -- use make_run_loop "
            "for local schemes")


def _check_mesh(mesh, bcounts: torch.Tensor) -> int:
    """The process's shard count, checked against the stream's."""
    L = mesh.local_shards
    if bcounts.shape[-1] != L:
        raise ValueError(f"the mesh holds {L} of its {mesh.num_shards} shards here; the "
                         f"stream's bcounts have {bcounts.shape[-1]} (shard_stream(..., "
                         f"num_shards={mesh.num_shards}), with rank= over a group)")
    return L


def _effective_superbatch(superbatch: int | None, retrain_every: int) -> int:
    """JAX's superbatch chunk G: the largest divisor of ``retrain_every``
    not above the requested size (None: 1, JAX's default off the TPU). The
    port runs no chunked scan, so G only sets where a resume may start."""
    g = min(max(int(1 if superbatch is None else superbatch), 1), retrain_every)
    while retrain_every % g:
        g -= 1
    return g


def _psum_metric(model: ModelAdapter, axis) -> Callable:
    """The sharded loops' prequential metric: the |B_t|-weighted sum of the
    shards' metrics over the shard axis, NaN only when the GLOBAL tick is
    empty. ``model.evaluate`` runs once a local shard on its rows; the
    weighted terms are all-gathered and summed in shard order."""

    def metric_of(params, batch_s, bcount):
        L = bcount.shape[-1]
        m_s = torch.stack([model.evaluate(params, pytree.tree_map(lambda a: a[s], batch_s),
                                          bcount[s]) for s in range(L)], dim=-1)
        w_s = bcount.to(torch.float32)
        terms = torch.where(bcount > 0, m_s, 0.0) * w_s
        terms, w_all = axis.all_gather_many((terms, w_s.expand(terms.shape)))
        num = terms.sum(-1)
        den = w_all.sum(-1)
        return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.nan)

    return metric_of


def make_sharded_manage_step(sampler: Sampler, model: ModelAdapter, mesh, *,
                             retrain_every: int = 1, controller=None) -> Callable:
    """ONE tick of the sharded loop: ``(key, t, state, params, batch_t,
    bcount_t) -> (state, params, metrics)``, with a controller ``(key, t,
    state, params, cstate, batch_t, bcount_t) -> (state, params, cstate,
    metrics)``. ``state`` is the process's rows of the gathered snapshot
    (every leaf ``[S_local, ...]``) the fused loop returns, ``batch_t``
    leaves ``[S_local * bcap_s, ...]``, ``bcount_t`` ``[S_local]``. The
    tick runs over the mesh's shard axis (``sampler.over(mesh.shard_axis)``);
    the fused loop runs this tick, so per-tick and fused runs are
    bit-identical."""
    _check_sharded(sampler)
    if controller is not None:
        _check_controllable(sampler)
    ax = mesh.shard_axis
    sampler = sampler.over(ax)
    body = _tick_body(sampler, retrain_every, controller, evaluate=_psum_metric(model, ax),
                      fit=model.fit, extract=sampler.extract_global, size=sampler.size_global)

    def sharded(key, t: int, state, params, cstate, batch_items, bcount):
        return body(key, t, state, params, cstate,
                    distributed.split_batch(batch_items, ax.local), bcount)

    return _carry_form(sharded, controller)


def init_sharded_state(sampler: Sampler, shards, proto: Any) -> Any:
    """The t = 0 state in the gathered form the sharded loops take:
    ``sampler.init(proto)`` stacked on a leading shard dimension of
    ``shards`` rows (a count, or a mesh: the shards this process holds)."""
    return _stacked(sampler.init(proto), getattr(shards, "local_shards", shards))


def _shard0(state: Any) -> Any:
    """The process's first shard's view of a state (shard 0's on the
    stacked axis and on rank 0: the stream JAX's sharded telemetry
    keeps)."""
    return pytree.tree_map(lambda a: a[0], state)


def make_sharded_run_loop(sampler: Sampler, model: ModelAdapter, mesh, *,
                          retrain_every: int = 1, superbatch: int | None = None,
                          controller=None, telemetry=None) -> Callable:
    """The paper's loop over a sharded sampler: ``run(key, batches,
    bcounts) -> (state, params, trace)``.

      * ``batches``: leaves ``[T, S_local * bcap_s, ...]``, tick t's
        arrivals co-partitioned (:func:`shard_stream`); ``bcounts`` ``[T,
        S_local]`` (empty shards are fine: the schemes sum the global
        |B_t|); ``S_local`` is S on the stacked mesh, 1 on a rank's;
      * ``state``: the process's rows of the final gathered snapshot (every
        leaf ``[S_local, ...]``);
      * ``params`` / ``trace``: as :func:`make_run_loop`'s.

    ``controller`` threads the closed-loop decay controller, fed the
    summed global metric; ``telemetry`` adds one stats row a tick, shard
    0's gauges (JAX keeps shard 0's stream; over a group only rank 0
    writes), the outputs bit-identical. ``superbatch`` changes nothing (no
    compiled scan to chunk)."""
    del superbatch
    _check_sharded(sampler)
    _check_telemetry(telemetry)
    if mesh.rank != 0:
        telemetry = None
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=retrain_every,
                                    controller=controller)
    stats_fn = None
    if telemetry is not None:
        base = _make_loop_stats(sampler, controller, retrain_every)

        def stats_fn(t, batch, bcount, state, carry, m):
            return base(t, batch, bcount[0], _shard0(state), carry, m)

    def run(key: prng.Key, batches: Any, bcounts: torch.Tensor):
        L = _check_mesh(mesh, bcounts)
        carry = () if controller is None else (controller.init(sampler.device),)
        state = init_sharded_state(sampler, L, item_proto(batches))
        on_tick = finish = None
        if telemetry is not None:
            on_tick, finish = _telemetry_hook(
                telemetry, stats_fn, sampler.device,
                {"scheme": sampler.scheme, "ticks": int(bcounts.shape[0]),
                 "state_bytes": _obs_probe.tree_nbytes(state)})
        state, params, *_, trace = _drive(tick, key, state, model.init(), carry, batches,
                                          bcounts, on_tick)
        if finish is not None:
            finish()
        return state, params, trace

    return run


def make_sharded_run_farm(sampler: Sampler, model: ModelAdapter, mesh, *,
                          retrain_every: int = 1, superbatch: int | None = None,
                          controller=None) -> Callable:
    """Monte-Carlo farm of the sharded loop: ``farm(key, trials, batches,
    bcounts) -> (states, params, trace)``, a leading [trials] dimension on
    every output. Trials x shards are the two leading dimensions of one
    state, so a tick steps every trial's every shard at once (one B1
    launch); trial i runs with ``split(key, trials)[i]`` and the trials
    share the stream. The model adapters take no trial dimension, so
    ``evaluate`` and ``fit`` run once a trial (and a shard)."""
    del superbatch
    _check_sharded(sampler)
    if controller is not None:
        _check_controllable(sampler)

    def farm(key: prng.Key, trials: int, batches: Any, bcounts: torch.Tensor):
        L = _check_mesh(mesh, bcounts)
        tick = make_sharded_manage_step(sampler, _per_trial(model, trials), mesh,
                                        retrain_every=retrain_every, controller=controller)
        dev = sampler.device
        carry = () if controller is None else (_stacked(controller.init(dev), trials),)
        state0 = _stacked(init_sharded_state(sampler, L, item_proto(batches)), trials)
        states, params, *_, trace = _drive(
            tick, prng.key_rows(key, trials, dev), state0,
            [model.init() for _ in range(trials)], carry, batches, bcounts)
        params = pytree.tree_map(lambda *xs: torch.stack(xs), *params)
        return states, params, {k: v.movedim(0, 1) for k, v in trace.items()}

    return farm


def make_sharded_resume_loop(sampler: Sampler, model: ModelAdapter, mesh, *,
                             retrain_every: int = 1, superbatch: int | None = None,
                             controller=None) -> Callable:
    """Continue a sharded run from its gathered snapshot: ``run(key,
    snapshot, params, batches, bcounts, t0) -> (snapshot, params, trace)``
    (with ``controller``: ``run(key, snapshot, params, cstate, batches,
    bcounts, t0) -> (snapshot, params, cstate, trace)``). ``batches`` /
    ``bcounts`` are the segment to consume and ``t0`` the global tick of
    its first batch, so running ``[0, T)`` at once and ``[0, T1) + [T1,
    T)`` through this entry point are bit-identical. ``t0`` must be a
    multiple of JAX's superbatch chunk G (:func:`_effective_superbatch`),
    as JAX requires."""
    _check_sharded(sampler)
    if controller is not None:
        _check_controllable(sampler)
    G = _effective_superbatch(superbatch, retrain_every)
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=retrain_every,
                                    controller=controller)

    def run(key: prng.Key, snapshot, params, *rest):
        *carry, batches, bcounts, t0 = rest
        if int(t0) % G:
            raise ValueError(f"resume tick t0={int(t0)} must be a multiple of the superbatch "
                             f"chunk G={G}, or chunk boundaries would drift off the retrain "
                             "cadence")
        _check_mesh(mesh, bcounts)
        return _drive(tick, key, snapshot, params, tuple(carry), batches, bcounts,
                      t0=int(t0))

    return run


def shard_stream(batches: Any, bcounts, num_shards: int, *, bcap_s: int | None = None,
                 device=None, rank: int | None = None):
    """Re-pack a :func:`materialize_stream` output into the co-partitioned
    layout the sharded loops consume (the JAX package's ``shard_stream``).

    Tick t's ``bcounts[t]`` valid items are split contiguously and evenly
    over ``num_shards`` (shard s of tick t gets ``floor(b/S) + (s < b mod
    S)``; uneven and empty shards are fine). Returns ``(batches,
    bcounts)`` on ``device`` (None: the CUDA card), leaves ``[T, S *
    bcap_s, ...]`` zero-padded per shard segment and ``[T, S]`` int64;
    ``bcap_s`` defaults to the largest per-shard count. With ``rank``, only
    that shard's segment: leaves ``[T, bcap_s, ...]`` and ``[T, 1]``, the
    same ``bcap_s`` on every rank (a rank's run needs every shard's)."""
    dev = _device.resolve(device)
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    bcounts = host(bcounts)
    T = bcounts.shape[0]
    S = num_shards
    counts = np.zeros((T, S), np.int64)
    for t in range(T):
        b = int(bcounts[t])
        counts[t] = b // S + (np.arange(S) < b % S)
    need = int(counts.max()) if T else 0
    bcap_s = max(need, 1) if bcap_s is None else bcap_s
    if need > bcap_s:
        raise ValueError(f"per-shard batch {need} exceeds bcap_s={bcap_s}")
    if rank is not None and not 0 <= rank < S:
        raise ValueError(f"rank {rank} is not a shard of {S}")
    keep = range(S) if rank is None else [rank]

    def repack(leaf):
        leaf = host(leaf)
        out = np.zeros((T, len(keep) * bcap_s) + leaf.shape[2:], leaf.dtype)
        for t in range(T):
            starts = np.concatenate([[0], np.cumsum(counts[t])])
            for i, s in enumerate(keep):
                c = int(counts[t, s])
                out[t, i * bcap_s:i * bcap_s + c] = leaf[t, starts[s]:starts[s] + c]
        return torch.from_numpy(out).to(dev)

    return (pytree.tree_map(repack, batches),
            torch.from_numpy(np.ascontiguousarray(counts[:, list(keep)])).to(dev))
