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

Not ported yet: the closed-loop decay ``controller=`` and ``telemetry=``
(they raise ``NotImplementedError``), Monte-Carlo farms and the sharded
loops (ROADMAP queue A).
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
from repro_torch.obs.profile import scope as _scope


def tick_keys(key: prng.Key, t: int) -> tuple[prng.Key, prng.Key, prng.Key]:
    """The loop's per-tick (step, extract, fit) keys."""
    return prng.split(prng.fold_in(key, t), 3)


def item_proto(batches: Any) -> Any:
    """ONE-item prototype (tensors on the batches' device) from stacked
    stream tensors (leaves [T, bcap, ...])."""
    return pytree.tree_map(lambda a: torch.zeros(a.shape[2:], dtype=a.dtype,
                                                 device=a.device), batches)


def make_manage_step(sampler: Sampler, model: ModelAdapter, *,
                     retrain_every: int = 1) -> Callable:
    """One tick of the loop: ``(key, t, state, params, batch, bcount) ->
    (state, params, metrics)`` with ``t`` a host int. The same tick body
    :func:`make_run_loop` runs, so driving it tick by tick is bit-identical
    to the loop."""

    def tick(key, t: int, state, params, batch_items, bcount):
        k_step, k_extract, k_fit = tick_keys(key, t)
        with _scope("manage.eval"):
            metric = model.evaluate(params, batch_items, bcount)
        with _scope("manage.sampler_step"):
            state = sampler.step(k_step, state, batch_items, bcount)
        if (t + 1) % retrain_every == 0:
            with _scope("manage.retrain"):
                params = model.fit(k_fit, params, sampler.extract(k_extract, state))
        with _scope("manage.size"):
            metrics = {"metric": metric, "size": sampler.size(k_extract, state)}
        return state, params, metrics

    return tick


def make_run_loop(sampler: Sampler, model: ModelAdapter, *,
                  retrain_every: int = 1, superbatch: int | None = None,
                  controller=None, telemetry=None) -> Callable:
    """Returns ``run(key, batches, bcounts) -> (state, params, trace)``:
    ``batches`` leaves [T, bcap, ...] and ``bcounts`` [T] on the device,
    ``trace`` = {"metric": f32 [T], "size": int64 [T]}.

    ``superbatch`` is accepted for the JAX package's signature and changes
    nothing (there is no compiled scan body to chunk here)."""
    del superbatch
    if controller is not None:
        raise NotImplementedError("controller= (adaptive decay) is not ported "
                                  "to repro_torch yet (ROADMAP queue A.5)")
    if telemetry is not None:
        raise NotImplementedError("telemetry= is not ported to repro_torch yet "
                                  "(ROADMAP queue A.9)")
    tick = make_manage_step(sampler, model, retrain_every=retrain_every)

    def run(key: prng.Key, batches: Any, bcounts: torch.Tensor):
        state = sampler.init(item_proto(batches))
        params = model.init()
        ms = []
        for t in range(bcounts.shape[0]):
            batch_t = pytree.tree_map(lambda a: a[t], batches)
            state, params, m = tick(key, t, state, params, batch_t, bcounts[t])
            ms.append(m)
        trace = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return state, params, trace

    return run


def run_loop(key: prng.Key, sampler: Sampler, model: ModelAdapter,
             batches: Any, bcounts: torch.Tensor, *, retrain_every: int = 1,
             superbatch: int | None = None, controller=None):
    """One-shot convenience wrapper over :func:`make_run_loop`."""
    return make_run_loop(sampler, model, retrain_every=retrain_every,
                         superbatch=superbatch,
                         controller=controller)(key, batches, bcounts)


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
