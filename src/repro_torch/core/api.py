"""The Sampler API: a scheme bound to its hyperparameters behind one
``init / step / extract / size`` interface (the JAX package's
``repro.core.api``).

Registered: R-TBS (``"rtbs"``, paper Alg. 2), T-TBS (``"ttbs"``, Alg. 1),
B-TBS (``"btbs"``, Alg. 4), B-RS (``"brs"``, Alg. 5, the paper's "Unif")
and the sliding window (``"sw"``). The distributed schemes ``"dttbs"`` and
``"drtbs"`` raise ``ValueError`` naming the ROADMAP queue that ports them.

Conventions:
  * ``init(item_proto)`` takes a pytree of tensors shaped like ONE item, on
    the sampler's device, and returns the state;
  * ``step(key, state, batch_items, bcount)`` consumes one batch (leaves
    [bcap, ...], valid prefix ``bcount``, a 0-d device tensor);
  * ``extract(key, state)`` realizes the sample as a :class:`SampleView`
    and ``size(key, state)`` is its payload-free size for the same key;
  * keys are :class:`repro_torch.core.prng.Key`; nothing syncs to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.decay import DecayedState, DecaySchedule
from repro_torch.decay import resolve as _resolve_schedule

from . import latent as lt
from . import prng, rtbs, simple


@dataclasses.dataclass
class SampleView:
    """A realized sample: ``items`` leaves [cap, ...], ``mask`` bool [cap],
    ``size`` int64 (== mask.sum()). Rows with mask False are garbage."""

    items: Any
    mask: torch.Tensor
    size: torch.Tensor


pytree.register_dataclass(SampleView)


@dataclasses.dataclass(frozen=True, eq=False)
class Sampler:
    """A sampling scheme bound to its hyperparameters and device.

    ``step_decayed(key, state, batch, bcount, d)``, set on the time-biased
    schemes (rtbs, ttbs, btbs) and ``None`` on the decay-free baselines
    (brs, sw), is ``step`` with the tick's decay factor ``d`` (an f32 0-d
    device tensor) given from outside: the manage loop's closed-loop
    controller drives the schemes through it. Under a time-varying
    schedule the external ``d`` overrides the schedule's factor for that
    tick, and the schedule's state still advances."""

    scheme: str
    init: Callable[[Any], Any]
    step: Callable[..., Any]
    extract: Callable[[prng.Key, Any], SampleView]
    size: Callable[[prng.Key, Any], torch.Tensor]
    hyper: Mapping[str, Any]
    device: torch.device
    step_decayed: Callable[..., Any] | None = None

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"Sampler({self.scheme}, {hp})"


def materialize_view(view: SampleView) -> SampleView:
    """Pack a realized sample's selected rows to the buffer head through the
    reservoir_compact kernel (B2), so consumers see a dense [0, size)
    prefix; ``mask.sum() == size`` is preserved."""
    items = lt.compact_items(view.items, view.mask)
    cap = view.mask.shape[0]
    mask = torch.arange(cap, device=view.mask.device) < view.size
    return SampleView(items=items, mask=mask, size=view.size)


_REGISTRY: dict[str, Callable[..., Sampler]] = {}

# schemes of the JAX package that later slices port, by ROADMAP queue item
_NOT_PORTED = {"dttbs": "A.7", "drtbs": "A.7"}


def register(name: str):
    """Decorator: register a ``**hyper -> Sampler`` builder under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_schemes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_sampler(scheme: str, *, device=None, **hyper) -> Sampler:
    """Construct a registered scheme, e.g. ``make_sampler("rtbs", n=300,
    lam=0.1)``. ``device=None`` means the CUDA card (raises without one)."""
    builder = _REGISTRY.get(scheme)
    if builder is None:
        if scheme in _NOT_PORTED:
            raise ValueError(
                f"sampling scheme {scheme!r} is not ported to repro_torch yet "
                f"(ROADMAP queue {_NOT_PORTED[scheme]}); available: "
                f"{available_schemes()}")
        raise ValueError(
            f"unknown sampling scheme {scheme!r}; available: {available_schemes()}")
    return builder(device=_device.resolve(device), **hyper)


def _thread_schedule(sched: DecaySchedule, device: torch.device, *, init,
                     step_d, extract, size) -> dict:
    """Wire a schedule into a scheme's decay-parametric closures. Constant
    schedules bake the factor in (one f32 device tensor made here, not per
    tick) and keep the bare state; time-varying ones wrap the state in
    :class:`DecayedState` and pull ``d`` from the schedule each tick. Either
    way ``step_decayed`` takes the same state as ``step``."""
    if sched.static_rate is not None:
        d0 = torch.full((), sched.static_rate, dtype=torch.float32,
                        device=device)

        def step(key, state, batch_items, bcount):
            return step_d(key, state, batch_items, bcount, d0)

        return dict(init=init, step=step, extract=extract, size=size,
                    step_decayed=step_d)

    def init_w(proto):
        return DecayedState(dstate=sched.init(device), inner=init(proto))

    def step_w(key, state, batch_items, bcount):
        d, dstate = sched.tick(state.dstate)
        return DecayedState(dstate=dstate,
                            inner=step_d(key, state.inner, batch_items, bcount, d))

    def step_decayed(key, state, batch_items, bcount, d):
        return DecayedState(dstate=sched.step(state.dstate),
                            inner=step_d(key, state.inner, batch_items, bcount, d))

    def unwrap(fn):
        return lambda key, state: fn(key, state.inner)

    return dict(init=init_w, step=step_w, extract=unwrap(extract),
                size=unwrap(size), step_decayed=step_decayed)


def _decay_hyper(sched: DecaySchedule, lam) -> dict:
    h = {"decay": sched}
    if lam is not None:
        h["lam"] = lam
    return h


@register("rtbs")
def _make_rtbs(*, n: int, lam: float | None = None,
               decay: DecaySchedule | None = None,
               device: torch.device) -> Sampler:
    """R-TBS (paper Alg. 2): bounded size + exact time bias at any rate."""
    sched = _resolve_schedule(lam, decay)

    def step_d(key, state, batch_items, bcount, d):
        return rtbs.step(key, state, batch_items, bcount, n=n, decay=d)

    def extract(key, state):
        mask, size = rtbs.realize(key, state)
        return SampleView(items=state.lat.items, mask=mask, size=size)

    def size(key, state):
        k, take, _ = lt.partial_draw(prng.uniform_for(key, state.lat.weight),
                                     state.lat.weight)
        return k + take.to(torch.int64)

    return Sampler(
        scheme="rtbs",
        hyper={"n": n, **_decay_hyper(sched, lam)},
        device=device,
        **_thread_schedule(sched, device,
                           init=lambda proto: rtbs.init(proto, n),
                           step_d=step_d, extract=extract, size=size),
    )


def _ttbs_rates(n: int, p: float, batch_size: float) -> tuple[float, float]:
    """Alg. 1's rates from the retention probability p = e^{-lam}:
    q = n (1 - p) / b, which must lie in (0, 1]."""
    q = n * (1.0 - p) / batch_size
    if not 0.0 < q <= 1.0:
        raise ValueError(
            f"T-TBS needs q = n(1-e^-lam)/b in (0, 1]; got q={q:.4f} "
            f"(n={n}, lam={-math.log(p):.4f}, batch_size={batch_size})")
    return p, q


def _ttbs_step_d(n: int, batch_size: float, device: torch.device):
    """Alg. 1 with the decay factor as an operand: p_t = d_t and
    q_t = n (1 - p_t) / b clipped into [0, 1] (a time-varying schedule may
    ask for q > 1; the clip under-fills instead of failing)."""
    b = torch.full((), float(batch_size), dtype=torch.float32, device=device)

    def step_d(key, state, batch_items, bcount, d):
        d = d.to(torch.float32)
        q = torch.clamp(n * (1.0 - d) / b, 0.0, 1.0)
        return simple.ttbs_step(key, state, batch_items, bcount, p=d, q=q)

    return step_d


def _buffer_extract(key, state: simple.BufferState) -> SampleView:
    del key        # membership is deterministic: the sample is the buffer
    mask, size = simple.realize_all(state)
    return SampleView(items=state.items, mask=mask, size=size)


def _buffer_size(key, state: simple.BufferState) -> torch.Tensor:
    del key
    return state.count


@register("ttbs")
def _make_ttbs(*, n: int, lam: float | None = None, batch_size: float,
               cap: int | None = None, decay: DecaySchedule | None = None,
               device: torch.device) -> Sampler:
    """T-TBS (paper Alg. 1): exact eq. (1), size controlled only in mean."""
    sched = _resolve_schedule(lam, decay)
    cap = 4 * n if cap is None else cap
    hyper = {"n": n, **_decay_hyper(sched, lam), "batch_size": batch_size, "cap": cap}
    fields = _thread_schedule(sched, device,
                              init=lambda proto: simple.init(proto, cap),
                              step_d=_ttbs_step_d(n, batch_size, device),
                              extract=_buffer_extract, size=_buffer_size)
    if sched.static_rate is not None:
        # validate eagerly, and apply exactly these f64-derived rates,
        # rounded once to f32 (not a per-tick f32 recomputation)
        p, q = _ttbs_rates(n, sched.static_rate, batch_size)
        hyper.update(p=p, q=q)
        pt, qt = (torch.full((), v, dtype=torch.float32, device=device) for v in (p, q))

        def step(key, state, batch_items, bcount):
            return simple.ttbs_step(key, state, batch_items, bcount, p=pt, q=qt)

        fields["step"] = step
    return Sampler(scheme="ttbs", hyper=hyper, device=device, **fields)


@register("btbs")
def _make_btbs(*, lam: float | None = None, cap: int,
               decay: DecaySchedule | None = None, device: torch.device) -> Sampler:
    """B-TBS (paper Alg. 4): Bernoulli TBS, T-TBS with q = 1."""
    sched = _resolve_schedule(lam, decay)

    def step_d(key, state, batch_items, bcount, d):
        return simple.btbs_step(key, state, batch_items, bcount, p=d)

    return Sampler(scheme="btbs", hyper={**_decay_hyper(sched, lam), "cap": cap},
                   device=device,
                   **_thread_schedule(sched, device,
                                      init=lambda proto: simple.init(proto, cap),
                                      step_d=step_d, extract=_buffer_extract,
                                      size=_buffer_size))


@register("brs")
def _make_brs(*, n: int, device: torch.device) -> Sampler:
    """B-RS (paper Alg. 5): batched uniform reservoir sampling, "Unif"."""

    def step(key, state, batch_items, bcount):
        return simple.brs_step(key, state, batch_items, bcount, n=n)

    return Sampler(scheme="brs", init=lambda proto: simple.init(proto, n), step=step,
                   extract=_buffer_extract, size=_buffer_size, hyper={"n": n},
                   device=device)


@register("sw")
def _make_sw(*, n: int, device: torch.device) -> Sampler:
    """SW: a sliding window over the last n items (the paper's baseline)."""

    def step(key, state, batch_items, bcount):
        return simple.sw_step(key, state, batch_items, bcount, n=n)

    return Sampler(scheme="sw", init=lambda proto: simple.init(proto, n), step=step,
                   extract=_buffer_extract, size=_buffer_size, hyper={"n": n},
                   device=device)
