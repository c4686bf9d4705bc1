"""The Sampler API: a scheme bound to its hyperparameters behind one
``init / step / extract / size`` interface (the JAX package's
``repro.core.api``).

Registered: R-TBS (``"rtbs"``, paper Alg. 2), T-TBS (``"ttbs"``, Alg. 1),
B-TBS (``"btbs"``, Alg. 4), B-RS (``"brs"``, Alg. 5, the paper's "Unif"),
the sliding window (``"sw"``), and the distributed schemes of Sec. 5,
D-T-TBS (``"dttbs"``) and D-R-TBS (``"drtbs"``), whose states carry the S
reservoir shards as a leading dimension (:mod:`.distributed`).

Conventions:
  * ``init(item_proto)`` takes a pytree of tensors shaped like ONE item, on
    the sampler's device, and returns the state;
  * ``step(key, state, batch_items, bcount)`` consumes one batch (leaves
    [bcap, ...], valid prefix ``bcount``, a 0-d device tensor);
  * ``extract(key, state)`` realizes the sample as a :class:`SampleView`
    and ``size(key, state)`` is its payload-free size for the same key;
  * keys are :class:`repro_torch.core.prng.Key`; nothing syncs to the host.

A distributed scheme (``distributed=True``) steps the shards of its shard
axis (``axis=``, :mod:`.distributed`): every shard of a stacked state at
once (no axis, or a ``StackedAxis``), or a rank's one shard of a process
group (a ``GroupAxis``; without one a rank's calls raise).
``init(item_proto)`` is ONE shard's state
(:func:`repro_torch.manage.init_sharded_state` stacks the process's), ``step``
takes the state ``[..., S_local, ...]``, batch leaves ``[S_local, bcap_s,
...]`` and ``bcount`` ``[S_local]``, ``extract`` / ``size`` give each of
those shards' view, and ``extract_global`` / ``size_global`` the whole
sample, packed to a dense prefix through B2. :meth:`Sampler.over` rebinds
the scheme to another axis (the sharded loops bind their mesh's).
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
from . import distributed, prng, rtbs, simple


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
    tick, and the schedule's state still advances.

    ``distributed`` marks the Sec. 5 schemes (drtbs, dttbs), which also
    set ``extract_global`` / ``size_global``: the realized sample of all
    shards as one :class:`SampleView` packed to ``[0, size)``, and its size
    for the same key. Local schemes leave them ``None``. ``axis`` is a
    distributed scheme's shard axis (None: the stacked axis of the state's
    shard dimension)."""

    scheme: str
    init: Callable[[Any], Any]
    step: Callable[..., Any]
    extract: Callable[[prng.Key, Any], SampleView]
    size: Callable[[prng.Key, Any], torch.Tensor]
    hyper: Mapping[str, Any]
    device: torch.device
    step_decayed: Callable[..., Any] | None = None
    distributed: bool = False
    extract_global: Callable[[prng.Key, Any], SampleView] | None = None
    size_global: Callable[[prng.Key, Any], torch.Tensor] | None = None
    axis: Any = None
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"Sampler({self.scheme}, {hp})"

    def over(self, axis) -> "Sampler":
        """This distributed scheme, its closures over the shard ``axis``
        (a mesh's ``shard_axis``)."""
        if not self.distributed:
            raise ValueError(f"{self.scheme} is not a distributed scheme")
        if axis is self.axis:
            return self
        return make_sampler(self.scheme, device=self.device, **{**self.args, "axis": axis})


def materialize_view(view: SampleView) -> SampleView:
    """Pack a realized sample's selected rows to the buffer head through the
    reservoir_compact kernel (B2), so consumers see a dense [0, size)
    prefix; ``mask.sum() == size`` is preserved."""
    items = lt.compact_items(view.items, view.mask)
    cap = view.mask.shape[0]
    mask = torch.arange(cap, device=view.mask.device) < view.size
    return SampleView(items=items, mask=mask, size=view.size)


_REGISTRY: dict[str, Callable[..., Sampler]] = {}


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
        raise ValueError(
            f"unknown sampling scheme {scheme!r}; available: {available_schemes()}")
    return dataclasses.replace(builder(device=_device.resolve(device), **hyper), args=hyper)


def _thread_schedule(sched: DecaySchedule, device: torch.device, *, init,
                     step_d, extract, size, **realize) -> dict:
    """Wire a schedule into a scheme's decay-parametric closures. Constant
    schedules bake the factor in (one f32 device tensor made here, not per
    tick) and keep the bare state; time-varying ones wrap the state in
    :class:`DecayedState` and pull ``d`` from the schedule each tick. Either
    way ``step_decayed`` takes the same state as ``step``. ``realize``
    holds further ``(key, state)`` closures (``extract_global``,
    ``size_global``), unwrapped like ``extract``."""
    if sched.static_rate is not None:
        d0 = torch.full((), sched.static_rate, dtype=torch.float32,
                        device=device)

        def step(key, state, batch_items, bcount):
            return step_d(key, state, batch_items, bcount, d0)

        return dict(init=init, step=step, extract=extract, size=size,
                    step_decayed=step_d, **realize)

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
                size=unwrap(size), step_decayed=step_decayed,
                **{k: unwrap(fn) for k, fn in realize.items()})


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


def _ttbs_step_d(n: int, batch_size: float, device: torch.device, step=simple.ttbs_step):
    """Alg. 1 with the decay factor as an operand: p_t = d_t and
    q_t = n (1 - p_t) / b clipped into [0, 1] (a time-varying schedule may
    ask for q > 1; the clip under-fills instead of failing). ``step`` is
    T-TBS's, or D-T-TBS's on every shard."""
    b = torch.full((), float(batch_size), dtype=torch.float32, device=device)

    def step_d(key, state, batch_items, bcount, d):
        d = d.to(torch.float32)
        q = torch.clamp(n * (1.0 - d) / b, 0.0, 1.0)
        return step(key, state, batch_items, bcount, p=d, q=q)

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


# ---------------------------------------------------------------------------
# distributed schemes (paper Sec. 5): the shards along ``axis``
# ---------------------------------------------------------------------------
@register("dttbs")
def _make_dttbs(*, n: int, lam: float | None = None, batch_size: float,
                cap: int | None = None, decay: DecaySchedule | None = None,
                axis=None, device: torch.device) -> Sampler:
    """D-T-TBS (paper Sec. 5.1): T-TBS on every shard, no coordination.
    ``n`` and ``batch_size`` are PER-SHARD targets; shard s steps with
    ``fold_in(key, s)``."""
    sched = _resolve_schedule(lam, decay)
    cap = 4 * n if cap is None else cap
    hyper = {"n": n, **_decay_hyper(sched, lam), "batch_size": batch_size, "cap": cap}

    def shard_step(key, state, batch_items, bcount, *, p, q):
        return distributed.dttbs_shard_step(key, state, batch_items, bcount, p=p, q=q,
                                            axis=axis)

    step_d = _ttbs_step_d(n, batch_size, device, step=shard_step)

    def extract_global(key, state):
        del key   # membership is deterministic
        items, mask, size = distributed.buffer_extract_global(state, axis)
        return SampleView(items=items, mask=mask, size=size)

    def size_global(key, state):
        del key
        return distributed.psum(state.count, axis)

    fields = _thread_schedule(sched, device,
                              init=lambda proto: simple.init(proto, cap), step_d=step_d,
                              extract=_buffer_extract, size=_buffer_size,
                              extract_global=extract_global, size_global=size_global)
    if sched.static_rate is not None:
        # as for ttbs: validate eagerly, apply the f64-derived rates
        p, q = _ttbs_rates(n, sched.static_rate, batch_size)
        hyper.update(p=p, q=q)
        pt, qt = (torch.full((), v, dtype=torch.float32, device=device) for v in (p, q))

        def step(key, state, batch_items, bcount):
            return shard_step(key, state, batch_items, bcount, p=pt, q=qt)

        fields["step"] = step
    return Sampler(scheme="dttbs", hyper=hyper, device=device, distributed=True, axis=axis,
                   **fields)


@register("drtbs")
def _make_drtbs(*, n: int, lam: float | None = None, cap_s: int,
                decay: DecaySchedule | None = None, axis=None,
                device: torch.device) -> Sampler:
    """D-R-TBS (paper Sec. 5.2-5.3): co-partitioned reservoir, distributed
    decisions. ``n`` is the GLOBAL bound, ``cap_s`` the per-shard capacity.

    ``extract`` gives each shard's slice of the realized sample, item leaves
    ``[..., S, cap_s + 1, ...]``: the shard's buffer and ONE reserved slot
    (``cap_s``) holding the partial item, realized w.p. frac(C) on shard 0
    only, so ``mask.sum() == size`` holds per shard and globally (a copy of
    the buffers; the loops use ``extract_global``, which copies none)."""
    sched = _resolve_schedule(lam, decay)

    def step_d(key, state, batch_items, bcount, d):
        return distributed.drtbs_shard_step(key, state, batch_items, bcount, n=n, decay=d,
                                            axis=axis)

    def extract(key, state):
        mask, size, take = distributed.drtbs_realize_shard(key, state, axis)
        nl = state.nfull.dim()
        items = pytree.tree_map(lambda a, p: torch.cat([a, p.unsqueeze(nl)], dim=nl),
                                state.items, state.partial_item)
        return SampleView(items=items, mask=torch.cat([mask, take.unsqueeze(-1)], dim=-1),
                          size=size)

    def size(key, state):
        return distributed.drtbs_realize_shard(key, state, axis)[1]

    def extract_global(key, state):
        items, mask, size = distributed.drtbs_extract_global(key, state, axis)
        return SampleView(items=items, mask=mask, size=size)

    def size_global(key, state):
        return distributed.drtbs_global_size(key, state, axis)

    return Sampler(
        scheme="drtbs", hyper={"n": n, **_decay_hyper(sched, lam), "cap_s": cap_s},
        device=device, distributed=True, axis=axis,
        **_thread_schedule(sched, device,
                           init=lambda proto: distributed.init_shard(proto, cap_s),
                           step_d=step_d, extract=extract, size=size,
                           extract_global=extract_global, size_global=size_global))
