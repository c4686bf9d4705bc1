"""Decay schedules: arbitrary per-tick multiplicative decay for R-TBS.

A :class:`DecaySchedule` produces the tick's factor ``d_t`` in [0, 1] and the
bookkeeping state needed to compute it; ``W <- d_t * W + B_t`` each tick
gives item i (arriving at tick t_i) the weight D_t / D_{t_i}, with
D_t = prod_{s <= t} d_s.

  * :func:`exponential`   -- the paper's eq. (1), ``d_t = e^{-lam}``;
    ``static_rate`` is set, so samplers built from it carry no schedule
    state. The factor is computed on the host in double and rounded to f32
    once, exactly as the JAX package does, so both packages and both
    devices decay by the same f32.
  * :func:`polynomial`    -- power-law weights ``((t_i + t0)/(t + t0))^beta``.
  * :func:`piecewise`     -- exponential with a tick-indexed rate table.
  * :func:`from_callable` -- any ``t -> d_t`` written in torch ops.

Schedule state is an f32 0-d device tensor (the elapsed time). Nothing here
copies from the host during a tick: constants enter ops as Python scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device

_F32 = torch.float32


@dataclasses.dataclass
class DecayedState:
    """Sampler state wrapped with its schedule's bookkeeping (schedules
    without a ``static_rate``)."""

    dstate: Any
    inner: Any


pytree.register_dataclass(DecayedState)


@dataclasses.dataclass(frozen=True, eq=False)
class DecaySchedule:
    """A decay function in per-tick multiplicative form.

    ``init(device)`` returns the schedule state; ``rate(dstate)`` is THIS
    tick's factor (f32 0-d tensor in [0, 1]); ``step(dstate)`` advances one
    tick. ``static_rate`` is set iff the rate is a constant. ``rate_dt`` /
    ``step_dt`` cover a wall-clock gap ``dt`` where a schedule defines them
    (see :meth:`factor_dt`)."""

    name: str
    init: Callable[[Any], Any]
    rate: Callable[[Any], torch.Tensor]
    step: Callable[[Any], Any]
    hyper: Mapping[str, Any]
    static_rate: float | None = None
    rate_dt: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    step_dt: Callable[[Any, torch.Tensor], Any] | None = None

    def factor_dt(self, dstate, dt) -> torch.Tensor:
        """The composed factor over a gap of ``dt`` time units (exact for
        exponential and polynomial; the current rate held flat otherwise)."""
        dt = torch.as_tensor(dt, dtype=_F32, device=dstate.device)
        if self.rate_dt is not None:
            return torch.clamp(self.rate_dt(dstate, dt).to(_F32), 0.0, 1.0)
        return self.rate(dstate) ** dt

    def advance_dt(self, dstate, dt) -> Any:
        if self.step_dt is not None:
            return self.step_dt(dstate, torch.as_tensor(dt, dtype=_F32,
                                                        device=dstate.device))
        return self.step(dstate)

    def tick(self, dstate, dt=None):
        """``(d_t, advanced state)`` in one call; with ``dt`` the factor
        covers the whole gap."""
        if dt is None:
            return self.rate(dstate), self.step(dstate)
        return self.factor_dt(dstate, dt), self.advance_dt(dstate, dt)

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"{self.name}({hp})"


def _counter_schedule(name: str, rate_of_t: Callable[[torch.Tensor], Any],
                      hyper: Mapping[str, Any],
                      static_rate: float | None = None,
                      rate_dt=None) -> DecaySchedule:
    """Schedules whose only state is the elapsed-time counter t (f32 0-d,
    starts at 0, advances by 1 per tick or by ``dt`` exactly)."""
    return DecaySchedule(
        name=name,
        init=lambda device: torch.zeros((), dtype=_F32, device=device),
        rate=lambda t: torch.clamp(torch.as_tensor(rate_of_t(t)).to(_F32),
                                   0.0, 1.0),
        step=lambda t: t + 1.0,
        hyper=hyper,
        static_rate=static_rate,
        rate_dt=rate_dt,
        step_dt=lambda t, dt: t + dt,
    )


def exponential(lam: float) -> DecaySchedule:
    """The paper's exponential decay: ``d_t = e^{-lam}`` every tick."""
    if lam < 0:
        raise ValueError(f"exponential decay needs lam >= 0; got {lam}")
    d = math.exp(-float(lam))
    return _counter_schedule(
        "exponential", lambda t: torch.full_like(t, d), {"lam": float(lam)},
        static_rate=d,
        rate_dt=lambda t, dt: torch.exp(dt * -float(lam)),
    )


def polynomial(beta: float, *, t0: float = 1.0) -> DecaySchedule:
    """Power-law weights ``((t_i + t0) / (t + t0)) ** beta`` via the
    telescoping factor ``d_t = ((t - 1 + t0) / (t + t0)) ** beta``."""
    if beta < 0:
        raise ValueError(f"polynomial decay needs beta >= 0; got {beta}")
    if t0 <= 0:
        raise ValueError(f"polynomial decay needs t0 > 0; got {t0}")

    def rate(t):
        return (torch.clamp(t - 1.0 + t0, min=0.0) / (t + t0)) ** beta

    def rate_dt(t, dt):
        return (torch.clamp(t - 1.0 + t0, min=0.0)
                / torch.clamp(t - 1.0 + dt + t0, min=1e-30)) ** beta

    return _counter_schedule("polynomial", rate,
                             {"beta": float(beta), "t0": float(t0)},
                             rate_dt=rate_dt)


def piecewise(boundaries: tuple[int, ...], lams: tuple[float, ...]) -> DecaySchedule:
    """Exponential decay with rate ``lams[k]`` on ticks in
    ``[boundaries[k-1], boundaries[k])``."""
    boundaries = tuple(int(b) for b in boundaries)
    lams = tuple(float(v) for v in lams)
    if len(lams) != len(boundaries) + 1:
        raise ValueError(
            f"piecewise needs len(lams) == len(boundaries) + 1; got "
            f"{len(lams)} lams, {len(boundaries)} boundaries")
    if any(b2 <= b1 for b1, b2 in zip(boundaries, boundaries[1:])):
        raise ValueError(f"boundaries must be strictly increasing: {boundaries}")
    if any(v < 0 for v in lams):
        raise ValueError(f"piecewise lams must be >= 0: {lams}")
    dec = [math.exp(-v) for v in lams]

    def rate(t):
        ti = t.to(torch.int32)
        r = torch.full_like(t, dec[0])
        for b, d in zip(boundaries, dec[1:]):   # later segments override
            r = torch.where(ti >= b, d, r)
        return r

    return _counter_schedule(
        "piecewise", rate, {"boundaries": boundaries, "lams": lams},
        static_rate=(dec[0] if not boundaries else None),
    )


def from_callable(fn: Callable[[torch.Tensor], torch.Tensor], *,
                  name: str = "callable", **hyper) -> DecaySchedule:
    """Arbitrary decay ``fn(t) -> d_t`` in torch ops on the f32 elapsed
    time ``t`` (clipped to [0, 1])."""
    return _counter_schedule(name, fn, dict(hyper))


def resolve(lam: float | None = None,
            decay: DecaySchedule | None = None) -> DecaySchedule:
    """Exactly one of ``lam`` (exponential sugar) and ``decay``."""
    if (lam is None) == (decay is None):
        raise ValueError(
            "pass exactly one of lam= (scalar exponential sugar) or decay= "
            f"(a DecaySchedule); got lam={lam!r}, decay={decay!r}")
    if decay is None:
        return exponential(lam)
    if not isinstance(decay, DecaySchedule):
        raise TypeError(
            f"decay= must be a repro_torch.decay.DecaySchedule; got "
            f"{type(decay).__name__} -- for a scalar rate use lam=")
    return decay


def decay_profile(schedule: DecaySchedule, T: int, device=None) -> torch.Tensor:
    """The first ``T`` factors ``[d_0, ..., d_{T-1}]`` of a schedule."""
    ds = schedule.init(_device.resolve(device))
    out = []
    for _ in range(T):
        d, ds = schedule.tick(ds)
        out.append(d)
    return torch.stack(out)
