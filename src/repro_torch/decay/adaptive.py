"""Closed-loop adaptive decay: drive lambda from the prequential loss (the
JAX package's ``repro.decay.adaptive``, DESIGN.md Sec. 12).

The decay rate is the paper's robustness-vs-adaptivity dial: a large
lambda forgets fast (quick recovery after drift, small steady-state
sample), a small one remembers. The controller moves along the dial online
from the one signal the manage loop already makes every tick, the
prequential metric:

    fast <- (1 - a_f) fast + a_f loss_t          (short horizon)
    slow <- (1 - a_s) slow + a_s loss_t          (long horizon, a_s < a_f)
    on retrain ticks:
        e = log(fast / slow)
        if e > fire and not refractory:  loglam <- log lam_max   # pulse
        else:                            loglam <- clip(loglam
                                             + gain_down * dead(e) - relax,
                                             [log lam_min, log lam_max])

with ``dead(e) = min(e + deadband, 0)``. A pulse arms a refractory window
of ``cooldown`` adjustments in which only the anneal runs; ``relax`` leaks
log-lambda toward ``lam_min`` whenever no pulse fires. The JAX module's
docstring gives the reasons for each.

Contract:

  * ``init(device) -> ControllerState``  0-d device tensors;
  * ``rate(c) -> d_t``                   this tick's factor, exp(-exp(loglam))
                                         (each exp in f64, rounded to f32);
  * ``observe(c, loss, adjust)``         fold in one prequential loss;
                                         ``adjust`` (a host bool or a device
                                         bool) gates the lambda update.

``observe`` ignores non-finite losses (empty ticks report NaN) and runs its
first ``warmup`` finite losses in estimate-only mode. Every function is
elementwise, so a state whose fields carry a leading [Q] dimension is Q
controllers at once (the bank loop's per-key form). Nothing is read on the
host: constants enter the ops as Python scalars, and a host ``adjust`` only
chooses which ops run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.latent import fma_f32

_F32, _I32 = torch.float32, torch.int32


@dataclasses.dataclass
class ControllerState:
    """Loop-carried state of the loss-ratio controller."""

    loglam: torch.Tensor   # f32, log of the current decay rate lambda
    fast: torch.Tensor     # f32, short-horizon EMA of the prequential loss
    slow: torch.Tensor     # f32, long-horizon EMA of the prequential loss
    seen: torch.Tensor     # int32, finite losses observed so far
    hold: torch.Tensor     # int32, refractory adjustments left

    @property
    def lam(self) -> torch.Tensor:
        return _f32_of(torch.exp(self.loglam.double()))


pytree.register_dataclass(ControllerState)


@dataclasses.dataclass(frozen=True, eq=False)
class AdaptiveDecay:
    """A closed-loop decay controller (module docstring); ``stats(c)`` gives
    its gauges ``{"lam", "hold", "pulse"}``."""

    name: str
    init: Callable[[Any], ControllerState]
    rate: Callable[[ControllerState], torch.Tensor]
    observe: Callable[[ControllerState, torch.Tensor, Any], ControllerState]
    hyper: Mapping[str, Any]
    stats: Callable[[ControllerState], Mapping[str, torch.Tensor]] | None = None

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"{self.name}({hp})"


def _f32_of(x: torch.Tensor) -> torch.Tensor:
    """An f64 result rounded to f32. Each of the controller's ``exp`` and
    ``log`` is taken in f64 and rounded once, so the card, the CPU and a [Q]
    state's vectorised loops give one f32 (an f32 ``exp`` differs between
    them by an ulp); XLA's f32 ``exp`` and ``log`` are another matter
    (ROADMAP C.11)."""
    return x.to(_F32)


def _ema(alpha: float, prev: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """``(1 - alpha) prev + alpha loss`` as XLA compiles the JAX package's
    jitted controller: the second product rounded to f32, then one fused
    multiply-add (:func:`repro_torch.core.latent.fma_f32`)."""
    a = torch.full((), 1 - alpha, dtype=_F32, device=prev.device)
    return fma_f32(a, prev, alpha * loss)


def loss_ratio(*, lam0: float, lam_min: float, lam_max: float,
               fast_alpha: float = 0.5, slow_alpha: float = 0.05,
               fire: float = 0.25, gain_down: float = 1.0,
               relax: float = 0.3, cooldown: int = 8,
               deadband: float = 0.05, warmup: int = 3) -> AdaptiveDecay:
    """The fast/slow-EMA loss-ratio controller, with the JAX package's
    hyperparameters and defaults: ``lam0`` the starting rate, ``[lam_min,
    lam_max]`` the clip range, ``fire`` the log-ratio that pulses lambda to
    ``lam_max``, ``cooldown`` the refractory window after a pulse,
    ``gain_down`` and ``relax`` the anneal's step and leak, ``deadband`` the
    ignored band of a falling ratio, ``warmup`` the finite losses consumed
    before any adjustment."""
    if not 0 < lam_min <= lam0 <= lam_max:
        raise ValueError(
            f"need 0 < lam_min <= lam0 <= lam_max; got "
            f"lam_min={lam_min}, lam0={lam0}, lam_max={lam_max}")
    if not 0 < slow_alpha <= fast_alpha <= 1:
        raise ValueError(
            f"need 0 < slow_alpha <= fast_alpha <= 1; got "
            f"slow_alpha={slow_alpha}, fast_alpha={fast_alpha}")
    lo, hi = math.log(lam_min), math.log(lam_max)
    # the f32 constants JAX's weakly typed Python floats become
    hi32 = float(torch.tensor(hi, dtype=_F32))

    def init(device) -> ControllerState:
        def full(v, dtype):
            return torch.full((), v, dtype=dtype, device=device)

        return ControllerState(loglam=full(math.log(lam0), _F32), fast=full(0.0, _F32),
                               slow=full(0.0, _F32), seen=full(0, _I32),
                               hold=full(0, _I32))

    def rate(c: ControllerState) -> torch.Tensor:
        return _f32_of(torch.exp(-c.lam.double()))

    def observe(c: ControllerState, loss, adjust) -> ControllerState:
        loss = torch.as_tensor(loss, device=c.fast.device).to(_F32)
        ok = torch.isfinite(loss)
        loss = torch.where(ok, loss, 0.0)
        first = c.seen == 0
        fast = torch.where(first, loss, _ema(fast_alpha, c.fast, loss))
        slow = torch.where(first, loss, _ema(slow_alpha, c.slow, loss))
        fast = torch.where(ok, fast, c.fast)
        slow = torch.where(ok, slow, c.slow)
        seen = c.seen + ok.to(_I32)

        err = _f32_of(torch.log((torch.clamp(fast, min=1e-12)
                                 / torch.clamp(slow, min=1e-12)).double()))
        do = ok & (seen >= warmup)
        if isinstance(adjust, torch.Tensor):
            do = do & adjust.to(torch.bool)
        elif not adjust:
            do = torch.zeros_like(do)
        pulse = do & (err > fire) & (c.hold == 0)
        # anneal side: the below-deadband part of a falling ratio, plus the
        # unconditional relax leak
        dead = torch.clamp(err + deadband, max=0.0)
        annealed = torch.clamp(c.loglam + gain_down * dead - relax, lo, hi)
        loglam = torch.where(pulse, hi32, torch.where(do, annealed, c.loglam))
        hold = torch.where(do, torch.where(pulse, cooldown, torch.clamp(c.hold - 1, min=0)),
                           c.hold).to(_I32)
        return ControllerState(loglam=loglam, fast=fast, slow=slow, seen=seen, hold=hold)

    def stats(c: ControllerState) -> dict:
        # observe() sets hold to exactly ``cooldown`` only on a pulse tick
        return {"lam": c.lam, "hold": c.hold,
                "pulse": (c.hold == cooldown) & (cooldown > 0)}

    return AdaptiveDecay(
        name="loss_ratio", init=init, rate=rate, observe=observe, stats=stats,
        hyper={"lam0": lam0, "lam_min": lam_min, "lam_max": lam_max,
               "fast_alpha": fast_alpha, "slow_alpha": slow_alpha, "fire": fire,
               "gain_down": gain_down, "relax": relax, "cooldown": cooldown,
               "deadband": deadband, "warmup": warmup})
