"""Host-side health monitors over the drained telemetry stream
(DESIGN.md Sec. 14); a copy of the JAX package's ``obs/monitors.py``, which
uses only the standard library.

Each monitor folds one ``kind="tick"`` record at a time and returns zero or
more ``kind="warning"`` records, which the Telemetry driver routes through
the same sinks as the stream itself. Monitors live entirely on the host --
they cost nothing inside the loops and can keep arbitrary rolling
state. The detectors encode the paper's operational claims:

  * :class:`SampleSizeStability` -- R-TBS maximizes expected sample size AND
    sample-size stability (paper Sec. 4/6): conditionally on C_t, |S_t| is
    C_t with the fractional part Bernoulli-realized, so E|S_t| = C_t. The
    monitor compares the rolling mean realized size against the rolling mean
    stored mass and the rolling coefficient of variation against a bound --
    divergence means the realization path is broken or the scheme is being
    driven outside its regime.
  * :class:`InclusionDrift` -- Theorem 4.1 expresses every inclusion
    probability through the decayed total weight W_t, which obeys the exact
    recursion W_t = d_t * W_{t-1} + |B_t|. The monitor re-integrates that
    recursion on the host from the drained per-tick factors and batch sizes
    and compares against the in-loop ``total_weight`` gauge: relative
    divergence is decay-accounting corruption (the normalizer of Thm 4.1's
    inclusion probabilities, so any drift here biases EVERY downstream
    guarantee).
  * :class:`NanAlarm` -- a non-finite prequential metric on a non-empty tick
    (empty ticks legitimately report NaN).
  * :class:`StuckLambda` -- the adaptive controller's stuck-high failure
    mode (repro_torch.decay.adaptive docstring): lambda pinned at the top of its
    clip range for many consecutive adjustments without a fresh pulse.
  * :class:`OverflowAlarm` -- routing/buffer overflow drops observed this
    tick (the bank's per-key ``bcap`` bound discarding arrivals).
"""
from __future__ import annotations

import math
from collections import deque


class Monitor:
    """Base: fold tick records, emit warning dicts. Subclasses implement
    ``observe(record) -> list[dict]``; ``warn(...)`` builds the standard
    warning envelope."""

    name = "monitor"

    def reset(self) -> None:
        pass

    def observe(self, record: dict) -> list[dict]:
        raise NotImplementedError

    def warn(self, record: dict, message: str, **data) -> dict:
        out = {"kind": "warning", "monitor": self.name,
               "t": record.get("t"), "message": message}
        out.update(data)
        return out


class SampleSizeStability(Monitor):
    """Rolling E|S| vs C and coefficient-of-variation check.

    Watches records carrying scalar ``size`` and ``weight`` (the stored
    fractional mass C_eff). Warns when the window's mean |S| deviates from
    the window's mean C by more than ``rtol`` (relative, floored at
    ``atol`` absolute), or when the size CV exceeds ``max_cv`` -- R-TBS
    sample sizes concentrate tightly around C (paper Fig. 5), so a large CV
    flags an unstable realization path.
    """

    name = "sample_size_stability"

    def __init__(self, *, window: int = 32, rtol: float = 0.25,
                 atol: float = 2.0, max_cv: float = 0.5,
                 cooldown: int = 32):
        self.window, self.rtol, self.atol = window, rtol, atol
        self.max_cv, self.cooldown = max_cv, cooldown
        self.reset()

    def reset(self) -> None:
        self.sizes: deque[float] = deque(maxlen=self.window)
        self.weights: deque[float] = deque(maxlen=self.window)
        self._mute = 0

    def observe(self, record: dict) -> list[dict]:
        size, weight = record.get("size"), record.get("weight")
        if not isinstance(size, (int, float)) or weight is None:
            return []
        self.sizes.append(float(size))
        self.weights.append(float(weight))
        if self._mute > 0:
            self._mute -= 1
            return []
        if len(self.sizes) < self.window:
            return []
        ms = sum(self.sizes) / len(self.sizes)
        mw = sum(self.weights) / len(self.weights)
        var = sum((s - ms) ** 2 for s in self.sizes) / len(self.sizes)
        cv = math.sqrt(var) / ms if ms > 0 else 0.0
        out = []
        if abs(ms - mw) > max(self.rtol * max(mw, 1e-9), self.atol):
            out.append(self.warn(
                record, "rolling mean |S| diverged from stored mass C "
                "(E|S_t| = C_t for R-TBS)",
                mean_size=ms, mean_weight=mw, window=self.window,
            ))
        if cv > self.max_cv:
            out.append(self.warn(
                record, "sample-size coefficient of variation above bound",
                cv=cv, mean_size=ms, window=self.window,
            ))
        if out:
            self._mute = self.cooldown
        return out


class InclusionDrift(Monitor):
    """Thm 4.1 self-check: re-integrate W_t = d_t W_{t-1} + |B_t| on the
    host and compare against the in-loop ``total_weight`` gauge.

    For bank telemetry the same recursion runs on the probe key's columns
    (``probe_arrivals`` accumulated against the global factor -- exactly the
    lazy ``pending`` composition the bank defers, so agreement also
    certifies the Thm-4.1 downsample-composition bookkeeping).
    ``warmup`` ticks are consumed before the first comparison (the monitor
    may attach mid-stream after a drain gap).
    """

    name = "inclusion_drift"

    def __init__(self, *, rtol: float = 0.05, warmup: int = 2,
                 cooldown: int = 32):
        self.rtol, self.warmup, self.cooldown = rtol, warmup, cooldown
        self.reset()

    def reset(self) -> None:
        self._w = None
        self._seen = 0
        self._mute = 0

    def observe(self, record: dict) -> list[dict]:
        d = record.get("decay")
        if d is None:
            return []
        probe = "probe_total_weight" in record
        arrivals = record.get("probe_arrivals" if probe else "bcount")
        reported = record.get("probe_total_weight" if probe else
                              "total_weight")
        if arrivals is None or reported is None:
            return []
        if self._w is None:
            # seed the recursion from the loop's own gauge: the monitor can
            # attach at any drain boundary, not just t=0
            self._w = float(reported)
            return []
        self._w = float(d) * self._w + float(arrivals)
        self._seen += 1
        if self._mute > 0:
            self._mute -= 1
            return []
        if self._seen < self.warmup:
            return []
        err = abs(self._w - float(reported)) / max(abs(self._w), 1e-9)
        if err > self.rtol:
            self._mute = self.cooldown
            w = self._w
            self._w = float(reported)  # re-seed so one glitch warns once
            return [self.warn(
                record, "decayed total weight diverged from the Thm 4.1 "
                "recursion W_t = d_t W_{t-1} + |B_t|",
                expected=w, reported=float(reported), rel_err=err,
            )]
        return []


class NanAlarm(Monitor):
    """Non-finite prequential metric while the tick was non-empty."""

    name = "nan_alarm"

    def observe(self, record: dict) -> list[dict]:
        m, b = record.get("metric"), record.get("bcount")
        if m is None:
            return []
        vals = m if isinstance(m, list) else [m]
        bad = any(v is None or not math.isfinite(v) for v in vals)
        if bad and (b is None or b > 0):
            return [self.warn(record, "non-finite metric on non-empty tick",
                              metric=m, bcount=b)]
        return []


class StuckLambda(Monitor):
    """Controller pinned at its upper clip for ``patience`` consecutive
    records with no fresh pulse -- the stuck-high failure mode the
    relaxation leak exists to prevent (repro_torch.decay.adaptive docstring).
    ``lam_max`` (if known) anchors the check; otherwise the running maximum
    observed lambda is used once lambda has actually moved."""

    name = "stuck_lambda"

    def __init__(self, *, patience: int = 64, lam_max: float | None = None,
                 rtol: float = 1e-3):
        self.patience, self.lam_max, self.rtol = patience, lam_max, rtol
        self.reset()

    def reset(self) -> None:
        self._run = 0
        self._lo = math.inf
        self._hi = -math.inf

    def observe(self, record: dict) -> list[dict]:
        lam = record.get("lam")
        if lam is None:
            return []
        lam = float(lam)
        self._lo, self._hi = min(self._lo, lam), max(self._hi, lam)
        top = self.lam_max if self.lam_max is not None else self._hi
        moved = self._hi > self._lo * (1 + self.rtol)
        pinned = lam >= top * (1 - self.rtol) and moved
        if pinned and not record.get("pulse"):
            self._run += 1
        else:
            self._run = 0
        if self._run >= self.patience:
            self._run = 0
            return [self.warn(
                record, "lambda pinned at its upper clip without a fresh "
                "pulse", lam=lam, lam_max=top, patience=self.patience,
            )]
        return []


class OverflowAlarm(Monitor):
    """Routing/buffer overflow drops this tick (items discarded by the
    static per-key ``bcap`` bound)."""

    name = "overflow_alarm"

    def __init__(self, *, cooldown: int = 16):
        self.cooldown = cooldown
        self.reset()

    def reset(self) -> None:
        self._mute = 0

    def observe(self, record: dict) -> list[dict]:
        ov = record.get("overflow")
        if self._mute > 0:
            self._mute -= 1
            return []
        if isinstance(ov, (int, float)) and ov > 0:
            self._mute = self.cooldown
            return [self.warn(record, "overflow drops this tick",
                              overflow=int(ov))]
        return []


def default_monitors(*, lam_max: float | None = None) -> tuple[Monitor, ...]:
    """The standard detector set the launch scripts attach."""
    return (
        SampleSizeStability(),
        InclusionDrift(),
        NanAlarm(),
        StuckLambda(lam_max=lam_max),
        OverflowAlarm(),
    )
