"""The telemetry driver: rows gathered on the device, drained at period
edges, fanned out on the host (the JAX package's ``obs/telemetry.py``,
DESIGN.md Sec. 14).

A :class:`Telemetry` object is the one handle the manage loops take through
their optional ``telemetry=`` argument. Each tick of an instrumented loop
hands one stats row (a dict of gauges, see :mod:`repro_torch.obs.probe`) to
a :class:`RowDrain`: host values (the tick, the retrain flag) are kept on
the host, device values are written, without a host sync, into one row of
an ``[every, columns]`` f64 device buffer (f64 holds every int32, int64 and
f32 gauge exactly). At each ``every``-tick edge the block is copied, without
blocking, into pinned host memory and a CUDA event marks the copy's end;
blocks whose event has completed are drained whenever the loop next reaches
an edge, and the run's end waits for the rest. So a fast tick never
touches the host. On the host each row becomes one ``kind="tick"``
record, runs through the health monitors (:mod:`repro_torch.obs.monitors`)
and fans out, with any warnings, to the sinks (:mod:`repro_torch.obs.sinks`).

The host side (``open_run``, ``emit``, ``flush``, ``close``, the drain
callback, the monitors and sinks) is a copy of JAX's.
``telemetry=None`` leaves a loop's work exactly as it was.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from .monitors import Monitor
from .sinks import Sink

_F64 = torch.float64


class Telemetry:
    """Telemetry configuration + host-side drain state.

    ``sinks``: where records go; ``every``: the drain period in ticks;
    ``monitors``: host detectors folded over every tick record;
    ``probe_key``: the sampled tenant for bank-level Thm 4.1 self-checks
    (default key 0); ``transport``: kept for the JAX package's signature
    (``"auto"``, ``"callback"`` or ``"fetch"``). Every value drains one
    way here: the event-marked non-blocking copy into pinned memory of the
    module docstring, so records land while the run executes, in tick
    order, as JAX's ``"callback"`` transport lands them.
    """

    def __init__(self, sinks: Iterable[Sink], *, every: int = 64,
                 monitors: Iterable[Monitor] = (),
                 probe_key: int | None = None, transport: str = "auto"):
        if every < 1:
            raise ValueError(f"drain period must be >= 1 tick; got {every}")
        if transport not in ("auto", "callback", "fetch"):
            raise ValueError(
                "transport must be 'auto', 'callback' or 'fetch'; "
                f"got {transport!r}"
            )
        self.sinks = tuple(sinks)
        self.every = int(every)
        self.monitors = tuple(monitors)
        self.probe_key = probe_key
        self.transport = transport
        self.runs = 0
        self.drains = 0
        self.ticks = 0
        self.queries = 0  # serve-path records (kind="query")

    # -- host-side API -----------------------------------------------------
    def open_run(self, meta: dict) -> None:
        """Start-of-run header: reset monitors, emit one ``kind="run"``
        record carrying the run's static facts (scheme, ticks, chunking,
        backend, versions, reservoir-state bytes)."""
        self.runs += 1
        for mon in self.monitors:
            mon.reset()
        self._fan_out({"kind": "run", "run": self.runs, **meta})
        self.flush()

    def _fan_out(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def emit(self, record: dict) -> None:
        """Emit one record directly from host code (per-tick drivers, the
        serve path). ``kind="tick"`` records are folded through the
        monitors; resulting warnings are emitted alongside."""
        if record.get("kind") == "tick":
            self.ticks += 1
            warnings = []
            for mon in self.monitors:
                warnings.extend(mon.observe(record))
            self._fan_out(record)
            for w in warnings:
                self._fan_out(w)
        else:
            if record.get("kind") == "query":
                self.queries += 1
            self._fan_out(record)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def drain(self, device) -> "RowDrain":
        """A :class:`RowDrain` for one run's rows on ``device``."""
        return RowDrain(self, torch.device(device))

    # -- the drain target --------------------------------------------------
    def _drain_cb(self, me: Any, rows: dict) -> None:
        """Consume one drained block: ``rows`` is a dict of stacked column
        arrays (leading dim = ticks in the block). ``me`` is the calling
        shard's index (0 on single-device loops); only shard 0's rows are
        kept. Columns are converted in bulk (``tolist``)."""
        if int(me) != 0:
            return
        self.drains += 1
        cols = {k: np.asarray(v).tolist() for k, v in rows.items()}
        names = ("kind", *cols)
        if self.monitors:
            for vals in zip(*cols.values()):
                self.emit(dict(zip(names, ("tick", *vals))))
        else:  # no monitor fold: skip emit's per-record dispatch
            sinks = self.sinks
            for vals in zip(*cols.values()):
                rec = dict(zip(names, ("tick", *vals)))
                self.ticks += 1
                for s in sinks:
                    s.emit(rec)
        self.flush()


def _kind(v) -> str:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool:
            return "b"
        return "f" if v.is_floating_point() else "i"
    if isinstance(v, (bool, np.bool_)):
        return "b"
    if isinstance(v, (int, np.integer)):
        return "i"
    return "f"


_NP = {"b": np.bool_, "i": np.int64, "f": np.float64}


class RowDrain:
    """One run's stats rows on their way to a :class:`Telemetry` (module
    docstring): ``push`` a row each tick, ``finish`` at the run's end."""

    def __init__(self, telemetry: Telemetry, device: torch.device):
        self.tel = telemetry
        self.device = device
        self.every = telemetry.every
        self._cols = None           # [(name, kind, shape, on_device)]
        self._buf = None            # [every, width] f64 device buffer
        self._host: list = []       # this block's host values, a list per row
        self._i = 0
        self._pending: list = []    # (event | None, rows [n, width] on the host, host rows)

    def push(self, row: dict) -> None:
        """Take one tick's row; its tensors must be on the drain's device."""
        if self._cols is None:
            self._cols = [(k, _kind(v), tuple(v.shape) if isinstance(v, torch.Tensor) else (),
                           isinstance(v, torch.Tensor)) for k, v in row.items()]
            width = sum(int(np.prod(s)) for _, _, s, dev in self._cols if dev)
            self._buf = torch.zeros((self.every, width), dtype=_F64, device=self.device)
        dev_vals = [row[k].reshape(-1).to(_F64) for k, _, _, dev in self._cols if dev]
        if dev_vals:
            self._buf[self._i].copy_(torch.cat(dev_vals))
        self._host.append([row[k] for k, _, _, dev in self._cols if not dev])
        self._i += 1
        if self._i == self.every:
            self._edge()

    def _edge(self) -> None:
        n = self._i
        if self.device.type == "cuda":
            host = torch.empty((n, self._buf.shape[1]), dtype=_F64, pin_memory=True)
            host.copy_(self._buf[:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host, ev = self._buf[:n].clone(), None
        self._pending.append((ev, host, self._host))
        self._host, self._i = [], 0
        self._poll(wait=False)

    def _poll(self, wait: bool) -> None:
        while self._pending:
            ev, host, hrows = self._pending[0]
            if ev is not None and not wait and not ev.query():
                return
            if ev is not None:
                ev.synchronize()
            self._pending.pop(0)
            self.tel._drain_cb(0, self._columns(host.numpy(), hrows))

    def _columns(self, block: np.ndarray, hrows: list) -> dict:
        cols, off, h = {}, 0, 0
        for name, kind, shape, dev in self._cols:
            if dev:
                w = int(np.prod(shape))
                cols[name] = block[:, off:off + w].astype(_NP[kind]).reshape(
                    (block.shape[0],) + shape)
                off += w
            else:
                cols[name] = np.asarray([r[h] for r in hrows], dtype=_NP[kind])
                h += 1
        return cols

    def finish(self) -> None:
        """Drain the partial block and wait for every copy in flight."""
        if self._i:
            self._edge()
        self._poll(wait=True)
        self.tel.flush()


def make_telemetry(dir: str | None = None, *, stdout: bool = False,
                   memory: bool = False, every: int = 64,
                   monitors: Iterable[Monitor] | None = None,
                   probe_key: int | None = None,
                   jsonl_name: str = "telemetry.jsonl") -> Telemetry:
    """Convenience constructor for the launch scripts: JSONL under ``dir``
    and/or stdout and/or an in-memory ring, with the default monitor set
    unless ``monitors`` overrides it."""
    from .monitors import default_monitors
    from .sinks import JsonlSink, MemorySink, StdoutSink

    sinks: list[Sink] = []
    if dir is not None:
        import os

        sinks.append(JsonlSink(os.path.join(dir, jsonl_name)))
    if stdout:
        sinks.append(StdoutSink())
    if memory or not sinks:
        sinks.append(MemorySink())
    mons = default_monitors() if monitors is None else tuple(monitors)
    return Telemetry(sinks, every=every, monitors=mons, probe_key=probe_key)
