"""Telemetry sinks: where drained records go (DESIGN.md Sec. 14); a copy of
the JAX package's ``obs/sinks.py``, which uses only the standard library.

A sink consumes one flat JSON-able dict per call. The drain side
(:class:`repro_torch.obs.Telemetry`) batches records at drain boundaries, so
sinks are written for bursts: ``emit`` must be cheap per record and any
buffering is flushed by ``flush``/``close``. Three implementations cover the
launch scripts (JSONL files), interactive runs (stdout), and tests/monitors
(an in-memory ring).
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Iterable, Protocol, runtime_checkable


@runtime_checkable
class Sink(Protocol):
    """The sink contract: ``emit`` one record dict, ``flush`` buffers,
    ``close`` releases resources. Records are flat dicts of JSON-able
    scalars/lists with a ``"kind"`` discriminator (``run`` | ``tick`` |
    ``warning`` | ``query`` | ...)."""

    def emit(self, record: dict) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


_PLAIN = (bool, int, float, str, type(None))


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars, tensors and arrays into plain JSON types."""
    if isinstance(v, _PLAIN):
        return v
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


def as_json_record(record: dict) -> dict:
    # fast path: drained tick records arrive pre-converted (bulk `tolist`
    # in Telemetry._drain_cb) -- skip the rebuild on the loop hot path
    for v in record.values():
        if not isinstance(v, _PLAIN):
            return {k: _jsonable(v) for k, v in record.items()}
    return record


class JsonlSink:
    """One JSON record per line, appended to ``path`` (parent directories
    created). Buffered writes, flushed at drain boundaries by the Telemetry
    driver -- NOT per record."""

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        self._fh.write(json.dumps(as_json_record(record)) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


class StdoutSink:
    """Compact one-line-per-record printing, for interactive runs. ``kinds``
    optionally restricts which record kinds print (e.g. only warnings)."""

    def __init__(self, kinds: Iterable[str] | None = None, prefix: str = "[obs]"):
        self.kinds = frozenset(kinds) if kinds is not None else None
        self.prefix = prefix

    def emit(self, record: dict) -> None:
        if self.kinds is not None and record.get("kind") not in self.kinds:
            return
        print(f"{self.prefix} {json.dumps(as_json_record(record))}", flush=False)

    def flush(self) -> None:
        import sys

        sys.stdout.flush()

    def close(self) -> None:
        self.flush()


class MemorySink:
    """Bounded in-memory ring of records -- the test/monitor sink.

    ``records`` is the live deque (oldest first); :meth:`by_kind` filters.
    """

    def __init__(self, capacity: int | None = None):
        self.records: deque[dict] = deque(maxlen=capacity)

    def emit(self, record: dict) -> None:
        self.records.append(as_json_record(record))

    def by_kind(self, kind: str) -> list[dict]:
        return [r for r in self.records if r.get("kind") == kind]

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
