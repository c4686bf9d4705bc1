"""Profiler hooks (the JAX package's ``obs/profile.py``, DESIGN.md Sec. 14):

  * :func:`scope` -- a named range that ``torch.profiler`` attributes host
    and device time to (JAX's ``jax.named_scope`` labels); a no-op while
    no profiler runs, so the hot paths keep their scopes unconditionally.
  * :func:`annotation` -- a host-side range for un-jitted phases (per-tick
    drivers, checkpoint writes); the same range, always recorded.
  * :func:`profile_span` -- bracket a region with ``torch.profiler``
    (CPU and, on a card, CUDA activity) and write its trace under ``dir``
    as a Chrome/Perfetto JSON file (what ``launch/train.py --profile-dir``
    wraps around its first ``--profile-ticks`` ticks).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_OFF = contextlib.nullcontext()


def scope(name: str):
    """A named profiler range around a phase of the loop, the tick or a
    layer; a no-op context while no profiler runs (the LM's decode step
    opens hundreds of them)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def annotation(name: str):
    """Host-side profiler range for un-jitted phases."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_span(dir: str):
    """Capture a profiler trace of the enclosed region into
    ``dir/trace_<pid>_<ns>.json`` and yield the ``torch.profiler.profile``
    (its ``key_averages()`` and ``events()`` stay readable after the span).

    Exceptions inside the region still stop the trace; a failure to START
    the profiler (another one already active) degrades to a no-op span that
    yields False rather than killing the run."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except Exception as e:  # pragma: no cover - depends on runtime state
        print(f"[obs] profiler trace unavailable ({e}); continuing unprofiled")
        yield False
        return
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
