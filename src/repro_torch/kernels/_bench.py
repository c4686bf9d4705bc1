"""Timers shared by ``chip_smoke.py`` and the kernels' ``bench.py`` scripts.

:class:`Timer` times a call on the card three ways: its device time (CUDA
events), the host's wall time to make it (the wrapper's Python and its
launches), and the device time of each kernel it launches (the profiler).
:func:`card` is the card's name and power limit as ``nvidia-smi`` gives
them, :func:`max_sm_clock_mhz` its top SM clock. CUDA only; nothing here runs at import.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    """``nvidia-smi --query-gpu=clocks.max.sm``, first card, in MHz: the
    clock a chain floor of cycles is converted at."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


class Timer:
    """Times ``fn`` (a call that launches work on the current card)."""

    def __init__(self):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int) -> float:
        """Median CUDA-event ms of ``fn`` over ``reps`` calls, with the L2
        cache flushed before each (the tick finds its buffers cold). A
        device sleep is queued ahead of the first event, so the host has
        enqueued ``fn``'s launches before the device reaches them: the
        events time the device work, not the wrapper's Python."""
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(10_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in evs)

    def host(self, fn, reps: int) -> float:
        """Median host wall ms of one call of ``fn``: its Python, checks
        and launches, with a device sleep queued ahead so that no launch
        waits for the device."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000 * reps)     # ~1 ms a call
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(ts)

    def kernels(self, fn, calls: int = 5) -> dict[str, float]:
        """Mean device ms a call of each kernel ``fn`` launches, by name,
        over ``calls`` calls each after an L2 flush (the flush's own kernel
        left out)."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_time_total > 0 and "FillFunctor" not in e.key:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
                out[name] = out.get(name, 0.0) + e.device_time_total / calls / 1e3
        return out
