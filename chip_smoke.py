#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

Drives the port's main path (``repro_torch``: R-TBS sampler + linreg retrain
+ prequential eval through ``make_sampler`` / ``make_model`` /
``materialize_stream`` / ``make_run_loop``) at full state size, after
building every CUDA kernel from ``src/repro_torch/kernels/csrc`` and holding
each against its plain PyTorch version on the card. Imports neither JAX nor
the JAX package. Every check raises on failure; no phase catches its own.

  1. environment: card name and power limit, versions, kernel build time;
  2. kernels B1 (tbs_step_apply), B2 (reservoir_compact) and H1
     (swap_delete) against their plain versions at the main path's shapes,
     with CUDA-event times, the memory bound and, for B1, one
     ``torch.index_select`` as the library yardstick;
  3. the main path at cap = 2^20: branch schedule, W recurrence, launch
     counts, a tick under ``set_sync_debug_mode("error")``, B2 through
     ``materialize_view``, ticks per second and a profiled tick;
  4. the same path at cap = 4096 on the card and on the CPU: bit for bit;
  5. naive_bayes on a 100-word bag-of-words stream;
  6. the ``kernels`` JSON line, the card line, and the result line.

f32 matrix products run in full f32: TF32 is switched off for matmul and
cuDNN before any model code runs.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# spec-sheet device-memory bandwidth (bytes/s) by the name nvidia-smi reports
_HBM = [("H200", 4.8e12, "H200 SXM spec sheet, 4.8 TB/s"),
        ("H100 NVL", 3.9e12, "H100 NVL spec sheet, 3.9 TB/s"),
        ("H100 PCIe", 2.0e12, "H100 PCIe spec sheet, 2.0 TB/s"),
        ("H100", 3.35e12, "H100 SXM spec sheet, 3.35 TB/s")]

N_MAIN, BCAP_MAIN, LAM = 1_048_575, 65_536, 0.03
RETRAIN_EVERY = 4


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_for(name: str):
    for key, bw, label in _HBM:
        if key in name:
            return bw, label
    return 3.35e12, "H100 SXM spec sheet, 3.35 TB/s (card not in table)"


class Timer:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, with the L2
    cache flushed before each (the tick finds its buffers cold). A 5 ms
    device sleep is queued ahead of the first event, so the host has
    enqueued ``fn``'s launches before the device reaches them: the events
    time the device work, not the wrapper's Python."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
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


def max_abs_err(torch, a, b) -> float:
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
def phase_kernels(torch, timer, bw, reps):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.kernels.reservoir_compact import ops as rc_ops, ref as rc_ref
    from repro_torch.kernels.swap_delete import ops as sd_ops, ref as sd_ref
    from repro_torch.kernels.tbs_step import ops as ts_ops, ref as ts_ref

    cap, bcap = N_MAIN + 1, BCAP_MAIN
    g = torch.Generator(device="cuda").manual_seed(0)
    # int32, as rtbs.tick_map hands it to B1 on the main path
    src = torch.randint(0, cap + bcap, (cap,), generator=g, device="cuda",
                        dtype=torch.int32)
    cases = [("f32[.,2]", torch.float32, (2,)), ("f32[.]", torch.float32, ()),
             ("i32[.]", torch.int32, ()), ("bool[.]", torch.bool, ()),
             ("bf16[.]", torch.bfloat16, ()), ("f32[.,100]", torch.float32, (100,))]
    rows = {}
    for name, dt, tail in cases:
        if dt == torch.bool:
            items = torch.rand((cap,) + tail, generator=g, device="cuda") < 0.5
            batch = torch.rand((bcap,) + tail, generator=g, device="cuda") < 0.5
        elif dt == torch.int32:
            items = torch.randint(-2**31, 2**31 - 1, (cap,) + tail, generator=g,
                                  device="cuda", dtype=torch.int32)
            batch = torch.randint(-2**31, 2**31 - 1, (bcap,) + tail, generator=g,
                                  device="cuda", dtype=torch.int32)
        else:
            items = torch.randn((cap,) + tail, generator=g, device="cuda").to(dt)
            batch = torch.randn((bcap,) + tail, generator=g, device="cuda").to(dt)
        got = ts_ops.tbs_step_apply(items, batch, src)
        want = ts_ref.apply_ref(items.reshape(1, cap, -1), batch.reshape(1, bcap, -1),
                                src[None]).reshape(items.shape)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B1 {name} differs from its plain version")
        err = max_abs_err(torch, got, want)
        row_b = items[0].numel() * items.element_size()
        # each output row read once from its source and written once; src read once
        nbytes = 2 * cap * row_b + 4 * cap
        cat = torch.cat([items, batch])
        ms = timer(lambda: ts_ops.tbs_step_apply(items, batch, src), reps)
        plain = timer(lambda: ts_ref.apply_ref(items.reshape(1, cap, -1),
                                               batch.reshape(1, bcap, -1), src[None]),
                      reps)
        lib = timer(lambda: torch.index_select(cat, 0, src), reps)
        bound = nbytes / bw * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                          err=err)
        print(f"[2] B1 tbs_step_apply {name:10s} equal  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  index_select {lib:.4f} ms  bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)")
    # the main path's two leaves: x f32[., 2] and y f32[.]
    b1 = {k: rows["f32[.,2]"][k] + rows["f32[.]"][k]
          for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    b1["err"] = max(rows["f32[.,2]"]["err"], rows["f32[.]"]["err"])

    # B2 at the same cap, scattered mask; the main path's two leaves
    mask = torch.rand((cap,), generator=g, device="cuda") < 0.6
    b2 = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0, err=0.0)
    for name, tail in (("f32[.,2]", (2,)), ("f32[.]", ())):
        items = torch.randn((cap,) + tail, generator=g, device="cuda")
        got, cnt = rc_ops.reservoir_compact(items, mask)
        want, wcnt = rc_ref.compact_ref(items.reshape(cap, -1), mask)
        torch.cuda.synchronize()
        check(int(cnt) == int(wcnt) == int(mask.sum()), "B2 count differs")
        check(torch.equal(got, want.reshape(items.shape)), f"B2 {name} items differ")
        check(torch.equal(got[: int(cnt)], items[mask]), f"B2 {name} != items[mask]")
        b2["err"] = max(b2["err"], max_abs_err(torch, got, want.reshape(items.shape)))
        row_b = items[0].numel() * 4
        nbytes = 2 * cap * row_b + cap + 4
        ms = timer(lambda: rc_ops.reservoir_compact(items, mask), reps)
        plain = timer(lambda: rc_ref.compact_ref(items.reshape(cap, -1), mask), reps)
        b2["ms"] += ms
        b2["plain_ms"] += plain
        b2["bound_ms"] += nbytes / bw * 1e3
        print(f"[2] B2 reservoir_compact {name:10s} items and count exact  kernel "
              f"{ms:.4f} ms  plain {plain:.4f} ms  bound {nbytes / bw * 1e3:.4f} ms")

    # H1 on the stage-1 map's shapes: L = cap, D = bcap words, ~4096 trips
    D = bcap
    bits = torch.randint(0, 2**32, (D + 2,), generator=g, device="cuda")
    k = torch.full((), cap - 1, dtype=torch.int64, device="cuda")
    h1 = {}
    for trips_n in (4096, 32768):
        trips = torch.full((), trips_n, dtype=torch.int64, device="cuda")
        got = sd_ops.swap_delete(cap, trips, k, bits, D)
        ms = timer(lambda: sd_ops.swap_delete(cap, trips, k, bits, D), reps)
        if trips_n == 4096:
            t0 = time.perf_counter()
            want = sd_ref.swap_delete_ref(cap, trips, k, bits, D)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3   # one call: D masked steps
            check(torch.equal(got, want), "H1 differs from its plain version")
            nbytes = 8 * cap + 8 * trips_n + 16
            h1 = dict(ms=ms, plain_ms=plain, library_ms=None,
                      bound_ms=nbytes / bw * 1e3, err=max_abs_err(torch, got, want))
        print(f"[2] H1 swap_delete trips={trips_n:6d} kernel {ms:.4f} ms"
              + (f"  plain {h1['plain_ms']:.1f} ms (one call)  exact"
                 if trips_n == 4096 else ""))
    return {"tbs_step_apply": b1, "reservoir_compact": b2, "swap_delete": h1}


def _branches(W_prev, W_new, C_new, n):
    """Alg. 2 branch of each tick from the host trace."""
    out = []
    for wp, wn, cn in zip(W_prev, W_new, C_new):
        if wp < n:
            out.append("overshoot" if cn == n else "insert")
        else:
            out.append("replace" if wn >= n else "undershoot")
    return out


def _drive_ticks(torch, sampler, model, key, batches, bcounts):
    """The loop's tick body driven tick by tick, recording W_t and C_t."""
    from repro_torch.manage import item_proto, make_manage_step

    tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
    state, params = sampler.init(item_proto(batches)), model.init()
    Ws, Cs = [], []
    for t in range(bcounts.shape[0]):
        state, params, _ = tick(key, t, state, params,
                                {f: v[t] for f, v in batches.items()}, bcounts[t])
        Ws.append(state.total_weight)
        Cs.append(state.lat.weight)
    return state, torch.stack(Ws).cpu().numpy(), torch.stack(Cs).cpu().numpy()


def _check_w(np, Ws, bcounts, lam):
    d = np.float32(math.exp(-lam))
    w = np.float32(0.0)
    for t, b in enumerate(bcounts):
        w = np.float32(d * w) + np.float32(b)
        check(Ws[t] == w, f"tick {t}: W {Ws[t]!r} != d*W + B = {w!r}")


def phase_main(torch, np, kernels):
    """Phase 3: the main path at cap = 2^20 on the card."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler, materialize_view
    from repro_torch.data.streams import LinRegStream, mode_schedule
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    T = 48
    sizes = [BCAP_MAIN if t < 24 else 8192 for t in range(T)]
    t0 = time.perf_counter()
    batches, bcounts = materialize_stream(
        LinRegStream(seed=0), T, batch_size=lambda t: sizes[t], bcap=BCAP_MAIN,
        mode=lambda t: mode_schedule("single", t, start=30, stop=40))
    torch.cuda.synchronize()
    print(f"[3] stream: {T} ticks, {sum(sizes)} items, "
          f"{sum(v.numel() * v.element_size() for v in batches.values()) / 1e6:.1f} MB "
          f"on the card, made in {time.perf_counter() - t0:.2f} s")
    sampler = make_sampler("rtbs", n=N_MAIN, lam=LAM)
    model = make_model("linreg", dim=2)
    key = prng.key(0)
    run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)

    # warm-up on a short prefix (allocator, kernel loading), then the timed run
    run(key, {f: v[:RETRAIN_EVERY] for f, v in batches.items()}, bcounts[:RETRAIN_EVERY])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(key, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    view = materialize_view(sampler.extract(prng.key(99), state))
    torch.cuda.synchronize()
    launches = kernels.launches()
    print(f"[3] main path: {T} ticks in {wall:.3f} s = {T / wall:.2f} ticks/s; "
          f"launches {launches}")
    check(launches["tbs_step_apply"] == 2 * T, "B1 not launched once per leaf per tick")
    check(launches["swap_delete"] >= T, "H1 not launched on every tick")
    check(launches["reservoir_compact"] == 2, "B2 not launched by materialize_view")

    sizes_t = trace["size"].cpu().numpy()
    metrics = trace["metric"].cpu().numpy()
    check(sizes_t.shape == (T,) and (sizes_t <= N_MAIN).all(), "size > n")
    check(np.isfinite(metrics).all(), "non-finite metric")
    check(torch.isfinite(params).all().item(), "non-finite params")

    # the same tick body by hand, for the per-tick W/C trace
    st2, Ws, Cs = _drive_ticks(torch, sampler, model, key, batches, bcounts)
    for a, b in ((st2.lat.items["x"], state.lat.items["x"]),
                 (st2.lat.items["y"], state.lat.items["y"]),
                 (st2.total_weight, state.total_weight)):
        check(torch.equal(a, b), "manage_step by hand != make_run_loop")
    _check_w(np, Ws, sizes, LAM)
    br = _branches(np.concatenate([[0.0], Ws[:-1]]), Ws, Cs, np.float32(N_MAIN))
    counts = {b: br.count(b) for b in ("insert", "overshoot", "replace", "undershoot")}
    print(f"[3] branches per tick: {counts}; sequence {''.join(b[0] for b in br)}")
    for b, c in counts.items():
        check(c > 0, f"branch {b} never taken")
    print(f"[3] W_t = d W_(t-1) + B_t exact on all {T} ticks (f32 on the host); "
          f"final C {float(state.lat.weight):.1f} W {float(state.total_weight):.1f}; "
          f"metric first/last {metrics[0]:.4f}/{metrics[-1]:.4f}")

    # B2 on the final state, checked against the mask
    mask, size = sampler.extract(prng.key(99), state).mask, view.size
    check(int(view.mask.sum()) == int(size) == int(mask.sum()), "view size")
    for f in ("x", "y"):
        check(torch.equal(view.items[f][: int(size)], state.lat.items[f][mask]),
              f"materialized {f} != items[mask]")
        check(not view.items[f][int(size):].any(), f"materialized {f} tail not zero")
    print(f"[3] materialize_view: {int(size)} rows packed, equal to items[mask]")

    # one non-retrain tick with every host sync an error
    from repro_torch.manage import make_manage_step

    tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
    t_free = T  # (T + 1) % 4 != 0: no retrain on this tick
    check((t_free + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
    b_t = {f: v[T - 1] for f, v in batches.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tick(key, t_free, state, params, b_t, bcounts[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(out[0].lat.weight.item() <= N_MAIN, "sync-check tick")
    print("[3] one non-retrain tick ran under set_sync_debug_mode('error'): no host sync")

    # profile one retrain tick
    prof_t = 4 * RETRAIN_EVERY - 1
    s_in = st2
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick(key, prof_t, s_in, params, b_t, bcounts[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(ticks_per_s=T / wall, launches=launches,
                profile=_breakdown(torch, prof, wall_ms))


_SCOPES = ("manage.eval", "manage.sampler_step", "rtbs.tick_map", "rtbs.payload",
           "manage.retrain", "manage.size")


def _breakdown(torch, prof, wall_ms: float) -> dict:
    """Device time of one profiled tick: kernel time summed over the device's
    kernel events, each scope's share (the kernels launched under it), and
    the device's idle share of the tick's wall time."""
    from torch.autograd import DeviceType

    evs = prof.events()
    kern = [e for e in evs
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.device_time_total for e in kern) / 1e3
    res = {"wall_ms": wall_ms, "device_ms": busy, "kernels": len(kern),
           "B1 kernel": sum(e.device_time_total for e in kern
                            if "tbs_step_apply_kernel" in e.name) / 1e3,
           "H1 kernel": sum(e.device_time_total for e in kern
                            if "swap_delete_kernel" in e.name) / 1e3}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in _SCOPES:
            res[e.name] = res.get(e.name, 0.0) + e.device_time_total / 1e3
    print(f"[3] profiled retrain tick: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms in {len(kern)} kernels, idle "
          f"{100 * (1 - busy / wall_ms):.1f} % of the tick")
    for k in ("B1 kernel", "H1 kernel") + _SCOPES:
        v = res.get(k, 0.0)
        print(f"[3]   {k:22s} {v:9.3f} ms  {100 * v / max(busy, 1e-9):5.1f} % "
              f"of device time")
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[3]   top kernel: {name[:70]:70s} {v:8.3f} ms")
    return res


def phase_cpu_parity(torch, np):
    """Phase 4: the same path small, on the card and on the CPU."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T = 4095, 256, 48
    out = {}
    for dev in ("cuda", "cpu"):
        batches, bcounts = materialize_stream(
            LinRegStream(seed=1), T, batch_size=lambda t: bcap if t < 24 else 32,
            bcap=bcap, device=dev)
        run = make_run_loop(make_sampler("rtbs", n=n, lam=LAM, device=dev),
                            make_model("linreg", dim=2, device=dev),
                            retrain_every=RETRAIN_EVERY)
        state, params, trace = run(prng.key(7), batches, bcounts)
        out[dev] = (state, params, trace)
    (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
    for f in ("x", "y"):
        check(torch.equal(sg.lat.items[f].cpu(), sc.lat.items[f]), f"items[{f}] card != CPU")
    check(torch.equal(sg.lat.nfull.cpu(), sc.lat.nfull), "nfull card != CPU")
    check(torch.equal(sg.lat.weight.cpu(), sc.lat.weight), "weight card != CPU")
    check(torch.equal(sg.total_weight.cpu(), sc.total_weight), "W card != CPU")
    check(torch.equal(tg["size"].cpu(), tc["size"]), "trace sizes card != CPU")
    check(torch.allclose(tg["metric"].cpu(), tc["metric"], rtol=1e-4, atol=1e-5),
          "metrics card vs CPU beyond rtol 1e-4")
    dm = float((tg["metric"].cpu() - tc["metric"]).abs().max())
    print(f"[4] cap 4096: card == CPU bit for bit (items, nfull, weight, W, sizes); "
          f"metrics max |diff| {dm:.3g} (rtol 1e-4: f32 sums in another order)")


def phase_nb(torch, np, kernels):
    """Phase 5: a wide payload (100-word counts) with naive_bayes."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import UsenetLikeStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T, vocab = 65_535, 4096, 16, 100
    t0 = time.perf_counter()
    batches, bcounts = materialize_stream(UsenetLikeStream(seed=0, vocab=vocab), T,
                                          batch_size=bcap)
    print(f"[5] usenet-like stream: {T} x {bcap} messages, vocab {vocab}, made in "
          f"{time.perf_counter() - t0:.2f} s")
    sampler = make_sampler("rtbs", n=n, lam=LAM)
    model = make_model("naive_bayes", vocab=vocab)
    run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(prng.key(3), batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check(launches["tbs_step_apply"] == 2 * T, "B1 not once per leaf per tick")
    check(launches["swap_delete"] >= T, "H1 not launched")
    m = trace["metric"].cpu().numpy()
    check(np.isfinite(m).all(), "non-finite NB metric")
    check((trace["size"].cpu().numpy() <= n).all(), "size > n")
    st2, Ws, _ = _drive_ticks(torch, sampler, model, prng.key(3), batches, bcounts)
    _check_w(np, Ws, [bcap] * T, LAM)
    print(f"[5] naive_bayes: {T} ticks in {wall:.3f} s ({T / wall:.2f} ticks/s), "
          f"reservoir {state.lat.items['x'].numel() * 4 / 1e6:.1f} MB, launches "
          f"{launches}, error first/last {m[0]:.3f}/{m[-1]:.3f}, W exact")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 linreg/NB fits
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.kernels import _build

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    bw, bw_label = hbm_for(smi)
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; bound bandwidth: {bw_label}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {src}: {line.strip()}")

    timer = Timer(torch)
    kres = phase_kernels(torch, timer, bw, reps=20)
    main_res = phase_main(torch, np, kernels)
    phase_cpu_parity(torch, np)
    phase_nb(torch, np, kernels)

    where = {"tbs_step_apply": ("src/repro_torch/kernels/csrc/tbs_step.cu",
                                "src/repro/kernels/tbs_step/kernel.py:96"),
             "reservoir_compact": ("src/repro_torch/kernels/csrc/reservoir_compact.cu",
                                   "src/repro/kernels/reservoir_compact/kernel.py:49"),
             "swap_delete": ("src/repro_torch/kernels/csrc/swap_delete.cu",
                             "src/repro/core/latent.py:188")}
    rows = []
    for k, r in kres.items():
        rows.append({"name": k, "route": "cuda", "source": where[k][0],
                     "replaces": where[k][1], "launches": main_res["launches"][k],
                     "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": "bytes",
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
