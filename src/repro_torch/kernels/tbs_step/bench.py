"""Times B1's and B3's wrappers (``repro_torch.kernels.tbs_step.ops``) on the
card at the shapes and maps their callers give them, so that two checkouts
can be compared in one run on one card:

    PYTHONPATH=src python -m repro_torch.kernels.tbs_step.bench
    PYTHONPATH=<other checkout>/src python src/repro_torch/kernels/tbs_step/bench.py

Whichever ``repro_torch`` the path holds is timed (its kernels built in its
own checkout); the timer is always this file's checkout's
(``kernels/_bench.py``). Cases:

  * B1 on the main tick's x f32[2^20, 2] and y f32[2^20] leaves (bcap
    65,536), one wrapper call for both: on a uniform map over cap + bcap
    (``chip_smoke.py``'s phase 2) and on a real tick map, the 25th tick's
    of an R-TBS sampler (n = 2^20 - 1, lam 0.03) fed 24 full batches;
  * B1 on 400-byte rows: f32[2^20, 100] alone at phase 2's shape and map,
    and a naive Bayes tick's x f32[65,536, 100] + y i32 leaves (bcap
    4,096, ``chip_smoke.py``'s phase 5) in one call on a uniform map;
  * B3 on a bank tick's real operands: ``make_bank("rtbs", num_keys=2**20,
    n=64, lam=0.05, bcap=32)`` after 32 ticks of 65,536 Zipf(1.1) keyed
    arrivals (``chip_smoke.py``'s phase 6), its x + y leaves in one call;
    and the same with the touched count cut to 1 and to 8,448 rows;
  * the timer's floor: one ``add_`` on a one-element tensor.

Each device time (``ms``) is the median of ``--reps`` CUDA-event timings
of one wrapper call, with the L2 cache flushed before each and a device
sleep queued ahead so that the events time the device. Each host time
(``host_ms``) is the median wall time of one wrapper call as the host
makes it (its Python, checks and launches), with a device sleep queued
ahead so that no launch waits. Beside each, the device time of each
kernel the call launches (``torch.profiler``, the mean over 5 flushed
calls). Prints one JSON line, with the card's name and power limit."""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path


def _bench_helper():
    """This checkout's ``kernels/_bench.py``, loaded from its file, so that
    the same timer times another checkout's wrappers."""
    path = Path(__file__).resolve().parents[1] / "_bench.py"
    spec = importlib.util.spec_from_file_location("_tbs_step_bench_timer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_tick(torch, g):
    """The main path's leaves and a real tick map: an R-TBS state fed 24
    full batches, then the 25th tick's composed map."""
    from repro_torch.core import prng, rtbs

    n, bcap, lam = (1 << 20) - 1, 65_536, 0.03
    st = rtbs.init({"x": torch.zeros(2, device="cuda"),
                    "y": torch.zeros((), device="cuda")}, n)
    full = torch.full((), bcap, dtype=torch.int64, device="cuda")
    batch = {"x": torch.randn((bcap, 2), generator=g, device="cuda"),
             "y": torch.randn((bcap,), generator=g, device="cuda")}
    for t in range(24):
        st = rtbs.step(prng.key(t), st, batch, full, n=n, lam=lam)
    draws = rtbs.draw_tick(prng.key(24), cap=n + 1, bcap=bcap, device="cuda")
    decay = torch.full((), float(torch.tensor(-lam).exp()), device="cuda")
    src, _, _ = rtbs.tick_map(draws, st.lat.nfull, st.lat.weight, st.total_weight, full,
                              decay, cap=n + 1, bcap=bcap, n=n)
    return st.lat.items, batch, src


def _bank_tick(torch):
    """A bank tick's operands after 32 ticks at the ``chip_smoke.py`` scale."""
    from repro_torch.bank import make_bank
    from repro_torch.bank.bank import _rtbs_tick_map
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.manage import materialize_stream

    K, n, b, bcap, T = 1 << 20, 64, 65_536, 32, 32
    stream = KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.1, flip_every=50)
    batches, bcounts = materialize_stream(stream, T, batch_size=b, fields=("key", "x", "y"))
    bank = make_bank("rtbs", num_keys=K, n=n, lam=0.05, bcap=bcap)
    st = bank.init({"x": torch.zeros(2, device="cuda"), "y": torch.zeros((), device="cuda")})
    for t in range(T):
        st = bank.step(prng.key(t), st, batches["key"][t],
                       {"x": batches["x"][t], "y": batches["y"][t]}, bcounts[t])
    r, src, *_ = _rtbs_tick_map(prng.key(T), st, batches["key"][T - 1], bcounts[T - 1],
                                st.pending * bank.base_rate(st), n=n, bcap=bcap)
    return st.items, {"x": batches["x"][T - 1], "y": batches["y"][T - 1]}, src, r, bcap


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    from repro_torch.kernels.tbs_step import ops

    helper = _bench_helper()
    timer = helper.Timer()
    g = torch.Generator(device="cuda").manual_seed(0)
    res, host, split, info = {}, {}, {}, {}

    def run(name, fn):
        res[name] = timer(fn, args.reps)
        host[name] = timer.host(fn, 50)
        split[name] = timer.kernels(fn)

    items, batch, src = _main_tick(torch, g)
    cap, bcap = src.shape[0], batch["y"].shape[0]
    rnd = torch.randint(0, cap + bcap, (cap,), generator=g, device="cuda", dtype=torch.int32)
    info["main tick map: rows kept"] = int((src == torch.arange(cap, device="cuda")).sum())
    run("B1 x + y, uniform map", lambda: ops.tbs_step_apply(items, batch, rnd))
    run("B1 x + y, a main tick's map", lambda: ops.tbs_step_apply(items, batch, src))
    del items, batch, src
    # 400-byte rows: f32[., 100] at phase 2's shape, and a naive Bayes tick
    wide = torch.randn((cap, 100), generator=g, device="cuda")
    wide_b = torch.randn((bcap, 100), generator=g, device="cuda")
    run("B1 f32[., 100], uniform map", lambda: ops.tbs_step_apply(wide, wide_b, rnd))
    del wide, wide_b, rnd
    ncap, nbcap = 65_536, 4096
    nb = {"x": torch.randn((ncap, 100), generator=g, device="cuda"),
          "y": torch.randint(0, 2, (ncap,), generator=g, device="cuda", dtype=torch.int32)}
    nb_b = {"x": torch.randn((nbcap, 100), generator=g, device="cuda"),
            "y": torch.randint(0, 2, (nbcap,), generator=g, device="cuda", dtype=torch.int32)}
    nsrc = torch.randint(0, ncap + nbcap, (ncap,), generator=g, device="cuda",
                         dtype=torch.int32)
    run("B1 naive Bayes x f32[., 100] + y i32, uniform map",
        lambda: ops.tbs_step_apply(nb, nb_b, nsrc))
    del nb, nb_b, nsrc

    bank_items, payload, bsrc, r, bcap = _bank_tick(torch)
    info["bank tick: ntouched"] = int(r.ntouched)

    def b3():
        ops.tbs_step_apply_banked(bank_items, payload, bsrc, order=r.order, starts=r.starts,
                                  touched=r.touched, ntouched=r.ntouched, bcap=bcap)

    run("B3 x + y, a bank tick", b3)
    # B3's time against the rows it moves: the same operands with the touched
    # count cut to 1 and to 8,448 rows (one row for each group of 16 lanes
    # that 132 SMs hold at once)
    for cut in (1, 8448):
        ntk = torch.full((), min(cut, int(r.ntouched)), dtype=torch.int64, device="cuda")
        run(f"B3 x + y, a bank tick cut to {cut} touched rows",
            lambda ntk=ntk: ops.tbs_step_apply_banked(
                bank_items, payload, bsrc, order=r.order, starts=r.starts,
                touched=r.touched, ntouched=ntk, bcap=bcap))
    # the timer's floor: one PyTorch kernel on 4 bytes, after the same flush
    one = torch.zeros(1, device="cuda")
    res["floor: one add_ on 4 bytes"] = timer(lambda: one.add_(1), args.reps)
    host["floor: one add_ on 4 bytes"] = timer.host(lambda: one.add_(1), 50)
    print(json.dumps({"card": helper.card(), "source": ops.__file__, "ms": res,
                      "host_ms": host, "kernel_ms": split, "info": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
