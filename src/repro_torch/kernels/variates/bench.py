"""Times H3's wrapper ``repro_torch.kernels.variates.ops.hypergeometric`` on
the card at the shapes its callers give it, so that two checkouts can be
compared in one run on one card:

    PYTHONPATH=src python -m repro_torch.kernels.variates.bench
    PYTHONPATH=<other checkout>/src python src/repro_torch/kernels/variates/bench.py

Whichever ``repro_torch`` the path holds is timed (its kernels built in its
own checkout); the timer is always this file's checkout's
(``kernels/_bench.py``). Shapes: B-RS's draw M ~ HyperGeo(C, B, W) at the
main cell (n = 2^20, B = 65,536), u = 0.5, on a saturated tick (C = W =
2^20: 61,652 trips), a late tick (W = 47 B: ~21,800 trips) and a first
tick (W = 0: one trip); and the 65,536-row sweep of
``cases.hypergeometric_rows`` (one launch, the shape of many-row callers).
Each time is the median of ``--reps`` CUDA-event timings of one call, with
the L2 cache flushed before each and a device sleep queued ahead so that
the events time the device. Beside each: its trips (a row's trips are
M - lo + 1, read from the draw; the sweep's are summed, and its longest row
given), and the chain floor, trips x 4 cycles (one dependent f32 add a
trip) at the card's top SM clock: the sweep's is its longest row's. Prints
one JSON line, with the card's name and power limit."""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path


def _bench_helper():
    """This checkout's ``kernels/_bench.py``, loaded from its file, so that
    the same timer times another checkout's wrapper."""
    path = Path(__file__).resolve().parents[1] / "_bench.py"
    spec = importlib.util.spec_from_file_location("_variates_bench_timer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N_BRS, B_BRS = 1 << 20, 65_536


def chain_floor_ms(trips: int, mhz: float) -> float:
    """``trips`` dependent f32 adds of 4 cycles each at ``mhz``: the least
    time one row's ordered chain can take."""
    return trips * 4 / (mhz * 1e3)


def shapes(device):
    """``{name: (u, k, a, b)}``: the three B-RS rows and the sweep."""
    import torch

    from repro_torch.kernels.variates import cases

    def row(C, B, W):
        return (torch.full((1,), 0.5, device=device),
                *(torch.tensor([v], device=device) for v in (C, B, W)))

    return {"saturated": row(N_BRS, B_BRS, N_BRS),
            "late": row(N_BRS, B_BRS, 47 * B_BRS),
            "one_trip": row(B_BRS, B_BRS, 0),
            "sweep": cases.hypergeometric_rows(65_536, device, seed=2)}


def main(argv=None) -> int:
    import torch

    from repro_torch.kernels.variates import cases, ops

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    helper = _bench_helper()
    timer = helper.Timer()
    mhz = helper.max_sm_clock_mhz()
    res, trips, floor, split = {}, {}, {}, {}
    for name, (u, k, a, b) in shapes("cuda").items():
        def fn():
            return ops.hypergeometric(u, k, a, b, cases.H3_TRIPS)

        m = fn()
        t = m - torch.clamp(k - b, min=0) + 1
        trips[name] = {"sum": int(t.sum()), "longest": int(t.max())}
        floor[name] = chain_floor_ms(trips[name]["longest"], mhz)
        res[name] = timer(fn, args.reps)
        split[name] = timer.kernels(fn)
    print(json.dumps({"card": helper.card(), "max_sm_mhz": mhz, "source": ops.__file__,
                      "ms": res, "trips": trips, "chain_floor_ms": floor,
                      "kernel_ms": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
