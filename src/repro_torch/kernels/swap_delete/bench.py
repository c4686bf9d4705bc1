"""Times H1's wrapper ``repro_torch.kernels.swap_delete.ops.swap_delete`` on
the card at the shapes its callers give it, so that two checkouts can be
compared in one run on one card:

    PYTHONPATH=src python -m repro_torch.kernels.swap_delete.bench
    PYTHONPATH=<other checkout>/src python src/repro_torch/kernels/swap_delete/bench.py

Whichever ``repro_torch`` the path holds is timed (its kernels built in its
own checkout); the timer is always this file's checkout's
(``kernels/_bench.py``). Shapes: the main path's maps, L = 2^20 (stage 1) and
2^20 + 65,536 (overshoot), D = 65,536, k = L - 1, at 0 (a gated call),
4,096, 32,768 and 65,536 trips; and the bank's, 65,536 rows of L = 65 and
97, D = 32, the first 17,344 rows live with up to min(k, D) trips each.
Each time is the median of ``--reps`` CUDA-event timings of one wrapper
call (all its launches, identity copies included), with the L2 cache
flushed before each and a device sleep queued ahead so that the events
time the device. Beside each time, the device time of each kernel the
call launches (``torch.profiler``, the mean over 5 flushed calls). Prints
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
    spec = importlib.util.spec_from_file_location("_swap_delete_bench_timer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    import torch

    from repro_torch.kernels.swap_delete import ops

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    helper = _bench_helper()
    timer = helper.Timer()
    g = torch.Generator(device="cuda").manual_seed(0)
    res, split = {}, {}

    def run(name, fn):
        res[name] = timer(fn, args.reps)
        split[name] = timer.kernels(fn)

    D = 65_536
    bits = torch.randint(0, 2**32, (D + 2,), generator=g, device="cuda")
    for L in (1 << 20, (1 << 20) + D):
        k = torch.tensor(L - 1, device="cuda")
        for n in ((0, 4096, 32_768, 65_536) if L == 1 << 20 else (0,)):
            trips = torch.tensor(n, device="cuda")
            run(f"main L={L} trips={n}", lambda: ops.swap_delete(L, trips, k, bits, D))
    T, Db = 65_536, 32
    live = torch.arange(T, device="cuda") < 17_344
    for L in (65, 97):
        kb = torch.randint(0, L + 1, (T,), generator=g, device="cuda")
        tb = torch.where(live, (torch.rand((T,), generator=g, device="cuda")
                                * (torch.clamp(kb, max=Db) + 1)).long(), 0)
        bb = torch.randint(0, 2**32, (T, Db + 2), generator=g, device="cuda")
        run(f"bank T={T} L={L}", lambda: ops.swap_delete(L, tb, kb, bb, Db))
    print(json.dumps({"card": helper.card(), "source": ops.__file__, "ms": res,
                      "kernel_ms": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
