"""Times B2's wrapper (``repro_torch.kernels.reservoir_compact``) on the card
at the shapes and masks its callers give it, so that two checkouts can be
compared in one run on one card:

    PYTHONPATH=src python -m repro_torch.kernels.reservoir_compact.bench
    PYTHONPATH=<other checkout>/src python src/repro_torch/kernels/reservoir_compact/bench.py

Whichever ``repro_torch`` the path holds is timed (its kernels built in its
own checkout); the timer is always this file's checkout's
(``kernels/_bench.py``). The sample's x + y leaves go through
``core.latent.compact_items``, the call ``materialize_view`` makes. Cases,
at the main path's x f32[2^20 + 1, 2] + y f32[2^20 + 1] unless named:

  * (a) a uniform mask, p = 0.6 (``chip_smoke.py``'s phase 2);
  * (b) a prefix mask: ``core.latent.realize`` of a sample of weight
    0.6 cap + 0.5, the local schemes' realized sample;
  * (c) a block-sparse mask: 8 shard prefixes of cap / 8 slots, each 15 to
    35 % full, as D-T-TBS's global view all-gathers them;
  * (d) f32[2^20, 100] alone (naive Bayes' 400-byte rows) on (a)'s mask;
  * (e) the edges p = 0 and p = 1;
  * no leaves on (a)'s mask: the count alone, i.e. the launch, the mask
    read, the grid barrier and the span-count sums without a row moved
    (a wrapper that takes a tree only);
  * ``items[mask]`` on x and y for (a)-(c) and on (d): the packed rows only
    (no zero tail, no device count), with its host sync;
  * a ``copy_`` of as many bytes as (a)'s bound counts (half read, half
    written): what moving them takes under the same timer;
  * the timer's floor: one ``add_`` on a one-element tensor;
  * probes of what any one-launch design pays on B2's grid (2 CTAs of 512
    threads an SM, the kernel's resident grid): an empty kernel launched
    plainly and cooperatively, and a cooperative kernel that only runs
    ``this_grid().sync()``. They are built from :data:`PROBES` by ``nvcc``
    under ``build/repro_torch/b2_probes/`` and are the same for every
    checkout.

Each device time (``ms``) is the median of ``--reps`` CUDA-event timings
of one call, with the L2 cache flushed before each and a device sleep
queued ahead so that the events time the device. Each host time
(``host_ms``) is the median wall time of one call as the host makes it,
with a device sleep queued ahead so that no launch waits. Beside each,
the device time of each kernel the call launches (``torch.profiler``, the
mean over 5 flushed calls) and the byte bound (:func:`bound_bytes`). Prints
one JSON line, with the card's name and power limit."""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

CAP = (1 << 20) + 1
SHARDS = 8

PROBES = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512, 2) probe_empty() {}
__global__ void __launch_bounds__(512, 2) probe_sync() { cooperative_groups::this_grid().sync(); }
// which: 0 the empty kernel, plain; 1 the empty kernel, cooperative; 2 the barrier alone
extern "C" int probe(int blocks, int which, void* stream) {
  void* args[1] = {nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    probe_empty<<<blocks, 512, 0, st>>>();
    return (int)cudaGetLastError();
  }
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(which == 1 ? probe_empty : probe_sync), dim3(blocks),
      dim3(512), args, 0, st);
}
"""


def case_mask(kind: str, cap: int, g: torch.Generator) -> torch.Tensor:
    """A mask [cap] bool of one of the callers' kinds (see the module
    docstring), drawn from ``g`` on its device."""
    dev = g.device
    if kind in ("none", "all"):
        return torch.full((cap,), kind == "all", dtype=torch.bool, device=dev)
    if kind == "uniform":
        return torch.rand((cap,), generator=g, device=dev) < 0.6
    if kind == "prefix":
        from repro_torch.core import latent

        lat = latent.Latent(items=torch.zeros((cap,), device=dev),
                            nfull=torch.zeros((), dtype=torch.int64, device=dev),
                            weight=torch.tensor(0.6 * cap + 0.5, device=dev))
        return latent.realize(torch.rand((), generator=g, device=dev), lat)[0]
    if kind == "block":
        m = -(-cap // SHARDS)
        fill = (m * (0.15 + 0.2 * torch.rand((SHARDS,), generator=g, device=dev))).long()
        slot = torch.arange(cap, device=dev)
        return slot % m < fill[slot // m]
    raise ValueError(f"case_mask: unknown kind {kind!r}")


def bound_bytes(row_bytes: list[int], mask: torch.Tensor) -> int:
    """The bytes a compaction of leaves of ``row_bytes`` against ``mask``
    must move: the mask read once; of each leaf, every 32-byte sector that
    holds a kept row read once (the sectors this mask needs; a uniform
    mask over rows of 4 or 8 bytes needs nearly all), and its whole output
    written once (kept rows and zero tail). Syncs the host."""
    cap = mask.shape[0]
    kept = mask.nonzero().squeeze(1)
    total = cap
    for rb in row_bytes:
        nsec = -(-cap * rb // 32)
        diff = torch.zeros((nsec + 1,), dtype=torch.int64, device=mask.device)
        one = torch.ones_like(kept)
        diff.index_add_(0, kept * rb // 32, one)
        diff.index_add_(0, ((kept + 1) * rb - 1) // 32 + 1, -one)
        read = int((diff.cumsum(0)[:nsec] > 0).sum()) * 32
        total += min(read, cap * rb) + cap * rb
    return total


def _probes(timer, reps: int) -> dict[str, float]:
    """The probes' device ms (see the module docstring), built from
    :data:`PROBES` into this checkout's ``build/repro_torch/b2_probes/``."""
    root = Path(__file__).resolve().parents[4]
    d = root / "build" / "repro_torch" / "b2_probes"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probes.cu").write_text(PROBES)
    from torch.utils.cpp_extension import CUDA_HOME

    subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"),
                    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(d / "libprobes.so"), str(d / "probes.cu")], check=True)
    fn = ctypes.CDLL(str(d / "libprobes.so")).probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for what, which in (("an empty kernel, plain launch", 0),
                        ("an empty kernel, cooperative launch", 1),
                        ("this_grid().sync() alone, cooperative launch", 2)):
        def call(which=which):
            if fn(blocks, which, stream) != 0:
                raise RuntimeError(f"bench: probe {which} refused at launch")
        out[f"probe: {what}, {blocks} CTAs of 512"] = timer(call, reps)
    return out


def _bench_helper():
    """This checkout's ``kernels/_bench.py``, loaded from its file, so that
    the same timer times another checkout's wrappers."""
    path = Path(__file__).resolve().parents[1] / "_bench.py"
    spec = importlib.util.spec_from_file_location("_reservoir_compact_bench_timer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    from repro_torch.core import latent
    from repro_torch.kernels.reservoir_compact import ops
    from repro_torch.launch import hw

    helper = _bench_helper()
    timer = helper.Timer()
    bw = hw.HBM_BW                                   # H100 SXM spec sheet, 3.35 TB/s
    g = torch.Generator(device="cuda").manual_seed(0)
    res, host, split, bound, info = {}, {}, {}, {}, {}

    def run(name, fn, nbytes=None):
        res[name] = timer(fn, args.reps)
        host[name] = timer.host(fn, 50)
        split[name] = timer.kernels(fn)
        if nbytes is not None:
            bound[name] = nbytes / bw * 1e3

    items = {"x": torch.randn((CAP, 2), generator=g, device="cuda"),
             "y": torch.randn((CAP,), generator=g, device="cuda")}
    masks = {k: case_mask(k, CAP, g) for k in ("uniform", "prefix", "block", "none", "all")}
    for kind, label in (("uniform", "(a) uniform p = 0.6"), ("prefix", "(b) prefix"),
                        ("block", "(c) block-sparse, 8 shard prefixes"),
                        ("none", "(e) p = 0"), ("all", "(e) p = 1")):
        m = masks[kind]
        info[f"{label}: kept rows"] = int(m.sum())
        run(f"B2 x + y, {label}", lambda m=m: latent.compact_items(items, m),
            bound_bytes([8, 4], m))
        if kind in ("uniform", "prefix", "block"):
            res[f"items[mask] x + y, {label}"] = timer(
                lambda m=m: (items["x"][m], items["y"][m]), args.reps)
            host[f"items[mask] x + y, {label}"] = timer.host(
                lambda m=m: (items["x"][m], items["y"][m]), 20)
    try:
        ops.reservoir_compact([], masks["uniform"])
    except AttributeError:      # a wrapper of one tensor, which has no empty call
        pass
    else:
        run("B2 no leaves, (a): the count alone",
            lambda: ops.reservoir_compact([], masks["uniform"]), masks["uniform"].numel() + 4)
    # a copy_ of the bytes of (a)'s bound (a yardstick: what moving them takes
    # under this timer, the L2 flushed ahead)
    half = bound_bytes([8, 4], masks["uniform"]) // 2
    src = torch.empty((half,), dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    res[f"copy_ of {2 * half} bytes, (a)'s bound"] = timer(lambda: dst.copy_(src), args.reps)
    del items, src, dst
    wide = torch.randn((CAP - 1, 100), generator=g, device="cuda")
    m = masks["uniform"][:-1]
    run("B2 (d) f32[2^20, 100], uniform p = 0.6", lambda: ops.reservoir_compact(wide, m),
        bound_bytes([400], m))
    res["items[mask] (d) f32[2^20, 100]"] = timer(lambda: wide[m], args.reps)
    host["items[mask] (d) f32[2^20, 100]"] = timer.host(lambda: wide[m], 20)
    del wide
    # the timer's floor: one PyTorch kernel on 4 bytes, after the same flush
    one = torch.zeros(1, device="cuda")
    res["floor: one add_ on 4 bytes"] = timer(lambda: one.add_(1), args.reps)
    host["floor: one add_ on 4 bytes"] = timer.host(lambda: one.add_(1), 50)
    res.update(_probes(timer, args.reps))
    print(json.dumps({"card": helper.card(), "source": ops.__file__, "ms": res,
                      "host_ms": host, "kernel_ms": split, "bound_ms": bound, "info": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
