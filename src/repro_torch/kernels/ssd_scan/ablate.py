"""B5's ablations: the bf16 tensor-core kernel rebuilt with one part taken
out, timed in turns with the kernel as built, at the Mamba2 prefill's
shape (x bf16 [4, 32768, 32, 64], G 1, N 128, Q 256, x, B and C as views
of the conv output).

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.ablate   # on a card

What a part costs bounds what sharing it across the heads of a group could
save: the B and C loads (TMA multicast over a cluster of heads) and C B^T
(computing it once a group). Each variant is a patched copy of
``csrc/ssd_scan_tc.cu`` built under ``build/repro_torch/``; an ablated
kernel's output is wrong and is not checked. Prints the card, then each
variant's median CUDA-event times in ms, as built first and last (L2
flushed and a device sleep queued ahead of each launch, as
``chip_smoke.py``'s ``Timer`` does).
"""
from __future__ import annotations

import shutil
import statistics
import subprocess

import torch

from .. import _build
from . import ops

ABLATIONS = {
    "without its B and C loads (the most TMA multicast of B and C could save)": (
        """          mbar_expect_tx(full + s, C::STAGE_BYTES);
          for (int cb = 0; cb < NBX; ++cb) {
            tma_load_4d(cs + cb * TILE * 128, &tc, full + s, cb * 64, row, g, b);
            tma_load_4d(cs + C::CB_BYTES + cb * TILE * 128, &tb, full + s, cb * 64, row, g, b);
          }""",
        """          mbar_expect_tx(full + s, C::X_BYTES);"""),
    "without C B^T (the most computing it once a group could save)": (
        """    mma_m64n64k16_ss(sc, smem_desc(ci + (kk / 4) * TILE * 128 + (kk % 4) * 32, 16, 1024, SW128),
                     smem_desc(bj + (kk / 4) * TILE * 128 + (kk % 4) * 32, 16, 1024, SW128),
                     kk > 0);""",
        """    for (int i = kk; i < 32; i += NBX * 4) sc[i] = 1e-3f;"""),
}


def _time(fn, reps: int = 10) -> float:
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def main() -> None:
    B, S, H, G, N, P, Q = 4, 32768, 32, 1, 128, 64, 256
    g = torch.Generator(device="cuda").manual_seed(8)
    buf = torch.nn.functional.silu(
        torch.randn((B, S, H * P + 2 * G * N), generator=g, device="cuda")).bfloat16()
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = buf[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
    a = -torch.ones((H,), device="cuda")

    home = (_build.CSRC, _build.BUILD_DIR)
    src = (home[0] / "ssd_scan_tc.cu").read_text()
    dirs = {"as built": home}
    for i, (what, (old, new)) in enumerate(ABLATIONS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {what!r}: its anchor is not in ssd_scan_tc.cu")
        d = home[1] / f"b5_ablation{i}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(home[0] / "hopper.cuh", d)
        (d / "ssd_scan_tc.cu").write_text(src.replace(old, new))
        dirs[what] = (d, d)
    times = {what: [] for what in dirs}
    try:
        for what in list(dirs) + list(dirs)[::-1]:
            _build.CSRC, _build.BUILD_DIR = dirs[what]
            _build._LIBS.pop("ssd_scan_tc", None)
            times[what].append(_time(lambda: ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)))
    finally:
        _build.CSRC, _build.BUILD_DIR = home
        _build._LIBS.pop("ssd_scan_tc", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    for what, t in times.items():
        print(f"B5 at x bf16 [{B}, {S}, {H}, {P}], Q {Q}, {what}: "
              f"{' / '.join(f'{v:.3f}' for v in t)} ms")


if __name__ == "__main__":
    main()
