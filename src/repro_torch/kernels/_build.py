"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by its
own ``nvcc`` process into ``build/repro_torch/lib<name>.so`` at the root of
the checkout (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/lib<name>.so csrc/<name>.cu

No PyTorch headers are involved, so a build takes seconds. A source may
include the shared headers ``csrc/*.cuh``; a library is rebuilt when its
source or any header is newer. Pointers and the
stream cross the boundary as ``ctypes.c_void_p``; every C entry returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.
:func:`build_all` starts one ``nvcc`` per source at once, so a caller that
needs every kernel (``chip_smoke.py``) pays the longest single build.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every stale kernel source in parallel; returns the compiler
    output (register and shared-memory use from ``-Xptxas=-v``) by name."""
    names = sources() if names is None else names
    procs = {n: _start(n) for n in names if _stale(n)}
    try:
        return {n: _finish(n, p) for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    hit = _LIBS.get(name)
    if hit is None:
        if _stale(name):
            build_all([name])
        hit = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return hit


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# the tensor-core entry points' own codes past cudaError_t's (csrc/hopper.cuh)
TC_NO_ENCODER, TC_ENCODE = 10_000, 20_000


def check_tc(err: int, what: str) -> None:
    """:func:`check` for an entry point that builds TMA tensor maps."""
    if err == TC_NO_ENCODER:
        raise RuntimeError(f"{what}: libcuda has no cuTensorMapEncodeTiled")
    if err >= TC_ENCODE:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a map "
                           f"(CUresult {err - TC_ENCODE})")
    check(err, what)


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
