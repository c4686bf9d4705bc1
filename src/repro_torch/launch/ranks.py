"""Ranks of a ``torch.distributed`` process group: joining one, and starting
one from a parent process.

:func:`init` joins the group from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from
explicit arguments (a ``file://`` init method, as the tests use). Its
device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller asks for
another (``"cpu"``). The backend follows from where the ranks run
(:func:`backend_for`): gloo on the CPU and where this host's ranks
outnumber its cards (NCCL refuses two ranks on one GPU), NCCL otherwise.

:func:`spawn` starts ``world_size`` ranks as child processes of this one,
each running ``python -m repro_torch.launch.ranks`` on a target function
``module:name``, which it calls as ``fn(device, *args)`` once the group is
up. It raises if a rank exits non-zero or the ranks outlive ``timeout``
seconds, and kills every rank it started before it raises. A rank's
collectives time out too (``init``'s ``timeout``), so a rank whose peer
died fails instead of hanging.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --scheme drtbs --shards 4 ...
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import _device

_INIT_ENV = "REPRO_RANKS_INIT"      # spawn's file:// init method, for its ranks


def launched() -> bool:
    """Whether this process is a rank of a launcher (``torchrun`` or
    :func:`spawn`): its environment names a rank and a world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device=None) -> torch.device:
    """``device`` if given, else this rank's card:
    ``cuda:{LOCAL_RANK % device_count}`` (raising without a card)."""
    if device is not None:
        return _device.resolve(device)
    _device.resolve(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                        % torch.cuda.device_count())


def backend_for(dev: torch.device) -> str:
    """gloo for a CPU rank, or when this host's ranks (``LOCAL_WORLD_SIZE``)
    outnumber its cards; NCCL when each rank has a card of its own."""
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def init(*, device=None, init_method: str | None = None, rank: int | None = None,
         world_size: int | None = None, timeout: float = 600.0) -> torch.device:
    """Join the process group (once: a second call returns the device) and
    return this rank's device. Without ``init_method`` the group comes from
    the launcher's environment (``env://``, or :func:`spawn`'s file)."""
    import torch.distributed as dist

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    init_method = init_method or os.environ.get(_INIT_ENV) or "env://"
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(target: str, world_size: int, *, args=(), device: str | None = "cpu",
          timeout: float = 600.0, threads: int | None = 1, path=(),
          log_dir=None) -> None:
    """Run ``target`` (``"module:function"``) on ``world_size`` new ranks,
    ``fn(device, *args)`` on each (``args`` JSON-serializable), and wait for
    them. ``device`` is every rank's (None: each rank's card), ``threads``
    each rank's torch intra-op threads, ``path`` directories put before
    ``PYTHONPATH``. Each rank's output goes to ``log_dir/rank<r>.log`` (a
    temporary directory by default) and is shown in the error when a rank
    fails. Raises ``RuntimeError`` if any rank exits non-zero or the ranks
    run past ``timeout`` seconds; every rank is killed first."""
    logs = Path(log_dir or tempfile.mkdtemp(prefix="ranks_"))
    logs.mkdir(parents=True, exist_ok=True)
    init_file = logs / "init"
    if init_file.exists():
        init_file.unlink()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join([str(p) for p in path]
                                         + [base.get("PYTHONPATH", "")]).strip(os.pathsep)
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")     # every rank is on this host
    spec = json.dumps({"target": target, "args": list(args), "device": device,
                       "threads": threads, "timeout": timeout})
    procs, files = [], []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world_size):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world_size),
                     LOCAL_WORLD_SIZE=str(world_size), **{_INIT_ENV: f"file://{init_file}"})
            f = open(logs / f"rank{r}.log", "w")
            files.append(f)
            procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.launch.ranks",
                                           spec], env=e, stdout=f, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                          + (logs / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes) if c != 0)
        late = " past the timeout" if time.monotonic() > deadline else ""
        raise RuntimeError(f"spawn({target!r}, {world_size}): ranks ended{late} with exit "
                           f"codes {codes}\n{tails}")


def _main(spec: str) -> None:
    spec = json.loads(spec)
    if spec["threads"]:
        torch.set_num_threads(int(spec["threads"]))
    mod, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(mod), name)
    dev = init(device=spec["device"], timeout=spec["timeout"])
    try:
        fn(dev, *spec["args"])
    finally:
        shutdown()


if __name__ == "__main__":
    _main(sys.argv[1])
