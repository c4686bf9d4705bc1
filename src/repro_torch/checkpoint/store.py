"""Checkpoint/restart (the JAX package's ``checkpoint/store.py``): params,
optimizer, RNG position, step AND the reservoir (the paper's Sec. 5.1
checkpoints the sample and the system state).

Layout: ``<dir>/step_<n>/`` with ``manifest.json`` (tree structure, shapes,
dtypes) and ``leaves.npz``. Writes go to a temporary directory, then
``os.replace`` publishes it atomically: a crash mid-write never corrupts the
latest checkpoint. :class:`AsyncCheckpointer` writes on a background thread.

Leaves are ordered as ``jax.tree_util`` flattens the same trees: a dict by
its sorted keys, a list or tuple in order, a dataclass by its fields in
declaration order (the port's states are dataclasses with JAX's fields),
None as no leaf, anything else as one leaf. So a checkpoint the JAX package
wrote restores into the port's tree of the same structure, and one the port
wrote restores into JAX's (give the LM's params and moments in the JAX
layout, :func:`repro_torch.convert.sgd_state_to_numpy`). On the way out,
tensors become numpy arrays in the JAX package's 32-bit layout: int64 as
int32 (JAX's default integers), bfloat16 as float32 (exactly; numpy has no
bfloat16). :func:`restore_checkpoint` casts each leaf back to the dtype and
device of the matching leaf of ``tree_like``.

:func:`reshard_reservoir` re-partitions a D-R-TBS reservoir over another
number of shards (numpy, host side)."""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch


def _flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """(leaves in JAX's order, rebuild(leaves) -> a tree of ``tree``'s
    structure)."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(leaves[i:i + len(ls)])
                i += len(ls)
            return out

        return [x for ls, _ in parts for x in ls], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]

        def rebuild(leaves):
            vals, i = [], 0
            for ls, rb in parts:
                vals.append(rb(leaves[i:i + len(ls)]))
                i += len(ls)
            if isinstance(tree, list):
                return vals
            return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)

        return [x for ls, _ in parts for x in ls], rebuild
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        ls, rb = _flatten([getattr(tree, n) for n in names])
        return ls, lambda leaves: type(tree)(**dict(zip(names, rb(leaves))))
    return [tree], lambda leaves: leaves[0]


def _to_numpy(leaf: Any) -> np.ndarray:
    """One leaf on the host, in the JAX package's 32-bit layout: a tensor
    as a copy, anything else as ``np.asarray`` gives it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a   # .cpu() of a card tensor copies
    return np.asarray(leaf)


def _like(arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        arr = arr if arr.flags.writeable else np.array(arr, copy=True)
        return torch.from_numpy(arr).to(device=like.device,
                                                             dtype=like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return arr


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor copied to a numpy array now (what a save
    writes); later in-place updates of the tensors cannot reach it."""
    leaves, rebuild = _flatten(tree)
    return rebuild([_to_numpy(x) for x in leaves])


def save_checkpoint(directory, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically write a checkpoint; prune to the newest ``keep``."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    leaves, _ = _flatten(tree)
    arrays = [_to_numpy(x) for x in leaves]
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "leaves.npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "num_leaves": len(arrays),
        "treedef": f"repro_torch tree of {len(arrays)} leaves in jax.tree_util order",
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    steps = sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                   if p.name.split("_")[1].isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(directory / f"step_{s}", ignore_errors=True)
    return str(final)


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.name.split("_")[1].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(directory, step: int, tree_like: Any) -> Any:
    """Restore into the structure of ``tree_like``: each leaf takes the
    dtype and device of ``tree_like``'s leaf when that is a tensor, the type
    of a Python number, and stays a numpy array otherwise."""
    d = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    like, rebuild = _flatten(tree_like)
    if manifest["num_leaves"] != len(like):
        raise ValueError(f"checkpoint {d} holds {manifest['num_leaves']} leaves; the "
                         f"tree to restore into has {len(like)}")
    with np.load(d / "leaves.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    return rebuild([_like(a, x) for a, x in zip(arrays, like)])


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in flight.

    ``save`` takes its host copy of every leaf before it returns (the
    optimizer and the samplers may update their tensors in place after
    it); the thread only writes files."""

    def __init__(self, directory, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Any):
        self.wait()
        snapshot = host_tree(tree)  # device -> host now

        def work():
            self.last_path = save_checkpoint(self.directory, step, snapshot, keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def reshard_reservoir(items: np.ndarray, nfull: np.ndarray, new_shards: int, cap_s: int):
    """Elastic re-partition of a D-R-TBS reservoir (``items`` [S, cap_old,
    ...], ``nfull`` [S]): gather every valid full item and deal them round
    robin over ``new_shards`` buffers of ``cap_s`` slots. Full items are
    exchangeable, so any deterministic re-partition keeps every inclusion
    probability (Theorem 4.2 is per-item marginal). Returns ``(items
    [new_shards, cap_s, ...], counts [new_shards] int32)``."""
    S_old = items.shape[0]
    rows = [items[s, : int(nfull[s])] for s in range(S_old)]
    allrows = np.concatenate(rows, axis=0) if rows else items[:0, 0]
    out = np.zeros((new_shards, cap_s) + items.shape[2:], items.dtype)
    counts = np.zeros((new_shards,), np.int32)
    for i, row in enumerate(allrows):
        s = i % new_shards
        if counts[s] < cap_s:
            out[s, counts[s]] = row
            counts[s] += 1
    if counts.sum() != len(allrows):
        raise ValueError("elastic reshard overflow: raise cap_s")
    return out, counts
