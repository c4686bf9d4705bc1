"""Gauge extraction: small closures that read the paper's operational
quantities out of sampler and bank state as device tensors (the JAX
package's ``obs/probe.py``, DESIGN.md Sec. 14).

They run inside the loops' ticks, so they read nothing on the host: each
gauge is a 0-d (or [Q]) tensor on the state's device. The column names
match what :mod:`repro_torch.obs.monitors` consumes (``weight`` = stored
fractional mass C, ``total_weight`` = decayed W, ``probe_*`` = the sampled
tenant's columns for the Thm 4.1 self-check).
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

_F32, _I32 = torch.float32, torch.int32


def tree_nbytes(tree: Any) -> int:
    """Total buffer bytes of a tree's tensors (or of anything with a
    ``shape`` and a ``dtype``): the reservoir-memory gauge."""
    total = 0
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif getattr(leaf, "dtype", None) is not None:
            total += int(math.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return total


def state_nbytes(init: Callable, proto: Any) -> int | None:
    """Reservoir-state bytes of ``init(proto)`` without allocating it: the
    state is built on the ``meta`` device (JAX's ``eval_shape``). None when
    ``init`` cannot run there."""
    meta = pytree.tree_map(lambda a: torch.empty_like(a, device="meta"), proto)
    try:
        return tree_nbytes(init(meta))
    except Exception:
        return None


def static_decay(sampler) -> float | None:
    """The per-tick decay factor d = e^{-lambda} when it is a constant (the
    exponential schedule), else None, as an f32 value, as JAX's telemetry
    rows carry it. Lets rows carry ``decay``, the Thm 4.1 recursion input,
    on loops with no controller."""
    hyper = getattr(sampler, "hyper", None) or {}
    sched = hyper.get("decay")
    rate = getattr(sched, "static_rate", None)
    if rate is None and hyper.get("lam") is not None:
        rate = math.exp(-float(hyper["lam"]))
    return None if rate is None else float(np.float32(rate))


def make_state_stats(sampler=None) -> Callable[[Any], dict]:
    """Build ``stats(state) -> {column: 0-d device tensor}`` by structural
    inspection, covering every scheme family:

      * R-TBS (``RTBSState``): ``weight`` = C (latent mass), ``total_weight``
        = W, ``fill_frac`` = C / n;
      * buffer schemes (``BufferState``: ttbs/btbs/sw/brs): ``weight`` = the
        buffer count, ``overflow_total`` = cumulative capacity drops;
      * time-varying-schedule wrappers (``DecayedState``) are unwrapped.

    Unknown states give an empty dict."""
    hyper = getattr(sampler, "hyper", None) or {}
    n = int(hyper["n"]) if hyper.get("n") else None

    def stats(state: Any) -> dict:
        inner = getattr(state, "inner", None)
        if inner is not None:  # DecayedState wrapper
            state = inner
        row: dict = {}
        lat = getattr(state, "lat", None)
        weight = None
        if lat is not None:
            weight = lat.weight
        elif getattr(state, "weight", None) is not None:
            weight = state.weight
        elif getattr(state, "count", None) is not None:
            weight = state.count
        if weight is not None:
            row["weight"] = weight.to(_F32)
            if n:
                row["fill_frac"] = row["weight"] / float(np.float32(n))
        tw = getattr(state, "total_weight", None)
        if tw is not None:
            row["total_weight"] = tw.to(_F32)
        ov = getattr(state, "overflow", None)
        if isinstance(ov, torch.Tensor) and ov.dim() == 0:
            row["overflow_total"] = ov.to(_I32)
        return row

    return stats


def make_bank_probe_stats(bank, probe_key: int) -> Callable:
    """Build ``stats(state, keys, bcount) -> {probe_*: 0-d tensor}`` for one
    sampled tenant of a :class:`repro_torch.bank.SamplerBank`: the
    bank-level Thm 4.1 self-check columns.

    ``probe_total_weight`` is the key's EFFECTIVE decayed weight
    W_eff = pending * total_weight, ``probe_arrivals`` the key's accepted
    arrivals this tick (clipped to the routing ``bcap``, as the bank's own W
    recursion clips them), ``probe_weight`` the effective stored mass
    C_eff, ``probe_overflow`` the key's cumulative drops. The host monitor
    re-integrates W_eff,t = d_t W_eff,t-1 + a_t against these."""
    pk = int(probe_key)
    if not 0 <= pk < bank.num_keys:
        raise ValueError(f"probe_key must lie in [0, {bank.num_keys}); got {pk}")
    bcap = int(bank.bcap)

    def stats(state, keys: torch.Tensor, bcount) -> dict:
        b = keys.shape[0]
        valid = torch.arange(b, device=keys.device) < bcount
        arrivals = ((keys == pk) & valid).sum()
        w_eff = state.pending[pk] * state.total_weight[pk]
        return {
            "probe_key": pk,
            "probe_arrivals": torch.clamp(arrivals, max=bcap).to(_I32),
            "probe_total_weight": w_eff.to(_F32),
            "probe_weight": torch.minimum(state.weight[pk].to(_F32), w_eff),
            "probe_pending": state.pending[pk].to(_F32),
            "probe_overflow": state.overflow[pk].to(_I32),
        }

    return stats
