"""Carry states and params across from numpy arrays (for example a JAX
state taken with ``np.asarray``) into the port, and back.

An R-TBS state is the item pytree (leaves [cap, ...]), ``nfull``, ``weight``
(the sample weight C) and ``total_weight`` (W). A sharded D-R-TBS state
(JAX's gathered ``DRTBSShard`` snapshot) is the item pytree (leaves [S,
cap_s, ...]), ``nfull`` [S], the replicated ``partial_item`` (leaves [S,
...]), ``weight`` [S], ``total_weight`` [S] and ``overflow`` [S]; a buffer
state (T-TBS, B-TBS, B-RS, SW, and a gathered D-T-TBS snapshot with a
leading [S]) is the item pytree, ``count``, ``total_weight`` and
``overflow``. A bank state is the item
pytree (leaves [K, cap, ...]) and the [K] columns ``nfull``, ``weight``,
``total_weight``, ``pending`` and ``overflow`` (constant-rate schedules
only: their ``dstate`` is None). Adapter params: linreg ``[dim+1]``,
naive_bayes ``(log_prior, log_like)``, knn ``{x, y, valid}``. LM params:
the JAX pytree with its per-layer stacks (``blocks``; hybrid's ``mamba``;
encdec's ``enc`` and ``dec``) on a leading layer axis, to and from the
port's dictionaries with a list of per-layer trees for each (every family
alike; hybrid's ``shared`` block is one tree in both). Decode state: JAX's
stacked ``SSMCache`` (``conv`` [L, B, W-1, conv_dim], ``state`` [L, B, H,
N, P]) and ``KVCache`` (``k``, ``v`` [L, B, T, KV, hd], ``length`` [L]) to
and from the port's per-layer lists of
:class:`~repro_torch.models.ssm.SSMCache` and
:class:`~repro_torch.models.attention.KVCache`; hybrid's (SSM leaves [G,
attn_every, ...], KV leaves [G, ...]) and encdec's (``kv`` and the cross
K/V pair [L, ...]) from those.
AdamW state: ``{"count", "m", "v"}`` with the moments in the LM params'
layout. The SGD adapter's state ``{"opt", "params"}`` and the LM driver's
whole checkpoint tree ``(sgd state, sampler state[, controller state],
tick)`` in JAX's layout (:func:`train_checkpoint_to_numpy`), the tree
``repro_torch.checkpoint`` writes and restores.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.bank import BankState
from repro_torch.core import latent as lt
from repro_torch.core.distributed import DRTBSShard
from repro_torch.core.rtbs import RTBSState
from repro_torch.core.simple import BufferState
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def rtbs_state_from_numpy(items: Any, nfull, weight, total_weight, *,
                          device=None) -> RTBSState:
    dev = _device.resolve(device)
    return RTBSState(
        lat=lt.Latent(items=pytree.tree_map(lambda a: _t(a, dev), items),
                      nfull=_t(nfull, dev, torch.int64),
                      weight=_t(weight, dev, torch.float32)),
        total_weight=_t(total_weight, dev, torch.float32),
    )


def rtbs_state_to_numpy(state: RTBSState) -> dict:
    return {
        "items": pytree.tree_map(lambda a: a.cpu().numpy(), state.lat.items),
        "nfull": state.lat.nfull.cpu().numpy(),
        "weight": state.lat.weight.cpu().numpy(),
        "total_weight": state.total_weight.cpu().numpy(),
    }


def drtbs_state_from_numpy(items: Any, nfull, partial_item: Any, weight, total_weight,
                           overflow, *, device=None) -> DRTBSShard:
    """A gathered D-R-TBS snapshot (JAX's ``gather_tree`` of its
    ``DRTBSShard``, each field read with ``np.asarray``) on the port's
    device."""
    dev = _device.resolve(device)
    leaf = lambda a: _t(a, dev)  # noqa: E731
    return DRTBSShard(items=pytree.tree_map(leaf, items), nfull=_t(nfull, dev, torch.int64),
                      partial_item=pytree.tree_map(leaf, partial_item),
                      weight=_t(weight, dev, torch.float32),
                      total_weight=_t(total_weight, dev, torch.float32),
                      overflow=_t(overflow, dev, torch.int64))


def drtbs_state_to_numpy(state: DRTBSShard) -> dict:
    """The port's D-R-TBS state in JAX's gathered layout, as numpy (int32
    counts, as JAX keeps them)."""
    host = lambda a: a.detach().cpu().numpy().copy()  # noqa: E731
    return {"items": pytree.tree_map(host, state.items),
            "nfull": host(state.nfull).astype(np.int32),
            "partial_item": pytree.tree_map(host, state.partial_item),
            "weight": host(state.weight), "total_weight": host(state.total_weight),
            "overflow": host(state.overflow).astype(np.int32)}


def buffer_state_from_numpy(items: Any, count, total_weight, overflow, *,
                            device=None) -> BufferState:
    """A buffer state (JAX's ``BufferState``, or its gathered D-T-TBS
    snapshot with a leading [S]) on the port's device."""
    dev = _device.resolve(device)
    return BufferState(items=pytree.tree_map(lambda a: _t(a, dev), items),
                       count=_t(count, dev, torch.int64),
                       total_weight=_t(total_weight, dev, torch.float32),
                       overflow=_t(overflow, dev, torch.int64))


def buffer_state_to_numpy(state: BufferState) -> dict:
    host = lambda a: a.detach().cpu().numpy().copy()  # noqa: E731
    return {"items": pytree.tree_map(host, state.items),
            "count": host(state.count).astype(np.int32),
            "total_weight": host(state.total_weight),
            "overflow": host(state.overflow).astype(np.int32)}


def bank_state_from_numpy(items: Any, nfull, weight, total_weight, pending,
                          overflow, *, device=None) -> BankState:
    """A bank state (for example a JAX ``BankState`` of a constant-rate
    bank, each field read with ``np.asarray``) on the port's device."""
    dev = _device.resolve(device)
    return BankState(items=pytree.tree_map(lambda a: _t(a, dev), items),
                     nfull=_t(nfull, dev, torch.int32),
                     weight=_t(weight, dev, torch.float32),
                     total_weight=_t(total_weight, dev, torch.float32),
                     pending=_t(pending, dev, torch.float32),
                     overflow=_t(overflow, dev, torch.int32), dstate=None)


def bank_state_to_numpy(state: BankState) -> dict:
    out = {f: getattr(state, f).cpu().numpy()
           for f in ("nfull", "weight", "total_weight", "pending", "overflow")}
    out["items"] = pytree.tree_map(lambda a: a.cpu().numpy(), state.items)
    return out


def params_from_numpy(model: str, params: Any, *, device=None) -> Any:
    """Adapter params of ``model`` ("linreg", "naive_bayes" or "knn")."""
    dev = _device.resolve(device)
    if model == "linreg":
        return _t(params, dev, torch.float32)
    if model == "naive_bayes":
        return tuple(_t(p, dev, torch.float32) for p in params)
    if model == "knn":
        return {"x": _t(params["x"], dev, torch.float32),
                "y": _t(params["y"], dev, torch.int32),
                "valid": _t(params["valid"], dev, torch.bool)}
    raise ValueError(f"no params conversion for model {model!r}")


def _np_to_torch(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16 (JAX's): same bits
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16).to(device=device, dtype=dtype)
    return _t(a, device, dtype)


def _to_np(t: torch.Tensor) -> np.ndarray:
    """numpy has no bfloat16: bfloat16 comes back as float32 (exactly)."""
    on_cpu = t.device.type == "cpu"
    t = t.detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return a.copy() if on_cpu else a    # a card tensor's .cpu() is already a copy


# the LM trees' per-layer stacks: JAX stacks their leaves on a leading layer
# axis, the port keeps a list of per-layer dicts (transformer and Mamba2
# ``blocks``, hybrid's ``mamba``, encdec's ``enc`` and ``dec``); every other
# entry (hybrid's ``shared`` block too) is one tree in both
_STACKS = ("blocks", "mamba", "enc", "dec")


def lm_params_from_numpy(cfg, tree: dict, *, device=None) -> dict:
    """The JAX LM parameter pytree as numpy (nested dicts; the leaves of
    each stack in ``_STACKS`` on a leading layer axis) -> the port's params
    (each stack a list of per-layer dicts) with the same numbers, in
    ``cfg.param_dtype``, on ``device``."""
    dev = _device.resolve(device)
    pd = getattr(torch, cfg.param_dtype)
    conv = lambda a: _np_to_torch(a, dev, pd)  # noqa: E731
    out = pytree.tree_map(conv, {k: v for k, v in tree.items() if k not in _STACKS})
    for key in _STACKS:
        if key in tree:
            n = np.asarray(pytree.tree_leaves(tree[key])[0]).shape[0]
            out[key] = [pytree.tree_map(lambda a: conv(np.asarray(a)[i]), tree[key])
                        for i in range(n)]
    return out


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params -> the JAX layout as numpy, each stack's leaves
    on a leading layer axis. numpy has no bfloat16, so bfloat16 leaves come
    back as float32, which :func:`lm_params_from_numpy` casts back exactly."""
    return _lm_layout(params, _to_np, np.stack)


def ssm_caches_from_numpy(cfg, conv, state, *, device=None) -> list[SSMCache]:
    """JAX's stacked ``SSMCache`` fields as numpy (``conv`` [L, B, W-1,
    conv_dim], ``state`` [L, B, H, N, P]) -> the port's per-layer list with
    the same numbers, ``conv`` in ``cfg.dtype`` and ``state`` in f32, on
    ``device``."""
    dev = _device.resolve(device)
    conv, state = np.asarray(conv), np.asarray(state)
    dt = getattr(torch, cfg.dtype)
    return [SSMCache(conv=_np_to_torch(conv[i], dev, dt),
                     state=_np_to_torch(state[i], dev, torch.float32))
            for i in range(conv.shape[0])]


def ssm_caches_to_numpy(caches: list[SSMCache]) -> dict:
    """The port's per-layer caches -> ``{"conv", "state"}`` stacked on a
    leading layer axis, as JAX keeps them (bfloat16 comes back as float32,
    as in :func:`lm_params_to_numpy`)."""
    return {"conv": np.stack([_to_np(c.conv) for c in caches]),
            "state": np.stack([_to_np(c.state) for c in caches])}


def _lm_layout(params: dict, leaf, stack) -> dict:
    """The JAX layout of the port's LM params: ``leaf`` maps each tensor,
    ``stack`` each per-layer list of one stacked parameter."""
    out = pytree.tree_map(leaf, {k: v for k, v in params.items() if k not in _STACKS})
    for key in _STACKS:
        if key in params:
            out[key] = pytree.tree_map(lambda *xs: stack([leaf(x) for x in xs]),
                                       *params[key])
    return out


def kv_caches_from_numpy(cfg, k, v, length, *, device=None) -> list[KVCache]:
    """JAX's stacked ``KVCache`` fields as numpy (``k``, ``v`` [L, B, T, KV,
    hd], ``length`` [L]) -> the port's per-layer list, ``k`` and ``v`` in
    ``cfg.dtype``, lengths as host ints."""
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    k, v, length = np.asarray(k), np.asarray(v), np.asarray(length)
    return [KVCache(k=_np_to_torch(k[i], dev, dt), v=_np_to_torch(v[i], dev, dt),
                    length=int(length[i])) for i in range(k.shape[0])]


def kv_caches_to_numpy(caches: list[KVCache]) -> dict:
    """The port's per-layer KV caches -> ``{"k", "v", "length"}`` stacked on
    a leading layer axis (``length`` int32), as JAX keeps them."""
    return {"k": np.stack([_to_np(c.k) for c in caches]),
            "v": np.stack([_to_np(c.v) for c in caches]),
            "length": np.asarray([c.length for c in caches], np.int32)}


def hybrid_caches_from_numpy(cfg, ssm: dict, kv: dict, *, device=None) -> dict:
    """JAX's hybrid decode state as numpy -- ``ssm`` ``{"conv", "state"}``
    with leaves [G, attn_every, B, ...], ``kv`` ``{"k", "v", "length"}``
    with leaves [G, ...] -- -> the port's ``{"ssm": [G][attn_every]
    SSMCache, "kv": [G] KVCache}``."""
    conv, state = np.asarray(ssm["conv"]), np.asarray(ssm["state"])
    return {"ssm": [ssm_caches_from_numpy(cfg, conv[g], state[g], device=device)
                    for g in range(conv.shape[0])],
            "kv": kv_caches_from_numpy(cfg, kv["k"], kv["v"], kv["length"], device=device)}


def hybrid_caches_to_numpy(caches: dict) -> dict:
    """The port's hybrid decode state -> ``{"ssm": {"conv", "state"} [G,
    attn_every, ...], "kv": {"k", "v", "length"} [G, ...]}``, JAX's layout."""
    groups = [ssm_caches_to_numpy(g) for g in caches["ssm"]]
    return {"ssm": {f: np.stack([g[f] for g in groups]) for f in ("conv", "state")},
            "kv": kv_caches_to_numpy(caches["kv"])}


def encdec_caches_from_numpy(cfg, kv: dict, cross, *, device=None) -> dict:
    """JAX's encdec decode state as numpy -- ``kv`` ``{"k", "v", "length"}``
    [L, ...] and ``cross`` a pair (k, v) [L, B, T_enc, KV, hd] -- -> the
    port's ``{"kv": [L] KVCache, "cross": [L] (k, v)}`` in ``cfg.dtype``."""
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    ck, cv = (np.asarray(a) for a in cross)
    return {"kv": kv_caches_from_numpy(cfg, kv["k"], kv["v"], kv["length"], device=dev),
            "cross": [(_np_to_torch(ck[i], dev, dt), _np_to_torch(cv[i], dev, dt))
                      for i in range(ck.shape[0])]}


def encdec_caches_to_numpy(caches: dict) -> dict:
    """The port's encdec decode state -> ``{"kv": {"k", "v", "length"},
    "cross": (k, v)}`` stacked on a leading layer axis, JAX's layout."""
    return {"kv": kv_caches_to_numpy(caches["kv"]),
            "cross": tuple(np.stack([_to_np(c[i]) for c in caches["cross"]])
                           for i in (0, 1))}


def adamw_state_to_numpy(opt: dict) -> dict:
    """AdamW state ``{"count", "m", "v"}`` over LM params -> JAX's layout as
    numpy (``count`` int32 0-d, the moments as :func:`lm_params_to_numpy`)."""
    return {"count": opt["count"].detach().cpu().numpy().astype(np.int32),
            "m": lm_params_to_numpy(opt["m"]), "v": lm_params_to_numpy(opt["v"])}


def adamw_state_from_numpy(cfg, tree: dict, *, device=None) -> dict:
    """JAX's AdamW state over LM params, as numpy -> the port's, on ``device``."""
    dev = _device.resolve(device)
    return {"count": _t(tree["count"], dev, torch.int32),
            "m": lm_params_from_numpy(cfg, tree["m"], device=dev),
            "v": lm_params_from_numpy(cfg, tree["v"], device=dev)}


def sgd_state_to_numpy(state: dict) -> dict:
    """The SGD adapter's LM state ``{"params", "opt"}`` -> JAX's layout as
    numpy (a host copy: later in-place updates cannot reach it)."""
    return {"opt": adamw_state_to_numpy(state["opt"]),
            "params": lm_params_to_numpy(state["params"])}


def sgd_state_from_numpy(cfg, tree: dict, *, device=None) -> dict:
    dev = _device.resolve(device)
    return {"opt": adamw_state_from_numpy(cfg, tree["opt"], device=dev),
            "params": lm_params_from_numpy(cfg, tree["params"], device=dev)}


def _skeleton(state: dict) -> dict:
    """:func:`sgd_state_to_numpy`'s structure with empty placeholder leaves
    (no copy): the ``tree_like`` a restore fills with the stored arrays."""
    hole = lambda *_: np.empty(0)
    return {"opt": {"count": hole(), "m": _lm_layout(state["opt"]["m"], hole, hole),
                    "v": _lm_layout(state["opt"]["v"], hole, hole)},
            "params": _lm_layout(state["params"], hole, hole)}


def train_checkpoint_to_numpy(model_state: dict, sampler_state: Any, cstate: Any,
                              tick: int) -> tuple:
    """The LM driver's checkpoint tree in JAX's layout and leaf order, host
    copies throughout: ``(sgd state, sampler state, controller state, tick)``,
    or without the controller state when ``cstate`` is None, as JAX's
    ``launch/train.py`` saves it."""
    from repro_torch.checkpoint import host_tree

    head = (sgd_state_to_numpy(model_state), host_tree(sampler_state))
    return head + ((host_tree(cstate),) if cstate is not None else ()) + (int(tick),)


def train_checkpoint_like(model_state: dict, sampler_state: Any, cstate: Any) -> tuple:
    """The ``tree_like`` that restores :func:`train_checkpoint_to_numpy`'s
    tree: the sgd state as numpy placeholders (no copy), the sampler and
    controller states as they are (a restore casts to their dtypes and
    devices), a tick."""
    head = (_skeleton(model_state), sampler_state)
    return head + ((cstate,) if cstate is not None else ()) + (0,)


def train_checkpoint_from_numpy(cfg, tree: tuple, *, device=None) -> tuple:
    """A restored driver checkpoint (``restore_checkpoint`` of
    :func:`train_checkpoint_like`) -> ``(model_state, sampler_state,
    cstate | None, tick)`` in the port's layout on ``device``."""
    dev = _device.resolve(device)
    model_state = sgd_state_from_numpy(cfg, tree[0], device=dev)
    cstate = tree[2] if len(tree) == 4 else None
    return model_state, tree[1], cstate, int(tree[-1])
