"""Sharding rules: parameter / activation / cache partition specs for the
production meshes, the port of the JAX package's ``sharding.py`` with its
rules unchanged (so a spec compares 1:1 with JAX's).

Scheme (MaxText-style logical axes, resolved per arch x mesh):
  * TP   = ``model`` axis: attention heads (or head_dim when heads don't
           divide), MLP/expert ff, vocab.
  * FSDP = ``data`` axis: the non-TP weight dim (d_model / expert dims), so
           optimizer state is fully sharded; params are replicated across the
           ``pod`` axis (only gradients cross the NIC).
  * Batch = (``pod``, ``data``) for activations.

Head-sharding fallback chain per arch (q / kv decided together):
  heads-and-heads -> heads-and-replicated-kv (GQA with kv-head replication for
  caches) -> head_dim-and-head_dim -> replicated.

A spec is a :class:`P`: per dim ``None`` (replicated), an axis name, or a
tuple of axis names. The port runs on one card, so nothing here places a
tensor: the dry run (:mod:`repro_torch.launch.dryrun`) reads the specs to
count each leaf's bytes per device (:func:`bytes_per_device`). The port's
layer stacks are lists of per-layer trees, so its specs lack the leading
``None`` of JAX's stacked leaves; the rules are written by rank from the
end and need no change for that. ``torch.utils._pytree``'s key paths carry
``.key`` and ``.idx`` as JAX's do, so the rules read names the same way.
Caches are per-layer dataclasses in the port: :func:`cache_layout` gives
their JAX layout (stacked, as ``convert.*_caches_to_numpy`` lays them out),
which :func:`cache_pspecs` reads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

FSDP, TP, POD = "data", "model", "pod"


class P(tuple):
    """A partition spec: one entry a dim, ``None``, an axis name or a tuple
    of axis names (JAX's ``PartitionSpec``; a tuple of one name is the name,
    as JAX keeps it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    axis_names: tuple
    axis_sizes: dict

    @property
    def tp(self) -> int:
        return self.axis_sizes.get(TP, 1)

    @property
    def fsdp(self) -> int:
        return self.axis_sizes.get(FSDP, 1)

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in (POD, FSDP) if a in self.axis_names)


def mesh_info(mesh) -> MeshInfo:
    """The axes of a :class:`repro_torch.launch.mesh.Mesh`."""
    return MeshInfo(axis_names=tuple(mesh.axis_names),
                    axis_sizes=dict(zip(mesh.axis_names, mesh.shape)))


def head_mode(cfg, tp: int) -> str:
    """'heads' | 'heads_qonly' | 'head_dim' | 'replicate'."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if H and H % tp == 0 and KV % tp == 0:
        return "heads"
    if H and H % tp == 0:
        return "heads_qonly"
    if hd and hd % tp == 0:
        return "head_dim"
    return "replicate"


def _div(n, size):
    return size > 1 and n % size == 0


def param_pspecs(cfg, params_tree, mi: MeshInfo) -> Any:
    """A :class:`P` tree mirroring ``params_tree`` (tensors, meta ones too).
    cfg.fsdp_params=False switches to the inference layout: weights TP-only
    (replicated over data) so decode never re-gathers them per token."""
    tp = mi.tp
    fsdp = mi.fsdp if cfg.fsdp_params else 0
    mode = head_mode(cfg, tp)

    def qspec(shape):  # [L?, D, H, hd]
        lead = (None,) * (len(shape) - 3)
        d_ax = FSDP if _div(shape[-3], fsdp) else None
        if mode in ("heads", "heads_qonly"):
            return P(*lead, d_ax, TP, None)
        if mode == "head_dim":
            return P(*lead, d_ax, None, TP)
        return P(*lead, d_ax, None, None)

    def kvspec(shape):
        lead = (None,) * (len(shape) - 3)
        d_ax = FSDP if _div(shape[-3], fsdp) else None
        if mode == "heads":
            return P(*lead, d_ax, TP, None)
        if mode == "head_dim":
            return P(*lead, d_ax, None, TP)
        return P(*lead, d_ax, None, None)  # heads_qonly: kv replicated over TP

    def ospec(shape):  # [L?, H, hd, D]
        lead = (None,) * (len(shape) - 3)
        d_ax = FSDP if _div(shape[-1], fsdp) else None
        if mode in ("heads", "heads_qonly"):
            return P(*lead, TP, None, d_ax)
        if mode == "head_dim":
            return P(*lead, None, TP, d_ax)
        return P(*lead, None, None, d_ax)

    def rule(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        name = names[-1]
        shape = leaf.shape
        nd = len(shape)

        def dim(i, ax, size_req):
            return ax if _div(shape[i], size_req) else None

        if name == "embed":                       # [V, D]: vocab-parallel
            return P(dim(0, TP, tp), None)
        if name == "unembed":                     # [D, V]
            return P(None, dim(1, TP, tp))
        if name in ("wq",):
            return qspec(shape)
        if name in ("wk", "wv"):
            return kvspec(shape)
        if name == "wo" and "attn" in "".join(names):
            return ospec(shape)
        if name == "router":                      # [L?, D, E]
            return P(*(None,) * (nd - 2), dim(nd - 2, FSDP, fsdp), None)
        if name in ("wg", "wi"):                  # mlp [.., D, F] / moe [.., E, D, F]
            return P(*(None,) * (nd - 2), dim(nd - 2, FSDP, fsdp), dim(nd - 1, TP, tp))
        if name == "wo":                          # mlp/moe [.., F, D]
            return P(*(None,) * (nd - 2), dim(nd - 2, TP, tp), dim(nd - 1, FSDP, fsdp))
        if name == "in_proj":                     # [L?, D, K]
            return P(*(None,) * (nd - 2), dim(nd - 2, FSDP, fsdp), dim(nd - 1, TP, tp))
        if name == "out_proj":                    # [L?, din, D]
            return P(*(None,) * (nd - 2), dim(nd - 2, TP, tp), dim(nd - 1, FSDP, fsdp))
        if name in ("conv_w", "conv_b"):          # [L?, W, C], [L?, C]
            return P(*(None,) * (nd - 1), dim(nd - 1, TP, tp))
        return P(*(None,) * nd)                   # norms, biases, A_log, D, dt_bias

    return pytree.tree_map_with_path(rule, params_tree)


def _ba(mi: MeshInfo, dim: int):
    """Batch axes if the dim divides the total DP width, else replicate
    (long_500k has global_batch=1: batch stays unsharded by design)."""
    width = 1
    for a in mi.batch_axes:
        width *= mi.axis_sizes[a]
    return mi.batch_axes if dim % width == 0 else None


def batch_pspecs(cfg, batch_tree, mi: MeshInfo) -> Any:
    """Inputs: batch dim over (pod, data); everything else replicated."""

    def rule(path, leaf):
        return P(_ba(mi, leaf.shape[0]), *(None,) * (len(leaf.shape) - 1))

    return pytree.tree_map_with_path(rule, batch_tree)


def cache_pspecs(cfg, cache_tree, mi: MeshInfo) -> Any:
    """Decode caches in JAX's layout (:func:`cache_layout`): batch over (pod,
    data); kv-head or head_dim over model; SSM state heads over model.
    Leaves are identified by rank/shape."""
    tp = mi.tp
    mode = head_mode(cfg, tp)
    KV_eff = cfg.num_kv_heads * getattr(cfg, "kv_replication", 1)
    hd = cfg.resolved_head_dim

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        if nd >= 4 and (shape[-2:] == (KV_eff, hd) or shape[-1] == hd):
            # [..., B, T, KV_eff, hd]
            kv_ax = TP if (mode != "head_dim" and _div(shape[-2], tp)) else None
            hd_ax = TP if (mode == "head_dim" and _div(shape[-1], tp)) else None
            return P(*(None,) * (nd - 4), _ba(mi, shape[-4]), None, kv_ax, hd_ax)
        if nd >= 3 and shape[-1] == cfg.ssm_head_dim and shape[-2] == cfg.ssm_state:
            # SSM state [..., B, H, N, P]
            h_ax = TP if _div(shape[-3], tp) else None
            return P(*(None,) * (nd - 4), _ba(mi, shape[-4]), h_ax, None, None)
        if nd >= 2:  # conv cache [..., B, W-1, C] / generic
            c_ax = TP if _div(shape[-1], tp) else None
            if nd >= 3:
                return P(*(None,) * (nd - 3), _ba(mi, shape[-3]), None, c_ax)
            return P(*(None,) * (nd - 2), _ba(mi, shape[-2]), None)
        return P(None)  # lengths [L]

    return pytree.tree_map_with_path(rule, cache_tree)


def logits_pspec(mi: MeshInfo):
    return P(mi.batch_axes, None, TP)


# ---------------------------------------------------------------------------
# the port's own helpers: caches in JAX's layout, bytes per device
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _fields(cache, lead=()) -> dict:
    """One KVCache / SSMCache as ``{field: meta tensor}`` in field order
    (JAX's dataclass order), each with ``lead`` dims in front; a KVCache's
    host-int ``length`` is JAX's int32 (0-d per layer)."""
    out = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        out[f.name] = (_meta(tuple(lead) + tuple(v.shape), v.dtype)
                       if isinstance(v, torch.Tensor) else _meta(lead, torch.int32))
    return out


def _stacked(caches: list) -> dict:
    """Per-layer caches as JAX stacks them: [L] in front of each field."""
    return _fields(caches[0], (len(caches),))


def cache_layout(caches) -> Any:
    """The shapes of the port's decode state in JAX's stacked layout, as
    meta tensors: a transformer's or Mamba2's per-layer list ->
    ``{field: [L, ...]}``, as ``convert.*_caches_to_numpy`` lays it out;
    hybrid ``{"kv": {...} [G, ...], "ssm": {...} [G, attn_every, ...]}``;
    encdec ``{"cross": (k, v) [L, ...], "kv": {...}}``. Keys in JAX's
    (sorted) order, so both trees flatten alike. JAX's unrolled layout (a
    list of layers) holds the same bytes per device leaf for leaf: the specs
    put ``None`` on the layer axis."""
    if isinstance(caches, list):
        return _stacked(caches)
    if "ssm" in caches:            # hybrid
        G, ae = len(caches["ssm"]), len(caches["ssm"][0])
        return {"kv": _stacked(caches["kv"]), "ssm": _fields(caches["ssm"][0][0], (G, ae))}
    cross = caches["cross"]        # encdec
    pairs = tuple(_meta((len(cross),) + tuple(cross[0][i].shape), cross[0][i].dtype)
                  for i in (0, 1))
    return {"cross": pairs, "kv": _stacked(caches["kv"])}


def shard_width(spec, mi: MeshInfo) -> int:
    """How many ways ``spec`` splits a leaf: the product of the sizes of
    every axis it names."""
    n = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n *= mi.axis_sizes[ax]
    return n


def bytes_per_device(leaf, spec, mi: MeshInfo) -> int:
    """The bytes one device holds of ``leaf`` (any tensor, meta too) under
    ``spec``. The rules shard a dim only where its axes divide it, so the
    division is exact."""
    return math.prod(leaf.shape) * leaf.element_size() // shard_width(spec, mi)


def tree_bytes_per_device(tree, specs, mi: MeshInfo) -> int:
    """:func:`bytes_per_device` summed over a tree and its spec tree."""
    leaves = pytree.tree_leaves(tree)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=lambda s: isinstance(s, P))
    return sum(bytes_per_device(t, s, mi) for t, s in zip(leaves, spec_leaves, strict=True))
