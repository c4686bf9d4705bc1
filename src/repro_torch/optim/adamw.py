"""AdamW with decoupled weight decay and global-norm clipping over dicts of
tensors (the JAX package's ``optim/adamw.py``).

The optimizer state is ``{"m", "v", "count"}``: the moments, trees shaped
like the params in their dtype, and an int32 0-d step count, as JAX lays it
out, so a checkpoint carries across (:mod:`repro_torch.convert`). Each
update computes every leaf's arithmetic in f32 in JAX's order through
``torch._foreach_*`` (a few launches for all leaves). Unlike JAX's, it
updates in place: f32 params and moments are overwritten (other dtypes are
computed in f32 and copied back), and the gradients are consumed (scaled in
place). At mamba2_370m's size that keeps the step to the params, gradients,
moments and two temporaries; a caller that keeps an old state copies it
first (:class:`repro_torch.checkpoint.AsyncCheckpointer` takes its host copy
before it returns). The step's scalars (bias corrections, learning rate)
stay on the device, so a step makes no host sync.

Leaves are visited as ``jax.tree_util`` visits them, dict keys sorted
(:func:`sorted_tree`), whatever order a dict's keys were inserted in: the
global norm's sum then has one order for params drawn by ``init_params``
and for the same params restored from a checkpoint, so a resumed run
repeats the unbroken one bit for bit."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def sorted_tree(tree: Any) -> Any:
    """``tree`` with every dict rebuilt in sorted key order (no copies)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sorted_tree(v) for v in tree)
    return tree


def adamw_init(params: Any) -> dict:
    leaf = pytree.tree_leaves(params)[0]
    return {"m": pytree.tree_map(torch.zeros_like, params),
            "v": pytree.tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32; the leaves' sums are
    added in order, as JAX's Python ``sum`` adds them."""
    total = None
    for g in pytree.tree_leaves(sorted_tree(tree)):
        g = g.to(_F32)
        s = torch.sum(torch.square(g))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(lambda g: (g.to(_F32) * scale).to(g.dtype),
                           sorted_tree(grads)), norm


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, lr_scale=1.0):
    """One AdamW step, in place (module docstring). Returns (params,
    opt_state, metrics): the same params and moment tensors, updated, and a
    new count."""
    norm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    count = opt_state["count"] + 1
    cf = count.to(_F32)
    dev = cf.device
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=_F32, device=dev), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=_F32, device=dev), cf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=_F32, device=dev)

    def f32(tree):
        return [x.to(_F32) for x in pytree.tree_leaves(sorted_tree(tree))]

    fe = torch
    g = f32(grads)
    fe._foreach_mul_(g, scale)                       # the clip, JAX's g * scale
    outs = {k: pytree.tree_leaves(sorted_tree(t)) for k, t in
            (("p", params), ("m", opt_state["m"]), ("v", opt_state["v"]))}
    p, m, v = f32(params), f32(opt_state["m"]), f32(opt_state["v"])
    # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    fe._foreach_mul_(m, cfg.b1)
    t = fe._foreach_mul(g, 1 - cfg.b1)
    fe._foreach_add_(m, t)
    fe._foreach_mul_(v, cfg.b2)
    t = fe._foreach_mul(g, 1 - cfg.b2)
    fe._foreach_mul_(t, g)
    fe._foreach_add_(v, t)
    del t, g
    # step = (m / b1c) / (sqrt(v / b2c) + eps) + wd p;  p = p - lr step
    den = fe._foreach_div(v, b2c)
    fe._foreach_sqrt_(den)
    fe._foreach_add_(den, cfg.eps)
    step = fe._foreach_div(m, b1c)
    fe._foreach_div_(step, den)
    del den
    fe._foreach_add_(step, fe._foreach_mul(p, cfg.weight_decay))
    fe._foreach_mul_(step, lr)
    fe._foreach_sub_(p, step)
    del step
    for k, xs in (("p", p), ("m", m), ("v", v)):     # non-f32 leaves: copy back
        for out, x in zip(outs[k], xs):
            if out is not x:
                out.copy_(x)
    return (sorted_tree(params),
            {"m": sorted_tree(opt_state["m"]), "v": sorted_tree(opt_state["v"]),
             "count": count}, {"grad_norm": norm})
