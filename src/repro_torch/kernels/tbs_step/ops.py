"""Wrappers of the fused TBS-step payload passes: B1 (``tbs_step_apply``),
one two-source row gather per item leaf of one reservoir, and B3
(``tbs_step_apply_banked``), the keyed bank's whole payload pass per leaf,
in place.

On a CUDA tensor each launches its hand-written kernel
(``csrc/tbs_step.cu``, ``csrc/tbs_step_banked.cu``) or raises; there is no
fallback. The plain versions in :mod:`.ref` run only for CPU tensors.
``tbs_step_apply.launches`` and ``tbs_step_apply_banked.launches`` count
kernel launches.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import _common
from . import kernel, ref


def _apply_leaf(leaf: torch.Tensor, bleaf: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    T, cap = src.shape[0], leaf.shape[1]
    flat = leaf.reshape(T, cap, -1)
    bflat = bleaf.reshape(T, bleaf.shape[1], -1)
    if leaf.device.type == "cpu":
        return ref.apply_ref(flat, bflat, src).reshape(leaf.shape)
    _common.check_cuda("tbs_step_apply", leaf, bleaf, src)
    if bleaf.dtype != leaf.dtype:
        raise TypeError(f"tbs_step_apply: items {leaf.dtype} vs batch {bleaf.dtype}")
    items_b = _common.as_bytes(flat)
    batch_b = _common.as_bytes(bflat)
    out = torch.empty((T, src.shape[1], items_b.shape[2]), dtype=torch.uint8,
                      device=leaf.device)
    vec = _common.vector_width(items_b.shape[2], items_b, batch_b, out)
    kernel.apply(items_b, batch_b, src, out, vec)
    tbs_step_apply.launches += 1
    return out.view(leaf.dtype).reshape(leaf.shape)


def tbs_step_apply(items, batch_items, src: torch.Tensor):
    """Apply the composed tick map ``src`` (values in [0, cap + bcap): a
    reservoir row, or ``cap +`` a batch row) to an item pytree. ``src`` is
    [cap] for one reservoir (leaves [cap, ...] / [bcap, ...]) or [T, cap]
    for T stacked reservoirs (leaves [T, cap, ...] / [T, bcap, ...]).
    The kernel reads int32 ``src`` (what :func:`repro_torch.core.rtbs.tick_map`
    emits); another index dtype is cast once here, not once per leaf.
    Returns new leaves; the inputs are not modified."""
    single = src.dim() == 1
    s2 = src.unsqueeze(0) if single else src
    s2 = s2.to(torch.int32).contiguous()

    def one(leaf, bleaf):
        if single:
            return _apply_leaf(leaf.unsqueeze(0), bleaf.unsqueeze(0), s2)[0]
        return _apply_leaf(leaf, bleaf, s2)

    return pytree.tree_map(one, items, batch_items)


tbs_step_apply.launches = 0


def _banked_leaf(leaf: torch.Tensor, pleaf: torch.Tensor, src, order, starts,
                 touched, ntouched, bcap: int) -> None:
    K, cap = leaf.shape[:2]
    b = pleaf.shape[0]
    if (b, cap) != tuple(src.shape) or leaf.shape[2:] != pleaf.shape[1:]:
        raise ValueError(f"tbs_step_apply_banked: bank leaf {tuple(leaf.shape)}, "
                         f"payload leaf {tuple(pleaf.shape)} and src "
                         f"{tuple(src.shape)} do not agree ([K, cap, ...], "
                         f"[b, ...], [b, cap])")
    if not leaf.is_contiguous():
        raise ValueError("tbs_step_apply_banked: the bank leaf must be "
                         "contiguous (it is updated in place)")
    flat = leaf.view(K, cap, -1)
    pflat = pleaf.reshape(b, -1)
    if leaf.device.type == "cpu":
        ref.banked_ref(flat, pflat, src, order, starts, touched, ntouched, bcap)
        return
    _common.check_cuda("tbs_step_apply_banked", leaf, pleaf, src, order, starts,
                       touched, ntouched)
    if pleaf.dtype != leaf.dtype:
        raise TypeError(f"tbs_step_apply_banked: bank {leaf.dtype} vs payload "
                        f"{pleaf.dtype}")
    bank_b = flat.view(torch.uint8) if flat.dtype != torch.uint8 else flat
    pay_b = _common.as_bytes(pflat)
    B = bank_b.shape[2]
    limit = kernel.banked_smem_limit(leaf.device)
    if cap * B > limit:
        raise ValueError(
            f"tbs_step_apply_banked: a key's reservoir is cap * row bytes = "
            f"{cap} * {B} = {cap * B} bytes, past the {limit} bytes of shared "
            f"memory one CTA can stage on this card")
    vec = _common.vector_width(B, bank_b, pay_b)
    kernel.apply_banked(bank_b, pay_b, order, starts, touched, ntouched, src,
                        bcap, vec)
    tbs_step_apply_banked.launches += 1


def tbs_step_apply_banked(bank_items, payload, src: torch.Tensor, *,
                          order: torch.Tensor, starts: torch.Tensor,
                          touched: torch.Tensor, ntouched: torch.Tensor,
                          bcap: int) -> None:
    """The keyed bank's payload pass, IN PLACE on ``bank_items`` (leaves
    [K, cap, ...], contiguous): for each routed row t < ``ntouched``, key
    ``touched[t]``'s reservoir takes the tick map ``src[t]`` ([b, cap],
    values in [0, cap + bcap)) over its own rows and its sub-batch, slot j
    of which is ``payload[order[clip(starts[t] + j, 0, b - 1)]]`` (payload
    leaves [b, ...], the tick's unsorted arrivals). ``order``, ``starts``,
    ``touched`` [b] and ``ntouched`` [] are the routing's; rows past
    ``ntouched`` do nothing. The same function as the JAX bank's
    subbatches -> gather -> ``apply_banked`` -> scatter(mode="drop"), with
    one kernel launch per leaf and the touched count never read on the
    host."""
    i32 = torch.int32
    if src.dim() != 2 or any(a.shape != src.shape[:1] for a in (order, starts, touched)):
        raise ValueError(f"tbs_step_apply_banked: src {tuple(src.shape)} must be "
                         f"[b, cap] and order, starts, touched [b]")
    src = src.to(i32).contiguous()
    order, starts, touched = (a.to(i32).contiguous()
                              for a in (order, starts, touched))
    ntouched = ntouched.to(i32).reshape(())
    pytree.tree_map(lambda leaf, pleaf: _banked_leaf(
        leaf, pleaf, src, order, starts, touched, ntouched, bcap),
        bank_items, payload)


tbs_step_apply_banked.launches = 0
