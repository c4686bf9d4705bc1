"""Wrappers of the fused TBS-step payload passes: B1 (``tbs_step_apply``),
the two-source row gather of one reservoir (or T stacked ones), and B3
(``tbs_step_apply_banked``), the keyed bank's whole payload pass, in place.

On a CUDA tensor each launches its hand-written kernel
(``csrc/tbs_step.cu``, ``csrc/tbs_step_banked.cu``) or raises; there is no
fallback. The plain versions in :mod:`.ref` run only for CPU tensors. Each
call is one launch for every item leaf of the pytree (one for each group
of :data:`~.._common.MAX_LEAVES` leaves past that): one a tick on the main
path and one a bank tick. ``tbs_step_apply.launches`` and
``tbs_step_apply_banked.launches`` count kernel launches.

:func:`check_leaves` and :func:`plan` (from :mod:`.._common`, shared with
B2's wrapper) are the wrappers' host-side decisions as pure functions:
which leaves agree, and how they are grouped into leaf tables with which
copy widths.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import _common
from .._common import check_leaves, plan
from . import kernel, ref


def tbs_step_apply(items, batch_items, src: torch.Tensor):
    """Apply the composed tick map ``src`` (values in [0, cap + bcap): a
    reservoir row, or ``cap +`` a batch row) to an item pytree. ``src`` is
    [rows] for one reservoir (leaves [cap, ...] / [bcap, ...]) or [T, rows]
    for T stacked reservoirs (leaves [T, cap, ...] / [T, bcap, ...]).
    The kernel reads int32 ``src`` (what :func:`repro_torch.core.rtbs.tick_map`
    emits); another index dtype is cast once here. One launch for every
    leaf. Returns new leaves; the inputs are not modified."""
    single = src.dim() == 1
    s2 = (src.unsqueeze(0) if single else src).to(torch.int32).contiguous()
    leaves, spec = pytree.tree_flatten(items)
    bleaves, bspec = pytree.tree_flatten(batch_items)
    if spec != bspec:
        raise ValueError(f"tbs_step_apply: items {spec} and batch {bspec} differ")
    if not leaves:
        return items
    T, rows = s2.shape
    k = 0 if single else 1                      # the cap's dim in a leaf
    cap = leaves[0].shape[k] if leaves[0].dim() > k else -1
    bcap = bleaves[0].shape[k] if bleaves[0].dim() > k else -1
    lead, blead, olead = ((cap,), (bcap,), (rows,)) if single else ((T, cap), (T, bcap),
                                                                  (T, rows))
    row_bytes = check_leaves("tbs_step_apply", leaves, bleaves, lead, blead)
    if leaves[0].device.type == "cpu":
        dims = [rb // x.element_size() for x, rb in zip(leaves, row_bytes)]
        outs = [ref.apply_ref(x.reshape(T, cap, d), bx.reshape(T, bcap, d), s2)
                .reshape(olead + x.shape[k + 1:]) for x, bx, d in zip(leaves, bleaves, dims)]
        return pytree.tree_unflatten(outs, spec)
    _common.check_cuda("tbs_step_apply", s2, *leaves, *bleaves)
    # the kernel reads and writes raw bytes: contiguous leaves, the outputs
    # made in the leaves' own dtypes and shapes
    ib = [x.contiguous() for x in leaves]
    bb = [x.contiguous() for x in bleaves]
    outs = [torch.empty(olead + x.shape[k + 1:], dtype=x.dtype, device=s2.device)
            for x in leaves]
    groups = plan(row_bytes, [(a.data_ptr(), b.data_ptr(), o.data_ptr())
                              for a, b, o in zip(ib, bb, outs)])
    if T and rows:
        for g in groups:
            kernel.apply([ib[i] for i, _ in g], [bb[i] for i, _ in g], [outs[i] for i, _ in g],
                         [row_bytes[i] for i, _ in g], [v for _, v in g], s2, cap, bcap)
            tbs_step_apply.launches += 1
    return pytree.tree_unflatten(outs, spec)


tbs_step_apply.launches = 0


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
    ``touched`` [b] and ``ntouched`` [] are the routing's (read as int64,
    its own type, ``src`` as int32, the tick map's); rows past
    ``ntouched`` do nothing. The same function as the JAX bank's
    subbatches -> gather -> ``apply_banked`` -> scatter(mode="drop"), with
    one kernel launch for every leaf, only the slots of
    :func:`ref.banked_write_mask` written, and the touched count never read
    on the host."""
    if src.dim() != 2 or any(a.shape != src.shape[:1] for a in (order, starts, touched)):
        raise ValueError(f"tbs_step_apply_banked: src {tuple(src.shape)} must be "
                         f"[b, cap] and order, starts, touched [b]")
    leaves, spec = pytree.tree_flatten(bank_items)
    pleaves, pspec = pytree.tree_flatten(payload)
    if spec != pspec:
        raise ValueError(f"tbs_step_apply_banked: bank {spec} and payload {pspec} differ")
    if not leaves:
        return
    b, cap = src.shape
    K = leaves[0].shape[0] if leaves[0].dim() else -1
    row_bytes = check_leaves("tbs_step_apply_banked", leaves, pleaves, (K, cap), (b,))
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("tbs_step_apply_banked: the bank leaves must be "
                         "contiguous (they are updated in place)")
    # the kernel reads the routing's int64 and the tick map's int32 as they
    # are: no cast kernel on the tick's path
    src = src.to(torch.int32).contiguous()
    order, starts, touched = (a.to(torch.int64).contiguous() for a in (order, starts, touched))
    ntouched = ntouched.to(torch.int64).reshape(())
    dims = [rb // x.element_size() for x, rb in zip(leaves, row_bytes)]
    if leaves[0].device.type == "cpu":
        for x, p, d in zip(leaves, pleaves, dims):
            ref.banked_ref(x.view(K, cap, d), p.reshape(b, d), src, order, starts,
                           touched, ntouched, bcap)
        return
    _common.check_cuda("tbs_step_apply_banked", src, order, starts, touched, ntouched,
                       *leaves, *pleaves)
    if max(K, b) >= 2**31:
        raise ValueError(f"tbs_step_apply_banked: K = {K} and b = {b} must be below 2^31 "
                         f"(the kernel holds keys and routed rows in 32 bits)")
    bank_b = [x.view(K, cap, d).view(torch.uint8) for x, d in zip(leaves, dims)]
    pay_b = [_common.as_bytes(p.reshape(b, d)) for p, d in zip(pleaves, dims)]
    groups = plan(row_bytes, [(x.data_ptr(), p.data_ptr()) for x, p in zip(bank_b, pay_b)])
    if cap > kernel.WARP_CAP and groups:
        limit = kernel.banked_smem_limit(src.device)
        widest = max(row_bytes)
        if cap * widest > limit:
            raise ValueError(
                f"tbs_step_apply_banked: a key's reservoir is cap * row bytes = "
                f"{cap} * {widest} = {cap * widest} bytes, past the {limit} bytes of "
                f"shared memory one CTA can stage on this card (caps past "
                f"{kernel.WARP_CAP} are staged)")
    if not (b and cap):
        return
    for g in groups:
        kernel.apply_banked([bank_b[i] for i, _ in g], [pay_b[i] for i, _ in g],
                            [v for _, v in g], order, starts, touched,
                            ntouched, src, bcap)
        tbs_step_apply_banked.launches += 1


tbs_step_apply_banked.launches = 0
