"""Latent ("fractional") samples, the core data structure of R-TBS (paper
Sec. 4.1), and the Alg. 3 downsample as a slot-index map.

A latent sample L = (A, pi, C) holds floor(C) full items in slots
[0, nfull) and at most one partial item at slot nfull; realizing it includes
the partial item with probability frac(C), so E[|S|] = C.

Port conventions:
  * scalars (``nfull``, ``weight``) are device tensors, never Python numbers,
    so no step syncs to the host; every branch of the paper's algorithm is
    computed and selected with ``torch.where`` (the JAX package's
    ``lax.cond``);
  * every function broadcasts over leading batch dimensions (the trial
    dimension of the statistical tests): scalars ``[...]``, maps
    ``[..., cap]``, item leaves ``[..., cap, ...]``;
  * random draws are operands (:class:`DownsampleDraws`, or
    :class:`ExactDownsampleDraws` for the exact argsort map of the
    reference step; uniforms), made by the ``draw_*`` helpers from a key,
    so tests can feed JAX's draws;
  * maps are int64. JAX's silent index semantics are kept explicitly:
    gathers clamp (:func:`_take`), single-slot scatters drop an index out of
    range (:func:`_set1`), and chained sets keep their order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.reservoir_compact import ops as rc_ops
from repro_torch.kernels.swap_delete import ops as sd_ops

from . import prng, rng

_I64, _F32 = torch.int64, torch.float32


def floor_frac(c: torch.Tensor):
    """(floor(C) as int64, frac(C) in [0, 1]) with float-noise clipping."""
    c = c.to(_F32)
    k = torch.floor(c)
    return k.to(_I64), torch.clamp(c - k, 0.0, 1.0)


def partial_draw(u: torch.Tensor, weight: torch.Tensor):
    """THE fractional-item realization draw from the uniform ``u``:
    (floor(C), take_partial, frac(C)); take_partial is u < frac(C) and
    False when frac == 0."""
    k, f = floor_frac(weight)
    return k, (u < f) & (f > 0), f


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors, rounded once to f32 as a fused
    multiply-add rounds it. The product is exact in f64, and so is the sum
    wherever |a b| >= |c| / 32 for an integer c below 2^24 (the schemes'
    p W + B); elsewhere the sum is rounded to f64 first, which differs from
    one rounding only where it lands exactly on an f32 tie."""
    return (a.double() * b.double() + c.double()).to(_F32)


@dataclasses.dataclass
class Latent:
    """Latent fractional sample; see the module docstring for slots."""

    items: Any             # pytree, leaves [..., cap, ...]
    nfull: torch.Tensor    # int64 [...]
    weight: torch.Tensor   # float32 [...] (C)

    @property
    def cap(self) -> int:
        return pytree.tree_leaves(self.items)[0].shape[self.nfull.dim()]

    def has_partial(self) -> torch.Tensor:
        return floor_frac(self.weight)[1] > 0


pytree.register_dataclass(Latent)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[..., i] for a [..., L] and i [...], clamped into range."""
    L = a.shape[-1]
    return torch.gather(a, -1, i.clamp(0, L - 1).unsqueeze(-1)).squeeze(-1)


def _set1(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a.at[..., i].set(v) for a [..., L], i and v [...]; an index out of
    range is dropped. Returns a new tensor."""
    slot = torch.arange(a.shape[-1], dtype=_I64, device=a.device)
    return torch.where(slot == i.unsqueeze(-1), v.unsqueeze(-1), a)


def gather(items: Any, idx: torch.Tensor) -> Any:
    """Tree-wide items[..., idx, ...] along the slot axis (idx [..., L'])."""
    nb = idx.dim() - 1

    def one(a):
        rest = a.shape[nb + 1:]
        ix = idx.reshape(idx.shape + (1,) * len(rest)).expand(
            idx.shape + rest)
        return torch.gather(a, nb, ix)

    return pytree.tree_map(one, items)


def make_empty(item_proto: Any, cap: int) -> Latent:
    """Empty latent sample with capacity ``cap``; ``item_proto`` is a pytree
    of tensors shaped like ONE item, on the device the sample lives on."""
    leaves = pytree.tree_leaves(item_proto)
    dev = leaves[0].device
    items = pytree.tree_map(
        lambda p: torch.zeros((cap,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device), item_proto)
    return Latent(items=items, nfull=torch.zeros((), dtype=_I64, device=dev),
                  weight=torch.zeros((), dtype=_F32, device=dev))


def realize(u: torch.Tensor, lat: Latent):
    """Draw S from L per paper eq. (2): (mask [..., cap] bool, size int64)."""
    k, take, _ = partial_draw(u, lat.weight)
    slot = torch.arange(lat.cap, dtype=_I64, device=k.device)
    kk = k.unsqueeze(-1)
    mask = (slot < kk) | ((slot == kk) & take.unsqueeze(-1))
    return mask, k + take.to(_I64)


def compact_items(items: Any, mask: torch.Tensor) -> Any:
    """Tree-wide stable pack of the masked rows to the buffer head through
    the reservoir_compact kernel (B2), one launch for every leaf; rows past
    ``mask.sum()`` are zero."""
    return rc_ops.reservoir_compact(items, mask)[0]


def realize_compact(u: torch.Tensor, lat: Latent):
    """Materialize S: the realization mask of :func:`realize` (same uniform)
    and the selected rows packed to the head. Returns ``(items, size)``."""
    mask, size = realize(u, lat)
    return compact_items(lat.items, mask), size


@dataclasses.dataclass
class DownsampleDraws:
    """The draws of one Alg. 3 map: JAX's ``kperm, ku = split(key)`` gives
    ``u = uniform(ku)``, ``rb_full = bits(kperm, (16, 2))`` (the full-domain
    PRP) and ``rb_small = bits(kperm, (D + 2,))`` (the delete-complement
    construction; None when no fast path is requested)."""

    u: torch.Tensor                        # f32 [...]
    rb_full: torch.Tensor                  # int64 [..., rounds, 2]
    rb_small: torch.Tensor | None = None   # int64 [..., D + 2]


def draw_downsample(key, cap: int, device, *,
                    max_deleted: int | None = None, batch=()) -> DownsampleDraws:
    """The draws of one Alg. 3 map with leading dimensions ``batch`` from a
    host key, or, from a key tensor ``[T, 2]`` (``batch`` empty), one row of
    draws per key row: row t equals the host draw of key t."""
    kperm, ku = prng.split(key)
    batch = tuple(batch)
    small = None
    if max_deleted is not None and max_deleted > 0:
        D = min(int(max_deleted), cap)
        small = prng.bits(prng.fold_in(kperm, 1), batch + (D + 2,), device)
    return DownsampleDraws(u=prng.uniform(ku, batch, device),
                           rb_full=rng.draw_son_bits(kperm, batch, device),
                           rb_small=small)


@dataclasses.dataclass
class ExactDownsampleDraws:
    """The draws of one Alg. 3 map with the exact argsort permutation (JAX's
    ``downsample_map(..., exact=True)``): ``kperm, ku = split(key)`` gives
    ``u = uniform(ku)`` and ``u_perm = uniform(kperm, (cap,))``, the
    argsort keys of :func:`repro_torch.core.rng.prefix_permutation`."""

    u: torch.Tensor          # f32 [...]
    u_perm: torch.Tensor     # f32 [..., cap]


def draw_downsample_exact(key, cap: int, device, *, batch=()) -> ExactDownsampleDraws:
    """:class:`ExactDownsampleDraws` with leading dimensions ``batch``."""
    kperm, ku = prng.split(key)
    batch = tuple(batch)
    return ExactDownsampleDraws(u=prng.uniform(ku, batch, device),
                                u_perm=rng.draw_prefix_permutation(kperm, cap, batch, device))


def _downsample_map_small(u, rb, cap: int, k, f, kp, fp, nw, cw, D: int,
                          gate):
    """Delete-complement construction of the Alg. 3 slot map (O(D) random
    work): delete the complement of the survivors by swap-with-last, then
    place the new partial item. The deletion loop runs in the swap_delete
    kernel (H1) with its trip count on the device, set to 0 where ``gate``
    says the result is not used."""
    slot = torch.arange(cap, dtype=_I64, device=u.device)
    identity = slot.expand(k.shape + (cap,))
    safe_c = torch.clamp(cw, min=1e-30)

    def unif(bits, m):
        return bits % torch.clamp(m, min=1)

    unif_full = unif(rb[..., D], k)

    # case kp == 0 (paper Alg. 3 lines 5-8)
    keep_old = u <= f / safe_c
    src_case0 = _set1(identity, torch.zeros_like(k),
                      torch.where(keep_old, k, unif_full))

    # case 0 < kp == k (lines 9-11): swap partial <-> a uniform full
    rho = (1.0 - (nw / safe_c) * f) / torch.clamp(1.0 - fp, min=1e-30)
    do_swap = u > rho
    src_swap = _set1(_set1(identity, unif_full, k), k, unif_full)
    src_case_eq = torch.where(do_swap.unsqueeze(-1), src_swap, identity)

    # case 0 < kp < k (lines 12-18): delete the complement
    p1 = (nw / safe_c) * f
    b1 = u <= p1
    d = torch.where(b1, k - kp, k - kp - 1)
    trips = torch.where((kp > 0) & (kp < k) & gate, d.clamp(0, D), 0)
    src_lt = sd_ops.swap_delete(cap, trips, k, rb, D)
    # branch 2: survivors at [0, kp+1); a uniform one becomes the partial
    j2 = unif(rb[..., D + 1], kp + 1)
    sj2, sk2 = _take(src_lt, j2), _take(src_lt, torch.clamp(kp, max=cap - 1))
    src_b2 = _set1(_set1(src_lt, kp, sj2), j2, sk2)
    # branch 1: survivors at [0, kp); a uniform one becomes the partial, its
    # hole is filled by the last survivor, the old partial lands at kp-1
    kp_m1 = torch.clamp(kp - 1, min=0)
    j1 = unif(rb[..., D + 1], kp)
    sj1, slast = _take(src_lt, j1), _take(src_lt, kp_m1)
    src_b1 = _set1(_set1(_set1(src_lt, kp, sj1), j1, slast), kp_m1, k)
    src_case_lt = torch.where(b1.unsqueeze(-1), src_b1, src_b2)

    src = torch.where((kp == 0).unsqueeze(-1), src_case0,
                      torch.where((kp == k).unsqueeze(-1), src_case_eq,
                                  src_case_lt))
    return torch.where((nw >= cw).unsqueeze(-1), identity, src)


def _downsample_map_full(u, rb, cap: int, k, f, kp, fp, nw, cw):
    """The full-domain construction: one length-``cap`` swap-or-not prefix
    permutation, branch maps selected with torch.where."""
    return _downsample_map_perm(u, rng.prefix_permutation_fast(rb, cap, k), cap, k, f, kp,
                                fp, nw, cw)


def _downsample_map_perm(u, perm, cap: int, k, f, kp, fp, nw, cw):
    """The full-domain construction from a prefix permutation ``perm``
    ``[..., cap]`` of the ``k`` full slots (swap-or-not, or the exact
    argsort one)."""
    slot = torch.arange(cap, dtype=_I64, device=u.device)
    identity = slot.expand(k.shape + (cap,))
    safe_c = torch.clamp(cw, min=1e-30)
    perm0 = perm[..., 0]

    keep_old = u <= f / safe_c
    src_case0 = _set1(identity, torch.zeros_like(k),
                      torch.where(keep_old, k, perm0))

    rho = (1.0 - (nw / safe_c) * f) / torch.clamp(1.0 - fp, min=1e-30)
    do_swap = u > rho
    src_swap = _set1(_set1(identity, perm0, k), k, perm0)
    src_case_eq = torch.where(do_swap.unsqueeze(-1), src_swap, identity)

    p1 = (nw / safe_c) * f
    b1 = u <= p1
    kp_m1 = torch.clamp(kp - 1, min=0)
    src_b1 = torch.where(slot < kp_m1.unsqueeze(-1), perm, identity)
    src_b1 = _set1(src_b1, kp_m1, k)
    src_b1 = _set1(src_b1, kp, _take(perm, kp_m1))
    src_b2 = torch.where(slot <= kp.unsqueeze(-1), perm, identity)
    src_case_lt = torch.where(b1.unsqueeze(-1), src_b1, src_b2)

    src = torch.where((kp == 0).unsqueeze(-1), src_case0,
                      torch.where((kp == k).unsqueeze(-1), src_case_eq,
                                  src_case_lt))
    return torch.where((nw >= cw).unsqueeze(-1), identity, src)


def downsample_map(draws, cap: int, weight, new_weight, *,
                   max_deleted: int | None = None,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Slot-index map of paper Algorithm 3: ``src[..., cap]`` (new slot ->
    old slot) realizing the C -> C' downsample (Theorem 4.1).

    :class:`ExactDownsampleDraws` give the exact argsort construction (JAX's
    ``exact=True``; ``max_deleted`` and ``gate`` do not apply), and
    :class:`DownsampleDraws` the swap-or-not ones.

    With ``max_deleted`` (and ``draws.rb_small``) both constructions are
    computed and the delete-complement one is selected whenever at most
    ``D = min(max_deleted, cap)`` full items leave (or none do), as the JAX
    ``lax.cond`` selects it. ``gate`` (bool [...]) marks where the caller
    uses the map at all; where it is False the H1 loop runs 0 trips."""
    cw = weight.to(_F32)
    nw = torch.minimum(new_weight.to(_F32), cw)
    k, f = floor_frac(cw)
    kp, fp = floor_frac(nw)
    if isinstance(draws, ExactDownsampleDraws):
        perm = rng.prefix_permutation(draws.u_perm, cap, k)
        return _downsample_map_perm(draws.u, perm, cap, k, f, kp, fp, nw, cw)
    full = _downsample_map_full(draws.u, draws.rb_full, cap, k, f, kp, fp, nw, cw)
    if max_deleted is None or max_deleted <= 0:
        return full
    D = min(int(max_deleted), cap)
    can_fast = (kp == 0) | (kp == k) | (k - kp <= D)
    g = can_fast & (nw < cw)
    if gate is not None:
        g = g & gate
    small = _downsample_map_small(draws.u, draws.rb_small, cap, k, f, kp, fp,
                                  nw, cw, D, g)
    return torch.where(can_fast.unsqueeze(-1), small, full)


def downsample(draws, lat: Latent, new_weight, *,
               max_deleted: int | None = None) -> Latent:
    """Paper Algorithm 3: rescale inclusion probabilities by C'/C. One map,
    one gather, whatever the branch; ``draws`` of either type."""
    cw = lat.weight.to(_F32)
    nw = torch.minimum(new_weight.to(_F32), cw)
    kp, _ = floor_frac(nw)
    src = downsample_map(draws, lat.cap, lat.weight, new_weight,
                         max_deleted=max_deleted)
    return Latent(items=gather(lat.items, src), nfull=kp, weight=nw)


def insert_full(lat: Latent, batch_items: Any, bcount) -> Latent:
    """Insert ``bcount`` batch items (the valid prefix of ``batch_items``) as
    FULL items, relocating the partial item above the inserted block (paper
    Alg. 2 lines 9/20). Single reservoir (no batch dimension); the caller
    guarantees nfull + bcount + 1 <= cap."""
    bcap = pytree.tree_leaves(batch_items)[0].shape[0]
    cap = lat.cap
    k = lat.nfull
    bcount = torch.as_tensor(bcount, device=k.device).to(_I64)
    has_partial = lat.has_partial()
    top = k + bcount
    bpos = torch.arange(bcap, dtype=_I64, device=k.device)
    dest = torch.where(bpos < bcount, k + bpos, cap)     # cap => dropped

    def one(a, b):
        partial = a[k.clamp(0, cap - 1)]
        buf = torch.cat([a, torch.zeros_like(a[:1])])
        buf.index_copy_(0, dest, b)
        out = buf[:cap]
        at_top = out[top.clamp(0, cap - 1)]
        row = torch.where(has_partial, partial, at_top)
        # the relocation write is dropped when top is out of range
        sel = (torch.arange(cap, device=a.device) == top).reshape(
            (cap,) + (1,) * (a.dim() - 1))
        return torch.where(sel, row.unsqueeze(0), out)

    items = pytree.tree_map(one, lat.items, batch_items)
    return Latent(items=items, nfull=top,
                  weight=lat.weight + bcount.to(_F32))


def concat_items(a: Any, b: Any) -> Any:
    return pytree.tree_map(lambda x, y: torch.cat([x, y], dim=0), a, b)


def truncate_items(items: Any, cap: int) -> Any:
    return pytree.tree_map(lambda x: x[:cap], items)
