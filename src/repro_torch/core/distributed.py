"""D-R-TBS and D-T-TBS: the paper's Section-5 distributed schemes (the JAX
package's ``repro.core.distributed``), over an axis of S reservoir shards.

JAX runs one program a shard under ``shard_map`` over the ``data`` mesh
axis. Here the shards lie along an axis object, and the module is written
once against it: the axis gives each process its shards' indices
(:meth:`StackedAxis.index`), every shard's value of a tensor
(:meth:`StackedAxis.all_gather`) and the sum over shards
(:meth:`StackedAxis.psum`). Two axes serve it:

  * :class:`StackedAxis` (S): every shard is a row of one process's
    stacked state, so a collective is an operation along that row
    dimension (the gather is the tensor itself);
  * :class:`GroupAxis` (a ``torch.distributed`` process group): one shard
    a rank, the state's shard dimension one row long; the collectives run
    over the group. Every float reduction is an ``all_gather`` of the
    shards' terms summed in shard order on every rank (a ring
    ``all_reduce`` would add in the transport's order), so each rank's
    state equals row ``rank`` of the stacked form bit for bit. Integer sums
    are ``all_reduce``s. No collective moves a tensor to the host.

A function takes ``axis=`` (a mesh's ``shard_axis``; the distributed
samplers and the sharded loops pass theirs). Without one it runs on the
stacked axis over the state's shard dimension, and raises in a rank of a
process group: there a state holds one shard, and the stacked axis would
take that shard for the whole sample.

  * co-partitioned reservoir: shard s's full items live in row s of the
    item leaves ``[..., S, cap_s, ...]`` beside row s of the tick's batch
    ``[..., S, bcap_s, ...]``; payloads never cross shards, except the one
    fractional item, which every shard holds a copy of;
  * distributed decisions: the global bookkeeping (W, C, the branch, the
    count splits) comes from the shared tick key and the gathered counts,
    replicated on every shard; the insert and delete counts are split over
    the shards by a multivariate hypergeometric (Sec. 5.3, Fig. 6(b)); each
    shard then acts on its own rows.

State in the gathered form (JAX's ``gather_tree`` snapshot): every leaf
has the shard dimension, the replicated fields (the partial item, C and W)
one identical row a shard, so a JAX snapshot converts leaf for leaf
(:mod:`repro_torch.convert`); :func:`gather_tree` all-gathers a rank's
rows into it. Leading trial dimensions (a Monte-Carlo farm) go before the
shard dimension.

One tick is one slot map a shard over its reservoir rows and batch rows,
composed on the device from the tick's moves (the compaction by the
swap-or-not permutation, the case_eq swap, the appended old partial, the
local inserts, the saturated path's victim replacement, the second
downsample of the unsaturated path), and one B1 launch moves the payload
of the process's shards (:func:`repro_torch.kernels.tbs_step.ops.
tbs_step_apply`). Both Alg. 2 branches are composed and selected with
``torch.where``, as :func:`repro_torch.core.rtbs.tick_map` does, so no
tick reads a branch on the host. The fractional item is the one payload a
shard's map cannot name: the rows that can become it (the two downsamples'
donor rows) are all-gathered, one candidate row each a shard, and the
donor's is selected on the device; the slots it lands in (at most two a
tick, one a downsample) and the new partial are moved as single rows
beside the launch. The count splits run through H3, S launches a split
chain on every process: the decay downsample's, the victims' and the
inserts' splits in one chain, the overshoot downsample's in a second.

JAX broadcasts the donor's payload as a ``psum`` of payload x 0/1 flag,
so a -0.0 partial comes out +0.0 and a non-finite payload on another shard
poisons it; the port moves the bytes (ROADMAP C.14). The two agree on
finite data without -0.0.

Random bits are operands (:func:`draw_drtbs`, :func:`drtbs_step_with`),
drawn along JAX's key tree, so tests can feed JAX's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.reservoir_compact import ops as rc_ops
from repro_torch.kernels.tbs_step import ops as tbs_ops
from repro_torch.obs.profile import scope as _scope

from . import latent as lt
from . import prng, rng, simple

AXIS = "data"   # the JAX package's mesh axis the reservoir is co-partitioned over

_I64, _F32 = torch.int64, torch.float32

# dtypes every backend gathers natively; the rest travel as their bytes
_NATIVE = (torch.float32, torch.float64, torch.float16, torch.int64, torch.int32,
           torch.int8, torch.uint8)


# ---------------------------------------------------------------------------
# the shard axis
# ---------------------------------------------------------------------------
class StackedAxis:
    """``size`` shards as a leading dimension of one process's state:
    ``local == size``, and every collective is an operation along that
    dimension."""

    def __init__(self, size: int):
        self.size = self.local = int(size)
        self.rank, self.group = 0, None

    def __repr__(self) -> str:
        return f"StackedAxis({self.size})"

    def index(self, device) -> torch.Tensor:
        """This process's shards' indices ``[local]`` (JAX's ``axis_index``)."""
        return torch.arange(self.local, dtype=_I64, device=device)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every shard's value, ``x``'s shard dimension ``dim`` of ``local``
        rows grown to ``size`` (JAX's ``all_gather``)."""
        return x

    def all_gather_many(self, xs, dim: int = -1) -> tuple:
        """:meth:`all_gather` of tensors of one shape and dtype, in one
        collective."""
        return tuple(xs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over shards of ``x`` ``[..., local]`` (JAX's ``psum``)."""
        return x.sum(-1)

    def mine(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This process's rows of a replicated every-shard value ``[...,
        size]``."""
        return x


class GroupAxis(StackedAxis):
    """One shard a rank of a ``torch.distributed`` process group: the
    state's shard dimension is one row, shard ``rank``."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = 1

    def __repr__(self) -> str:
        return f"GroupAxis(rank {self.rank} of {self.size})"

    def index(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=_I64, device=device)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        import torch.distributed as dist

        dt = x.dtype
        x = x.contiguous()
        if dt not in _NATIVE:     # bool, bf16: the bytes, a trailing dimension
            x = x.unsqueeze(-1).view(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts, dim=dim if dim >= 0 else dim - (dt not in _NATIVE))
        return out if dt in _NATIVE else out.view(dt).squeeze(-1)

    def all_gather_many(self, xs, dim: int = -1) -> tuple:
        d = dim + 1 if dim >= 0 else dim
        return tuple(self.all_gather(torch.stack(list(xs)), d).unbind(0))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if x.is_floating_point():
            return self.all_gather(x, -1).sum(-1)
        out = x.sum(-1)
        dist.all_reduce(out, group=self.group)
        return out

    def mine(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return x.narrow(dim, self.rank, 1)


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def resolve_axis(axis, local: int) -> StackedAxis:
    """``axis``, else the stacked axis of ``local`` shards; raises unless it
    holds ``local`` shards in this process, and when no axis is given in a
    rank of a process group (no quiet fall back to the stacked form)."""
    if axis is None:
        if _in_group():
            raise ValueError("this process is a rank of a process group: pass axis= (the "
                             "mesh's shard_axis, or make_sampler(..., axis=...)); the stacked "
                             "axis would take this rank's shard for the whole sample")
        return StackedAxis(local)
    if axis.local != local:
        raise ValueError(f"{axis!r} holds {axis.local} shard(s) a process; the state has {local}")
    return axis


def axis_index(num_shards: int, device) -> torch.Tensor:
    """Every shard's index: ``arange(S)`` (JAX's ``axis_index`` on the
    stacked axis)."""
    return torch.arange(num_shards, dtype=_I64, device=device)


def psum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """The sum over shards of ``x`` ``[..., S_local]`` (JAX's ``psum``)."""
    return resolve_axis(axis, x.shape[-1]).psum(x)


def all_gather(x: Any, axis=None, dim: int = -1) -> Any:
    """Every shard's value of a tree whose leaves carry the shard dimension
    at ``dim`` (JAX's ``all_gather``)."""
    leaves = pytree.tree_leaves(x)
    if not leaves:
        return x
    ax = resolve_axis(axis, leaves[0].shape[dim])
    return pytree.tree_map(lambda a: ax.all_gather(a, dim), x)


def gather_tree(tree: Any, axis=None, dim: int = 0) -> Any:
    """The gathered snapshot of per-shard state (shard dimension ``dim``):
    on the stacked axis the state itself, over a group every rank's rows."""
    return all_gather(tree, axis, dim)


def local_rows(tree: Any, axis, dim: int = 0) -> Any:
    """This process's rows of a gathered snapshot (the inverse of
    :func:`gather_tree`)."""
    return pytree.tree_map(lambda a: axis.mine(a, dim), tree)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DRTBSShard:
    """The shards' slices of the distributed latent sample: the union of the
    shards' full-item prefixes plus one replicated partial item. Fields in
    JAX's order; with the shard dimension S (see the module docstring)."""

    items: Any                 # pytree, leaves [..., S, cap_s, ...]: full items at [0, nfull)
    nfull: torch.Tensor        # int64 [..., S], each shard's full-item count
    partial_item: Any          # pytree, leaves [..., S, ...]: the partial item, replicated
    weight: torch.Tensor       # f32 [..., S], the global C, replicated
    total_weight: torch.Tensor  # f32 [..., S], the global W, replicated
    overflow: torch.Tensor     # int64 [..., S], capacity-dropped inserts (should stay 0)


pytree.register_dataclass(DRTBSShard)


def init_shard(item_proto: Any, cap_s: int) -> DRTBSShard:
    """One empty shard (no shard dimension), on ``item_proto``'s device;
    :func:`repro_torch.manage.init_sharded_state` stacks S of them."""
    dev = pytree.tree_leaves(item_proto)[0].device
    zero = torch.zeros((), dtype=_I64, device=dev)
    return DRTBSShard(
        items=pytree.tree_map(lambda p: torch.zeros((cap_s,) + tuple(p.shape), dtype=p.dtype,
                                                    device=p.device), item_proto),
        nfull=zero, partial_item=pytree.tree_map(torch.zeros_like, item_proto),
        weight=torch.zeros((), dtype=_F32, device=dev),
        total_weight=torch.zeros((), dtype=_F32, device=dev), overflow=zero.clone())


def _cap(items: Any, nlead: int) -> int:
    return pytree.tree_leaves(items)[0].shape[nlead]


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------
def _uniform(key, device) -> torch.Tensor:
    """One f32 uniform from a host key (0-d), or one a row of a key tensor."""
    return prng.uniform(key, (), device)


def _as_axis(axis) -> StackedAxis:
    return StackedAxis(axis) if isinstance(axis, int) else axis


def shard_keys(key, axis, device) -> torch.Tensor:
    """``fold_in(key, s)`` for each of this process's shards s (``axis``:
    an axis, or a shard count for the stacked one): a key tensor ``[...,
    S_local, 2]`` (from a host key, or from a key tensor ``[..., 2]`` of
    trials)."""
    if isinstance(key, torch.Tensor):
        key = key.unsqueeze(-2)
    return prng.fold_in(key, _as_axis(axis).index(device))


def _split_uniforms(key, num_shards: int, device) -> torch.Tensor:
    """The uniforms ``[..., S]`` of a multivariate hypergeometric split:
    column s from ``split(key, S)[s]``, every shard's on every process."""
    return prng.uniform(prng.key_rows(key, num_shards, device), ())


@dataclasses.dataclass
class DownsampleDraws:
    """The draws of one distributed Alg. 3 (JAX splits its key ``k_u,
    k_split, k_donor, k_local``): the branch uniform, the count split's
    uniforms, the donor's uniform and each shard's swap-or-not round words
    from ``fold_in(k_local, s)``."""

    u: torch.Tensor           # f32 [...]
    u_split: torch.Tensor     # f32 [..., S], every shard's
    u_donor: torch.Tensor     # f32 [...]
    rb_local: torch.Tensor    # int64 [..., S_local, rounds, 2], this process's shards


def draw_downsample(key, axis, device) -> DownsampleDraws:
    """One downsample's draws; ``rb_local`` for this process's shards of
    ``axis`` (or of a stacked shard count)."""
    ax = _as_axis(axis)
    k_u, k_split, k_donor, k_local = prng.split(key, 4)
    return DownsampleDraws(
        u=_uniform(k_u, device), u_split=_split_uniforms(k_split, ax.size, device),
        u_donor=_uniform(k_donor, device),
        rb_local=rng.draw_son_bits(shard_keys(k_local, ax, device), (), device))


@dataclasses.dataclass
class DRTBSDraws:
    """Every draw of one D-R-TBS tick. JAX splits the tick key six ways,
    ``k_ds, k_over, k_m, k_split_v, k_split_i, k_loc``: the decay (or
    undershoot) and overshoot downsamples, the stochastic round of the
    victim count, the victim and insert count splits, and each shard's
    victim and pick permutations from ``split(fold_in(k_loc, s))``."""

    ds: DownsampleDraws
    over: DownsampleDraws
    u_m: torch.Tensor          # f32 [...]
    u_split_v: torch.Tensor    # f32 [..., S]
    u_split_i: torch.Tensor    # f32 [..., S]
    rb_vic: torch.Tensor       # int64 [..., S_local, rounds, 2]
    rb_pick: torch.Tensor      # int64 [..., S_local, rounds, 2]


def draw_drtbs(key, axis, device) -> DRTBSDraws:
    """One tick's draws from the shared tick key (a host key, or a key
    tensor ``[T, 2]``: one row of draws a trial) for this process's shards
    of ``axis`` (or of a stacked shard count)."""
    ax = _as_axis(axis)
    k_ds, k_over, k_m, k_split_v, k_split_i, k_loc = prng.split(key, 6)
    k_vic, k_pick = prng.split(shard_keys(k_loc, ax, device), 2)
    return DRTBSDraws(
        ds=draw_downsample(k_ds, ax, device),
        over=draw_downsample(k_over, ax, device),
        u_m=_uniform(k_m, device),
        u_split_v=_split_uniforms(k_split_v, ax.size, device),
        u_split_i=_split_uniforms(k_split_i, ax.size, device),
        rb_vic=rng.draw_son_bits(k_vic, (), device),
        rb_pick=rng.draw_son_bits(k_pick, (), device))


# ---------------------------------------------------------------------------
# the tick as one slot map a shard
# ---------------------------------------------------------------------------
# A map entry is a global source code: shard s's reservoir row r is
# s * V + r, its batch row b is s * V + cap_s + b (V = cap_s + bcap_s);
# OLD is the partial item the tick started with and ZERO a zero row (what
# JAX's psum broadcast gives when no shard donates). The partial item is
# one code too.
@dataclasses.dataclass
class _Plan:
    """The replicated branch quantities of one distributed Alg. 3."""

    nw: torch.Tensor
    f: torch.Tensor
    case0: torch.Tensor
    case_eq: torch.Tensor
    b1: torch.Tensor
    do_swap: torch.Tensor
    keep_old: torch.Tensor
    sel_total: torch.Tensor
    noop: torch.Tensor


def _plan(d: DownsampleDraws, cw: torch.Tensor, new_weight: torch.Tensor) -> _Plan:
    """JAX's shared branch logic (``_dist_downsample`` lines 113-145)."""
    nw = torch.minimum(new_weight.to(_F32), cw)
    k, f = lt.floor_frac(cw)
    kp, fp = lt.floor_frac(nw)
    safe_c = torch.clamp(cw, min=1e-30)
    case0 = kp == 0
    case_eq = (kp == k) & ~case0
    b1 = (d.u <= (nw / safe_c) * f) & (f > 0)
    rho = (1.0 - (nw / safe_c) * f) / torch.clamp(1.0 - fp, min=1e-30)
    do_swap = d.u > rho
    keep_old = d.u <= f / safe_c
    one = torch.ones_like(kp)
    sel_total = torch.where(case0, torch.where(keep_old, 0, one),
                            torch.where(case_eq, torch.where(do_swap, one, 0),
                                        torch.where(b1, kp, kp + 1)))
    return _Plan(nw=nw, f=f, case0=case0, case_eq=case_eq, b1=b1,
                 do_swap=do_swap, keep_old=keep_old, sel_total=sel_total, noop=nw >= cw)


def _downsample(d: DownsampleDraws, p: _Plan, split: torch.Tensor, src: torch.Tensor,
                nfull: torch.Tensor, pcode: torch.Tensor, ax: StackedAxis, *, zero: int):
    """JAX's ``_dist_downsample`` on the maps: ``(src, nfull, pcode)`` after
    the downsample, given the count split ``split`` [..., S]. ``src`` is
    this process's maps ``[..., S_local, cap_s]``; ``nfull`` and the
    returned counts are every shard's ``[..., S]``, replicated. The donor's
    payload becomes the partial by its code (each shard's candidate code
    all-gathered, the donor's selected); the old partial lands in the
    donor's buffer by its code."""
    S, cap_s = split.shape[-1], src.shape[-1]
    donor = rng.categorical_from_counts(d.u_donor, split)
    is_donor = ((axis_index(S, src.device) == donor.unsqueeze(-1))
                & (p.sel_total.unsqueeze(-1) > 0))                    # [..., S]
    case0, case_eq = p.case0.unsqueeze(-1), p.case_eq.unsqueeze(-1)
    keep = torch.where(case0, 0, torch.where(case_eq, nfull, split - is_donor.to(_I64)))
    keep = torch.clamp(keep, min=0)
    nf = torch.where(case_eq, nfull, keep)
    append = (~p.case0 & ~p.case_eq & p.b1 & (p.f > 0)).unsqueeze(-1) & is_donor
    # this process's shards
    is_donor_l, keep_l, nf_l, append_l = (ax.mine(x) for x in (is_donor, keep, nf, append))
    perm = rng.prefix_permutation_fast(d.rb_local, cap_s, ax.mine(nfull))
    perm0 = perm[..., 0]
    donor_slot = torch.where(case0 | case_eq, perm0,
                             lt._take(perm, torch.clamp(keep_l, max=cap_s - 1)))
    code = ax.all_gather(lt._take(src, donor_slot))                   # [..., S]
    from_full = torch.where(p.sel_total > 0, lt._take(code, donor), zero)
    pcode_new = torch.where((p.case0 & p.keep_old) | (p.case_eq & ~p.do_swap), pcode,
                            from_full)
    compacted = torch.gather(src, -1, perm)
    swap = is_donor_l & (p.f > 0).unsqueeze(-1)
    swapped = lt._set1(src, perm0, torch.where(swap, pcode.unsqueeze(-1), lt._take(src, perm0)))
    out = torch.where(case_eq.unsqueeze(-1), swapped, compacted)
    out = lt._set1(out, torch.where(append_l, nf_l, cap_s),
                   pcode.unsqueeze(-1).expand(nf_l.shape))
    nf = nf + append.to(_I64)
    noop = p.noop.unsqueeze(-1)
    return (torch.where(noop.unsqueeze(-1), src, out), torch.where(noop, nfull, nf),
            torch.where(p.noop, pcode, pcode_new))


def _insert(src: torch.Tensor, nfull: torch.Tensor, bcount: torch.Tensor, base_b: torch.Tensor):
    """JAX's ``_local_insert_full`` on the maps: the shard's batch rows
    [0, bcount) land at nfull + i (those past cap_s drop out)."""
    cap_s = src.shape[-1]
    r = torch.arange(cap_s, dtype=_I64, device=src.device)
    nf, bc = nfull.unsqueeze(-1), bcount.unsqueeze(-1)
    return torch.where((r >= nf) & (r < nf + bc), base_b.unsqueeze(-1) + (r - nf), src)


def tick_maps(draws: DRTBSDraws, nfull, weight, total_weight, bcount, decay, *,
              cap_s: int, bcap_s: int, n: int, axis=None):
    """Compose one D-R-TBS tick (JAX's ``drtbs_shard_step``) into each of
    this process's shards' slot maps. ``nfull`` and ``bcount`` are ``[...,
    S_local]``; ``weight`` (C), ``total_weight`` (W) and ``decay`` are the
    replicated scalars ``[...]``. Returns ``(src [..., S_local, cap_s]
    global codes, nfull [..., S_local], C, W, dropped [..., S_local], pcode
    [...], pc1 [...])`` (codes in the comment above; ``pc1`` is the partial
    after the first downsample, the one shard row the maps can place on
    another shard)."""
    ax = resolve_axis(axis, nfull.shape[-1])
    S = ax.size
    dev = nfull.device
    V = cap_s + bcap_s
    old, zero = S * V, S * V + 1
    base = ax.index(dev) * V                                          # [S_local]
    bcnt_l = bcount.to(_I64).expand(nfull.shape)
    # every shard's counts, one collective: the counts below are replicated
    nfull, bcnt = ax.all_gather_many((nfull, bcnt_l))                 # [..., S]
    Bf = bcnt.sum(-1).to(_F32)                        # the ONE aggregation (Sec. 5.1)
    C, W = weight, total_weight
    was_unsat = W < n
    w_dec = decay * W
    # the saturated branch's ``decay * W + B`` has no other use of its
    # product, so XLA contracts it into one rounding (latent.fma_f32)
    w_new = lt.fma_f32(decay.expand(W.shape), W, Bf)
    still_sat = ~was_unsat & (w_new >= n)
    nf = float(n)                                     # exact in f32 for n < 2^24
    src0 = (base.unsqueeze(-1) + torch.arange(cap_s, dtype=_I64, device=dev)).expand(
        bcnt_l.shape + (cap_s,))
    pcode0 = torch.full(C.shape, old, dtype=_I64, device=dev)

    # the saturated path's counts and the first downsample's split share
    # one chain: they depend only on the tick's inputs
    t1 = torch.where(was_unsat, w_dec, w_new - Bf)
    p1 = _plan(draws.ds, C, t1)
    m = rng.stochastic_round(draws.u_m, Bf * n / torch.clamp(w_new, min=1e-30))
    # (a wider trips bound leaves a draw as it is once its support fits)
    splits = rng.multivariate_hypergeometric(
        torch.stack([draws.ds.u_split, draws.u_split_v, draws.u_split_i]),
        torch.stack([p1.sel_total, m, m]), torch.stack([nfull, nfull, bcnt]),
        max_support=max(cap_s, bcap_s))

    # ---- insert path: (gated) downsample, local inserts, overshoot ----
    apply1 = torch.where(was_unsat, (w_dec > 0) & (w_dec < C), True)
    s1, nf1, pc1 = _downsample(draws.ds, p1, splits[0], src0, nfull, pcode0, ax, zero=zero)
    a1 = apply1.unsqueeze(-1)
    s1 = torch.where(a1.unsqueeze(-1), s1, src0)
    nf1 = torch.where(a1, nf1, nfull)
    pc1 = torch.where(apply1, pc1, pcode0)
    C1 = torch.where(apply1, p1.nw, torch.minimum(C, torch.clamp(w_dec, min=0.0)))
    s2 = _insert(s1, ax.mine(nf1), bcnt_l, base + cap_s)
    nf2 = torch.clamp(nf1 + bcnt, max=cap_s)
    drop2 = torch.clamp(ax.mine(nf1) + bcnt_l - cap_s, min=0)
    C2 = C1 + Bf
    over = was_unsat & (C2 > nf)
    p2 = _plan(draws.over, C2, torch.full_like(C2, nf))
    split2 = rng.multivariate_hypergeometric(draws.over.u_split, p2.sel_total, nf2,
                                             max_support=cap_s)
    s3, nf3, pc3 = _downsample(draws.over, p2, split2, s2, nf2, pc1, ax, zero=zero)
    o = over.unsqueeze(-1)
    s_ins = torch.where(o.unsqueeze(-1), s3, s2)
    nf_ins = torch.where(o, nf3, nf2)
    pc_ins = torch.where(over, pc3, pc1)
    C_ins = torch.where(over, p2.nw, C2)

    # ---- still saturated: replace victims by picks (Fig. 6(b) splits) ----
    vperm = rng.prefix_permutation_fast(draws.rb_vic, cap_s, ax.mine(nfull))
    picks = rng.prefix_permutation_fast(draws.rb_pick, bcap_s, bcnt_l)
    keep = nfull - splits[1]
    ins = splits[2]
    s_sat = simple.compose_map(vperm, picks, ax.mine(keep), ax.mine(ins)).to(_I64) \
        + base.unsqueeze(-1)
    drop_sat = ax.mine(torch.clamp(keep + ins - cap_s, min=0))

    ss = still_sat.unsqueeze(-1)
    src = torch.where(ss.unsqueeze(-1), s_sat, s_ins)
    nfull_new = ax.mine(torch.where(ss, torch.clamp(keep + ins, max=cap_s), nf_ins))
    dropped = torch.where(ss, drop_sat, drop2)
    C3 = torch.where(still_sat, nf, C_ins)
    pcode = torch.where(still_sat, pcode0, pc_ins)
    return src, nfull_new, C3, w_new, dropped, pcode, torch.where(still_sat, pcode0, pc1)


def _apply(state: DRTBSShard, batch_items: Any, src: torch.Tensor, pcodes: tuple,
           ax: StackedAxis):
    """Move the payload by the tick's maps: one B1 launch over this
    process's shards' reservoirs, then the map entries that name another
    shard's row or the old partial (the partial's slots: at most two a
    trial and process) and the new partial item, as single rows.
    ``pcodes`` = ``(pc1, pcode)``: the codes of the only shard rows that can
    cross shards (:func:`tick_maps`). Each shard offers its rows under both
    codes; the offers are all-gathered and each code takes its shard's.
    Returns ``(items, partial_item)``."""
    lead, L = state.nfull.shape[:-1], state.nfull.shape[-1]
    nl, J = len(lead), state.nfull[..., 0].numel()
    S, cap_s = ax.size, src.shape[-1]
    items_l, spec = pytree.tree_flatten(state.items)
    part_l = pytree.tree_leaves(state.partial_item)
    batch_l = [b.expand(a.shape[:a.dim() - b.dim()] + b.shape)
               for a, b in zip(items_l, pytree.tree_leaves(batch_items))]
    bcap_s = batch_l[0].shape[nl + 1]
    V = cap_s + bcap_s
    old, zero = S * V, S * V + 1
    dev = src.device
    me = ax.index(dev)
    loc = src - (me * V).unsqueeze(-1)
    foreign = (loc < 0) | (loc >= V)
    slot = torch.arange(cap_s, dtype=_I64, device=dev)
    src_b1 = torch.where(foreign, slot, loc).to(torch.int32).reshape(J * L, cap_s)
    with _scope("drtbs.payload"):
        outs = tbs_ops.tbs_step_apply(
            [a.reshape((J * L, cap_s) + a.shape[nl + 2:]) for a in items_l],
            [b.reshape((J * L, bcap_s) + b.shape[nl + 2:]) for b in batch_l], src_b1)
    with _scope("drtbs.partial"):
        R = L * cap_s
        fl, code_f = foreign.reshape(J, R), src.reshape(J, R)
        pos = torch.arange(R, dtype=_I64, device=dev)
        ends = (torch.where(fl, pos, R).amin(-1), torch.where(fl, pos, -1).amax(-1))
        j = torch.arange(J, device=dev)
        codes = torch.stack([c.reshape(J) for c in pcodes], -1)          # [J, 2]
        sh = torch.clamp(codes // V, max=S - 1)
        lc = (codes - sh * V).unsqueeze(1)                                # [J, 1, 2]
        jl = j.reshape(J, 1, 1)
        ls = torch.arange(L, device=dev).reshape(1, L, 1)
        new_items, new_part = [], []
        for a, b, p, o in zip(items_l, batch_l, part_l, outs):
            rest = a.shape[nl + 2:]
            col = (-1,) + (1,) * len(rest)
            a_f = a.reshape((J, L, cap_s) + rest)
            b_f = b.reshape((J, L, bcap_s) + rest)
            p_f = p.reshape((J, L) + rest)[:, 0]
            # each shard's offer under each code, then every shard's
            res = a_f[jl, ls, torch.clamp(lc, max=cap_s - 1)]
            bat = b_f[jl, ls, torch.clamp(lc - cap_s, 0, bcap_s - 1)]
            offer = torch.where((lc < cap_s).reshape((J, 1, 2) + (1,) * len(rest)), res, bat)
            offer = ax.all_gather(offer, 1)                               # [J, S, 2, ...]
            rows = offer[j.unsqueeze(-1), sh, torch.arange(2, device=dev)]  # [J, 2, ...]

            def row_of(code, k):
                r = torch.where((code == zero).reshape(col), torch.zeros_like(p_f), rows[:, k])
                return torch.where((code == old).reshape(col), p_f, r)

            pc1_row, pc_row = row_of(codes[:, 0], 0), row_of(codes[:, 1], 1)
            o_f = o.reshape((J, R) + rest)
            for e in ends:
                has = ((e >= 0) & (e < R)).reshape(col)
                at = torch.clamp(e, 0, R - 1)
                c = lt._take(code_f, at)
                row = torch.where((c == codes[:, 1]).reshape(col), pc_row, pc1_row)
                row = torch.where((c == zero).reshape(col), torch.zeros_like(p_f), row)
                row = torch.where((c == old).reshape(col), p_f, row)
                o_f[j, at] = torch.where(has, row, o_f[j, at])
            new_items.append(o_f.reshape(a.shape))
            new_part.append(pc_row.reshape(tuple(lead) + (1,) + rest).expand(
                tuple(lead) + (L,) + rest).contiguous())
    return pytree.tree_unflatten(new_items, spec), pytree.tree_unflatten(new_part, spec)


def _replicated(x: torch.Tensor, S: int) -> torch.Tensor:
    """A replicated scalar ``[...]`` as one row a shard ``[..., S]``."""
    return x.unsqueeze(-1).expand(x.shape + (S,)).contiguous()


def _scalar(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A replicated operand (a decay factor: 0-d, ``[...]`` or ``[..., S]``
    as ``like``) as one value a trial."""
    return x[..., 0] if x.dim() == like.dim() else x


def drtbs_step_with(draws: DRTBSDraws, state: DRTBSShard, batch_items: Any,
                    bcount: torch.Tensor, *, n: int, decay: torch.Tensor,
                    axis=None) -> DRTBSShard:
    """One D-R-TBS tick for this process's shards from given draws: the
    composed maps (:func:`tick_maps`), then one B1 launch. ``batch_items``
    leaves are ``[..., S_local, bcap_s, ...]`` (trial dimensions may be left
    out: the trials share the batch), ``bcount`` ``[..., S_local]``;
    ``decay`` the tick's factor (an f32 device tensor)."""
    nl = state.nfull.dim() - 1
    L = state.nfull.shape[-1]
    ax = resolve_axis(axis, L)
    cap_s = _cap(state.items, nl + 1)
    item = pytree.tree_leaves(state.items)[0]
    b0 = pytree.tree_leaves(batch_items)[0]
    bcap_s = b0.shape[b0.dim() - (item.dim() - nl - 2) - 1]
    with _scope("drtbs.tick_map"):
        src, nfull, C, W, dropped, pcode, pc1 = tick_maps(
            draws, state.nfull, state.weight[..., 0], state.total_weight[..., 0], bcount,
            _scalar(decay.to(_F32), state.nfull), cap_s=cap_s, bcap_s=bcap_s, n=n, axis=ax)
    items, partial = _apply(state, batch_items, src, (pc1, pcode), ax)
    return DRTBSShard(items=items, nfull=nfull, partial_item=partial,
                      weight=_replicated(C, L), total_weight=_replicated(W, L),
                      overflow=state.overflow + dropped)


def drtbs_shard_step(key, state: DRTBSShard, batch_items: Any, bcount: torch.Tensor, *,
                     n: int, lam: float | None = None, decay=None, axis=None) -> DRTBSShard:
    """One D-R-TBS step of this process's shards (paper Alg. 2,
    distributed). ``key`` is the shared tick key (a host key, or a key
    tensor ``[T, 2]`` with a leading trial dimension); shard-local draws
    fold in the shard index. Pass exactly one of ``lam`` and ``decay`` (the
    per-tick factor)."""
    from . import rtbs

    dev = state.nfull.device
    ax = resolve_axis(axis, state.nfull.shape[-1])
    decay = rtbs._resolve_decay(lam, decay, dev)
    with _scope("drtbs.draws"):
        draws = draw_drtbs(key, ax, dev)
    return drtbs_step_with(draws, state, batch_items, bcount, n=n, decay=decay, axis=ax)


# ---------------------------------------------------------------------------
# realization
# ---------------------------------------------------------------------------
def _take_partial(key, state: DRTBSShard) -> torch.Tensor:
    """The fractional item's realization draw ``[...]`` from the shared key
    (``latent.partial_draw``)."""
    w = state.weight[..., 0]
    return lt.partial_draw(prng.uniform_for(key, w), w)[1]


def _prefix_mask(count: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.arange(cap, dtype=_I64, device=count.device) < count.unsqueeze(-1)


def drtbs_realize_shard(key, state: DRTBSShard, axis=None):
    """Each of this process's shards' realized S_t: ``(mask [..., S_local,
    cap_s], size [..., S_local], take_partial [..., S_local])``; the partial
    item is counted on shard 0 only, w.p. frac(C) from the shared key. Its
    payload is NOT under ``mask`` (the Sampler's ``extract`` reserves slot
    ``cap_s`` for it)."""
    ax = resolve_axis(axis, state.nfull.shape[-1])
    take = _take_partial(key, state).unsqueeze(-1) & (ax.index(state.nfull.device) == 0)
    mask = _prefix_mask(state.nfull, _cap(state.items, state.nfull.dim()))
    return mask, state.nfull + take.to(_I64), take


def _gathered(state, axis):
    """``(items, counts)`` of every shard: the leaves and the count of
    ``state`` (a D-R-TBS or buffer state) all-gathered along the shard
    dimension."""
    counts = state.nfull if isinstance(state, DRTBSShard) else state.count
    ax = resolve_axis(axis, counts.shape[-1])
    nl = counts.dim() - 1
    return (pytree.tree_map(lambda a: ax.all_gather(a, nl), state.items),
            ax.all_gather(counts))


def drtbs_realize_global(key, state: DRTBSShard, axis=None):
    """The realized GLOBAL sample ``(items, mask, size)``: item leaves
    ``[..., S * cap_s + 1, ...]``, the shards' buffers end to end and one
    slot holding the partial item, selected w.p. frac(C) (a copy of every
    buffer; the loops materialize through :func:`drtbs_extract_global`,
    which copies none on the stacked axis)."""
    nl = state.nfull.dim() - 1
    items, nfull = _gathered(state, axis)
    take = _take_partial(key, state)
    mask = _prefix_mask(nfull, _cap(items, nl + 1)).flatten(-2)
    items = pytree.tree_map(
        lambda a, p: torch.cat([a.flatten(nl, nl + 1), p.narrow(nl, 0, 1)], dim=nl),
        items, state.partial_item)
    return items, torch.cat([mask, take.unsqueeze(-1)], dim=-1), \
        nfull.sum(-1) + take.to(_I64)


def drtbs_global_size(key, state: DRTBSShard, axis=None) -> torch.Tensor:
    """|S_t| as :func:`drtbs_realize_global` reports it (the same partial
    draw), from the counts alone."""
    return psum(state.nfull, axis) + _take_partial(key, state).to(_I64)


def _materialize(items: Any, mask: torch.Tensor, rows: int):
    """Pack the masked rows of each trial's flattened buffer (leaves
    ``[..., R, ...]``, mask ``[..., R]``) to the head of a buffer of ``rows``
    rows through B2, one launch a trial. Returns leaves ``[..., rows, ...]``."""
    nl = mask.dim() - 1
    lead = mask.shape[:-1]
    leaves, spec = pytree.tree_flatten(items)
    J, R = mask[..., 0].numel(), mask.shape[-1]
    flat = [a.reshape((J, R) + a.shape[nl + 1:]) for a in leaves]
    m = mask.reshape(J, R)
    per = [rc_ops.reservoir_compact([a[j] for a in flat], m[j], rows=rows)[0]
           for j in range(J)]
    outs = [torch.stack([p[i] for p in per]) if J > 1 else per[0][i].unsqueeze(0)
            for i in range(len(leaves))]
    return pytree.tree_unflatten([o.reshape(tuple(lead) + o.shape[1:]) for o in outs], spec)


def drtbs_extract_global(key, state: DRTBSShard, axis=None):
    """The realized global sample packed to a dense ``[0, size)`` prefix,
    ``(items [..., S * cap_s + 1, ...], mask, size)``: JAX's
    ``materialize_view`` of :func:`drtbs_realize_global`. The shards'
    prefixes (all-gathered over a group) pack through B2 (one launch a
    trial) into a buffer with one row more, and the partial item, when
    taken, lands at row ``sum(nfull)``: no buffer is copied to append it."""
    nl = state.nfull.dim() - 1
    items, nfull = _gathered(state, axis)
    S, cap_s = nfull.shape[-1], _cap(items, nl + 1)
    R = S * cap_s
    take = _take_partial(key, state)
    count = nfull.sum(-1)
    mask = _prefix_mask(nfull, cap_s).flatten(-2)
    packed = _materialize(pytree.tree_map(lambda a: a.flatten(nl, nl + 1), items), mask, R + 1)
    J = count.numel()
    j = torch.arange(J, device=count.device)

    def place(o, p):
        rest = o.shape[nl + 1:]
        o_f = o.reshape((J, R + 1) + rest)
        at = count.reshape(J)
        t = take.reshape((-1,) + (1,) * len(rest))
        o_f[j, at] = torch.where(t, p.reshape((J, p.shape[nl]) + rest)[:, 0], o_f[j, at])
        return o

    items = pytree.tree_map(place, packed, state.partial_item)
    size = count + take.to(_I64)
    return items, _prefix_mask(size, R + 1), size


# ---------------------------------------------------------------------------
# D-T-TBS: embarrassingly parallel (paper Sec. 5.1)
# ---------------------------------------------------------------------------
def _per_shard(x, like: torch.Tensor):
    """A rate (a number, 0-d, ``[...]`` or ``[..., S]`` as ``like``)
    broadcastable against ``like`` ``[..., S]``."""
    if isinstance(x, torch.Tensor) and 0 < x.dim() < like.dim():
        return x.unsqueeze(-1)
    return x


def dttbs_shard_step(key, state: simple.BufferState, batch_items: Any, bcount: torch.Tensor,
                     *, p, q, axis=None) -> simple.BufferState:
    """Each shard runs T-TBS on its own partition with the key
    ``fold_in(key, s)``: no coordination. A process's shards step
    together: both binomials of every shard in one H2 launch, every
    shard's payload in one B1 launch."""
    dev = state.count.device
    keys = shard_keys(key, resolve_axis(axis, state.count.shape[-1]), dev)
    return simple.ttbs_step(keys, state, batch_items, bcount, p=_per_shard(p, state.count),
                            q=_per_shard(q, state.count))


def buffer_realize_global(state: simple.BufferState, axis=None):
    """The global view of the shards' buffers (D-T-TBS): the buffers end to
    end (a view on the stacked axis, no copy), their prefix masks and the
    summed size. Membership is deterministic: no key."""
    nl = state.count.dim() - 1
    items, count = _gathered(state, axis)
    mask = _prefix_mask(count, state.cap)
    return (pytree.tree_map(lambda a: a.flatten(nl, nl + 1), items), mask.flatten(-2),
            count.sum(-1))


def buffer_extract_global(state: simple.BufferState, axis=None):
    """:func:`buffer_realize_global` packed to a dense ``[0, size)`` prefix
    through B2 (the shard prefixes are block-sparse in the global view)."""
    items, mask, size = buffer_realize_global(state, axis)
    R = mask.shape[-1]
    return _materialize(items, mask, R), _prefix_mask(size, R), size


# ---------------------------------------------------------------------------
# mesh-level wrapper
# ---------------------------------------------------------------------------
def make_drtbs_step(mesh, *, n: int, lam: float):
    """The whole-mesh D-R-TBS step ``step(key, state, batch_items, bcounts)``
    over ``mesh`` (:func:`repro_torch.launch.mesh.make_data_mesh`):
    ``batch_items`` leaves ``[S_local * bcap_s, ...]`` co-partitioned (the
    process's shard l owns rows ``[l * bcap_s, (l + 1) * bcap_s)``),
    ``bcounts`` ``[S_local]``, ``state`` the process's :class:`DRTBSShard`
    (all S shards stacked, or a rank's one)."""
    ax = mesh.shard_axis
    L = ax.local

    def step(key, state: DRTBSShard, batch_items: Any, bcounts: torch.Tensor) -> DRTBSShard:
        if bcounts.shape[-1] != L or state.nfull.shape[-1] != L:
            raise ValueError(f"make_drtbs_step: the mesh holds {L} shard(s) here; got "
                             f"bcounts {tuple(bcounts.shape)} and a state of "
                             f"{state.nfull.shape[-1]} shards")
        return drtbs_shard_step(key, state, split_batch(batch_items, L), bcounts, n=n,
                                lam=lam, axis=ax)

    return step


def split_batch(batch_items: Any, num_shards: int) -> Any:
    """Co-partitioned batch leaves ``[S * bcap_s, ...]`` as ``[S, bcap_s,
    ...]`` (a view)."""
    return pytree.tree_map(
        lambda a: a.reshape((num_shards, a.shape[0] // num_shards) + a.shape[1:]), batch_items)
