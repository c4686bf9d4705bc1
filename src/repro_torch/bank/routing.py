"""Key-routing layer of the sampler bank (the JAX package's
``repro.bank.routing``).

A tick's arrivals come as ``(keys[b], payload)``, one key id per item in
arrival order. :func:`route` buckets them into per-key segments with ONE
stable argsort over the batch (O(b log b), independent of the number of
keys K) plus O(b) segment bookkeeping:

  * sort items by key (invalid rows past ``bcount`` and out-of-range ids
    sort to a ``num_keys`` sentinel at the end), so each key's items form a
    contiguous segment;
  * segment boundaries give the ``<= b`` distinct touched keys, each with
    its segment start and length.

Fixed shapes throughout, and nothing is read on the host: the touched-key
list is padded to length ``b`` with the ``num_keys`` sentinel. JAX's
``mode="drop"`` scatters are written as scatters into a ``b + 1``-long
buffer whose last slot takes the sentinel rows, then sliced; ``nonzero`` and
boolean indexing are not used (they sync). Per-key sub-batches have a static
capacity ``bcap``: a key receiving more keeps its FIRST ``bcap`` items
(arrival order; the sort is stable) and the rest are dropped and counted in
``Routing.dropped``.

Index tensors are int64 (torch's index type); the values equal JAX's int32
ones.

A key-sharded bank (:func:`repro_torch.bank.shard_bank`) takes its tick in
the co-partitioned layout of :func:`repro_torch.manage.shard_keyed_stream`
(S segments of ``b_s`` rows, local key ids, a count a shard).
:func:`compact_shards` moves each shard's valid rows into one batch with
global ids, so that one :func:`route` buckets every shard's arrivals.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.tbs_step import ref as _ts_ref

_I64 = torch.int64


@dataclasses.dataclass
class Routing:
    """One tick's key bucketing; every tensor is sized by the batch ``b``.

    ``order``: the stable key-sort permutation; ``touched``: the distinct
    arriving keys in ascending order, padded with ``num_keys``;
    ``ntouched``: how many are real; ``starts``/``counts``: each touched
    key's segment start in the sorted order and its ACCEPTED length (at
    most ``bcap``); ``dropped``: per-touched-key overflow beyond ``bcap``;
    ``invalid``: valid rows with out-of-range key ids. Rows at or past
    ``ntouched`` carry the sentinel key and zero counts."""

    order: torch.Tensor     # [b]
    touched: torch.Tensor   # [b], ascending distinct keys, num_keys-padded
    ntouched: torch.Tensor  # []
    starts: torch.Tensor    # [b]
    counts: torch.Tensor    # [b], <= bcap
    dropped: torch.Tensor   # [b]
    invalid: torch.Tensor   # []

    @property
    def overflow(self) -> torch.Tensor:
        """Total items dropped by the per-key ``bcap`` bound this tick."""
        return self.dropped.sum()


pytree.register_dataclass(Routing)


def _scatter_drop(fill, b: int, at: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``full(b, fill).at[at].set(v, mode="drop")`` for ``at`` in [0, b]:
    index b is the drop slot."""
    buf = torch.full((b + 1,), fill, dtype=_I64, device=at.device)
    return buf.scatter_(0, at, v)[:b]


def route(keys: torch.Tensor, bcount, *, num_keys: int, bcap: int) -> Routing:
    """Bucket one tick's ``(keys, payload)`` batch into per-key segments.

    ``keys`` is [b]; rows at or past ``bcount`` (a 0-d tensor or an int)
    are ignored, and rows whose key id falls outside [0, num_keys) are
    discarded and counted in ``Routing.invalid``, never clipped onto a real
    tenant's reservoir."""
    b = keys.shape[0]
    dev = keys.device
    keys = keys.to(_I64)
    pos = torch.arange(b, dtype=_I64, device=dev)
    in_range = (keys >= 0) & (keys < num_keys)
    valid = pos < bcount
    invalid = (valid & ~in_range).sum()
    valid = valid & in_range
    mk = torch.where(valid, keys, num_keys)
    order = torch.argsort(mk, stable=True)            # arrival order per key
    sk = mk[order]                                    # key-contiguous
    prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
    is_start = (sk != prev) & (sk < num_keys)
    seg = torch.cumsum(is_start.to(_I64), 0) - 1      # segment id per row
    nt = is_start.sum()

    live = sk < num_keys
    at = torch.where(is_start, seg, b)
    touched = _scatter_drop(num_keys, b, at, sk)
    starts = _scatter_drop(0, b, at, pos)
    raw = torch.zeros((b + 1,), dtype=_I64, device=dev).index_add_(
        0, torch.where(live, seg, b), torch.ones_like(seg))[:b]
    counts = torch.clamp(raw, max=bcap)
    return Routing(order=order, touched=touched, ntouched=nt, starts=starts,
                   counts=counts, dropped=raw - counts, invalid=invalid)


@dataclasses.dataclass
class ShardedBatch:
    """A co-partitioned tick compacted for :func:`route`: ``rows`` [R] are
    the source rows of the R routed rows (the shards' valid rows in shard
    order, each shard's in arrival order; rows past ``count`` repeat row 0),
    ``keys`` [R] their GLOBAL ids (local id + s K_s; -1 for a local id
    outside [0, K_s), which ``route`` discards), ``count`` [] the tick's
    valid rows and ``invalid`` [S] each shard's valid rows with an
    out-of-range local id."""

    rows: torch.Tensor      # [R]
    keys: torch.Tensor      # [R]
    count: torch.Tensor     # []
    invalid: torch.Tensor   # [S]


pytree.register_dataclass(ShardedBatch)


def compact_shards(keys: torch.Tensor, bcount: torch.Tensor, *, num_keys: int,
                   rows: int | None = None) -> ShardedBatch:
    """Compact one co-partitioned tick: ``keys`` [S * b_s] local ids, shard
    s owning rows [s b_s, (s + 1) b_s) of which the first ``bcount[s]`` are
    valid; ``num_keys`` is K_s, the keys of one shard. The result has
    ``rows`` rows (default S * b_s), which must be at least the tick's
    valid count: a valid row past them is dropped. Nothing is read on the
    host."""
    S = bcount.shape[-1]
    b_s = keys.shape[0] // S
    R = S * b_s if rows is None else int(rows)
    dev = keys.device
    k = keys.to(_I64).reshape(S, b_s)
    bc = bcount.to(_I64)
    pos = torch.arange(b_s, dtype=_I64, device=dev)
    valid = pos < bc.unsqueeze(-1)                                   # [S, b_s]
    in_range = (k >= 0) & (k < num_keys)
    base = torch.arange(S, dtype=_I64, device=dev).unsqueeze(-1) * num_keys
    gk = torch.where(in_range, k + base, -1)
    start = torch.cumsum(bc, 0) - bc                                 # each shard's offset
    dest = torch.where(valid, start.unsqueeze(-1) + pos, R).clamp(max=R).reshape(-1)
    src = torch.zeros((R + 1,), dtype=_I64, device=dev).scatter_(
        0, dest, torch.arange(S * b_s, dtype=_I64, device=dev))[:R]
    gkeys = torch.full((R + 1,), -1, dtype=_I64, device=dev).scatter_(
        0, dest, gk.reshape(-1))[:R]
    return ShardedBatch(rows=src, keys=gkeys, count=bc.sum(),
                        invalid=(valid & ~in_range).sum(-1))


def subbatches(r: Routing, payload, *, bcap: int):
    """Each touched key's sub-batch, leaves [b, ...] -> [b, bcap, ...]: row t
    holds touched key t's items in its first ``r.counts[t]`` slots (arrival
    order); the slots past the count hold neighbouring keys' rows, which the
    step masks by its count. The bank's payload pass (B3) reads these rows
    straight from the payload and never builds this tensor; it is the
    reference and the per-key eval windows' source."""

    def one(leaf):
        flat = leaf.reshape(leaf.shape[0], -1)
        sub = _ts_ref.subbatches_ref(flat, r.order, r.starts, bcap)
        return sub.reshape((leaf.shape[0], bcap) + tuple(leaf.shape[1:]))

    return pytree.tree_map(one, payload)
