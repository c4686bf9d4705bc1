"""The simpler members of the TBS family (the JAX package's
``repro.core.simple``), each tick composed into one slot map and moved
in one payload pass:

  * T-TBS -- targeted-size TBS (paper Alg. 1): exact eq. (1), size
             controlled only in mean (Theorem 3.1);
  * B-TBS -- Bernoulli TBS (Alg. 4): T-TBS with q = 1;
  * B-RS  -- batched reservoir sampling (Alg. 5), the paper's "Unif";
  * SW    -- a sliding window over the last n items.

All share one state: a fixed-capacity buffer with a valid prefix
``count``. T-TBS and B-TBS sizes are unbounded in theory; inserts past the
capacity are dropped and counted in ``overflow``.

JAX moves a tick's payload twice: a full-capacity gather by a permutation
(``_compact_keep``) and a scatter of the picked batch rows (``_append``).
Here both compose into ONE int32 map ``src[cap]`` over two sources, the
old buffer (``src < cap``) and the batch (``cap + row``), moved by one
launch of the B1 kernel (:func:`repro_torch.kernels.tbs_step.ops.tbs_step_apply`):

    src[s] = cap + picks[s - m]   for m <= s < min(m + k, cap)
    src[s] = perm[s]              elsewhere

with ``m`` the kept old items, ``k`` the appended batch items, ``perm``
the keep permutation (SW: its clipped ``arange`` source) and ``picks`` the
batch permutation (SW: its ``bsrc``). The map gives JAX's whole buffer,
dead tail included.

Each step is split into a ``draw_*`` of its random operands and an
evaluation (``*_step_with``) that takes them, as ``rtbs.draw_tick`` /
``rtbs.step_with`` are, so tests can feed the JAX package's bits, uniforms
and binomial results. ``count`` and ``overflow`` are int64 and
``total_weight`` f32 device tensors; no tick reads any of them on the
host. Every function broadcasts over leading trial dimensions, whose
draws come from one host key or, one key a trial, from a key tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.tbs_step import ops as tbs_ops
from repro_torch.obs.profile import scope as _scope

from . import latent as lt
from . import prng, rng

_I64, _F32 = torch.int64, torch.float32


@dataclasses.dataclass
class BufferState:
    items: Any                  # pytree, leaves [..., cap, ...]
    count: torch.Tensor         # int64 [...], the valid prefix
    total_weight: torch.Tensor  # f32 [...]: W_t (B-RS / SW: items seen)
    overflow: torch.Tensor      # int64 [...], inserts dropped by capacity

    @property
    def cap(self) -> int:
        return pytree.tree_leaves(self.items)[0].shape[self.count.dim()]


pytree.register_dataclass(BufferState)


def init(item_proto: Any, cap: int) -> BufferState:
    """Empty buffer of ``cap`` slots on the device of ``item_proto``'s
    tensors (a pytree shaped like ONE item)."""
    dev = pytree.tree_leaves(item_proto)[0].device
    items = pytree.tree_map(
        lambda p: torch.zeros((cap,) + tuple(p.shape), dtype=p.dtype, device=p.device),
        item_proto)
    zero = torch.zeros((), dtype=_I64, device=dev)
    return BufferState(items=items, count=zero, total_weight=torch.zeros((), dtype=_F32,
                                                                         device=dev),
                       overflow=zero.clone())


def compose_map(base: torch.Tensor, picks: torch.Tensor, m: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """The tick's int32 map ``[..., cap]``: ``cap + picks[s - m]`` for
    ``m <= s < m + k`` (slots past the buffer are dropped, as JAX's
    ``mode="drop"`` scatter drops them), ``base[s]`` elsewhere."""
    cap, bcap = base.shape[-1], picks.shape[-1]
    s = torch.arange(cap, dtype=_I64, device=base.device)
    m, k = m.unsqueeze(-1), k.unsqueeze(-1)
    j = torch.clamp(s - m, 0, bcap - 1)
    new = torch.gather(picks.expand(j.shape[:-1] + (bcap,)), -1, j) + cap
    return torch.where((s >= m) & (s < m + k), new, base).to(torch.int32)


def _apply(state: BufferState, batch_items: Any, src: torch.Tensor, kept: torch.Tensor,
           added: torch.Tensor, new_w: torch.Tensor) -> BufferState:
    """Move the payload by ``src`` in one B1 launch and book the count and
    overflow of ``kept + added`` items."""
    cap = state.cap
    # trials (or shards) that share one batch lack its leading dimensions:
    # expand them
    batch_items = pytree.tree_map(lambda b, a: b.expand(a.shape[:a.dim() - b.dim()] + b.shape),
                                  batch_items, state.items)
    with _scope("simple.payload"):
        items = tbs_ops.tbs_step_apply(state.items, batch_items, src)
    total = kept + added
    return BufferState(items=items, count=torch.clamp(total, max=cap),
                       total_weight=new_w,
                       overflow=state.overflow + torch.clamp(total - cap, min=0))


def _bcap(batch_items: Any, state: BufferState) -> int:
    """The batch's row count; its leaves may carry some or all of the
    state's leading dimensions."""
    a, b = pytree.tree_leaves(state.items)[0], pytree.tree_leaves(batch_items)[0]
    return b.shape[b.dim() - (a.dim() - state.count.dim())]


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F32)
    return torch.full((), float(x), dtype=_F32, device=device)


def _draw_batch(key, batch) -> tuple:
    """The shape a draw takes besides its key's rows: ``batch`` for a host
    key, nothing for a key tensor (one key a trial, ``batch`` its rows)."""
    return () if isinstance(key, torch.Tensor) else tuple(batch)


# ---------------------------------------------------------------------------
# T-TBS / B-TBS (paper Alg. 1 / Alg. 4)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TTBSDraws:
    """One T-TBS tick's draws. JAX splits the tick key
    ``k_ret, k_perm, k_acc, k_pick``: m ~ Bin(|S|, p) from ``k_ret``, the
    keep permutation from ``k_perm``, k ~ Bin(|B|, q) from ``k_acc``, the
    batch picks from ``k_pick``."""

    m: torch.Tensor          # int64 [...]
    k: torch.Tensor          # int64 [...]
    rb_perm: torch.Tensor    # int64 [..., rounds, 2]
    rb_pick: torch.Tensor    # int64 [..., rounds, 2]


def _binomial_rows(k_ret, k_acc, count, bcount, p, q, batch, lead):
    """The one H2 launch of a T-TBS tick: m's rows, then k's."""
    dev = count.device
    keys = torch.cat([rng.binomial_keys(k_ret, batch, dev).reshape(-1, 2),
                      rng.binomial_keys(k_acc, batch, dev).reshape(-1, 2)])
    counts = torch.cat([count.expand(lead).reshape(-1),
                        bcount.to(_I64).expand(lead).reshape(-1)])
    probs = torch.cat([_f32(p, dev).expand(lead).reshape(-1),
                       _f32(q, dev).expand(lead).reshape(-1)])
    return keys, counts, probs


def _lead(key, batch) -> torch.Size:
    return torch.Size(key.shape[:-1] if isinstance(key, torch.Tensor) else batch)


def draw_ttbs_rows(key, count: torch.Tensor, bcount: torch.Tensor, p, q, *,
                   batch=()) -> tuple[TTBSDraws, tuple]:
    """:func:`draw_ttbs` and the operands of its one binomial launch,
    ``(keys [2J, 2], counts [2J], probs [2J])``, m's J rows then k's."""
    k_ret, k_perm, k_acc, k_pick = prng.split(key, 4)
    batch = _draw_batch(key, batch)
    lead = _lead(key, batch)
    rows = _binomial_rows(k_ret, k_acc, count, bcount, p, q, batch, lead)
    mk = rng.binomial(*rows)
    J = mk.shape[0] // 2
    dev = count.device
    draws = TTBSDraws(m=mk[:J].reshape(lead), k=mk[J:].reshape(lead),
                      rb_perm=rng.draw_son_bits(k_perm, batch, dev),
                      rb_pick=rng.draw_son_bits(k_pick, batch, dev))
    return draws, rows


def draw_ttbs(key, count: torch.Tensor, bcount: torch.Tensor, p, q, *,
              batch=()) -> TTBSDraws:
    """A tick's draws with leading trial dimensions ``batch``: both
    binomials of every trial in one launch (H2 on the card), trial j's m
    from row j of ``split(k_ret, J)`` and its k from row j of
    ``split(k_acc, J)``, J = prod(batch). A key tensor ``[T, 2]`` (``batch``
    empty) gives one row of draws per key row, row t equal to the host
    draw of key t, all 2T binomials in one launch: the keyed bank's
    per-key draws."""
    return draw_ttbs_rows(key, count, bcount, p, q, batch=batch)[0]


def ttbs_step_with(draws: TTBSDraws, state: BufferState, batch_items: Any,
                   bcount: torch.Tensor, *, p) -> BufferState:
    """Alg. 1 from given draws: keep a uniform m-subset of the buffer at its
    head, append k uniform batch items. W_t = p W_{t-1} + B_t rounded once
    to f32 (:func:`repro_torch.core.latent.fma_f32`), as XLA contracts the jitted JAX step's
    ``p * W + B`` into a fused multiply-add."""
    cap, bcap = state.cap, _bcap(batch_items, state)
    dev = state.count.device
    with _scope("simple.tick_map"):
        perm = rng.prefix_permutation_fast(draws.rb_perm, cap, state.count)
        picks = rng.prefix_permutation_fast(draws.rb_pick, bcap, bcount.to(_I64))
        src = compose_map(perm, picks, draws.m, draws.k)
        new_w = lt.fma_f32(_f32(p, dev), state.total_weight, bcount.to(_F32))
    return _apply(state, batch_items, src, draws.m, draws.k, new_w)


def ttbs_step(key, state: BufferState, batch_items: Any, bcount: torch.Tensor, *,
              p, q) -> BufferState:
    """Paper Alg. 1: p = e^{-lam}, q = n (1 - e^{-lam}) / b."""
    with _scope("simple.tick_map"):
        draws = draw_ttbs(key, state.count, bcount, p, q, batch=state.count.shape)
    return ttbs_step_with(draws, state, batch_items, bcount, p=p)


def btbs_step(key, state: BufferState, batch_items: Any, bcount: torch.Tensor, *,
              p) -> BufferState:
    """Paper Alg. 4 (B-TBS): T-TBS with acceptance probability q = 1."""
    return ttbs_step(key, state, batch_items, bcount, p=p, q=1.0)


# ---------------------------------------------------------------------------
# B-RS (paper Alg. 5)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BRSDraws:
    """One B-RS tick's draws. JAX splits the tick key ``k_hg, k_perm,
    k_pick``: the uniform of the hypergeometric draw, then the keep and
    pick permutations."""

    u_hg: torch.Tensor       # f32 [...]
    rb_perm: torch.Tensor    # int64 [..., rounds, 2]
    rb_pick: torch.Tensor    # int64 [..., rounds, 2]


def draw_brs(key, device, *, batch=()) -> BRSDraws:
    """A tick's draws with leading trial dimensions ``batch``, or one row of
    draws per row of a key tensor."""
    k_hg, k_perm, k_pick = prng.split(key, 3)
    batch = _draw_batch(key, batch)
    return BRSDraws(u_hg=rng.draw_hypergeometric(k_hg, batch, device),
                    rb_perm=rng.draw_son_bits(k_perm, batch, device),
                    rb_pick=rng.draw_son_bits(k_pick, batch, device))


def brs_step_with(draws: BRSDraws, state: BufferState, batch_items: Any,
                  bcount: torch.Tensor, *, n: int) -> BufferState:
    """Alg. 5 from given draws: M ~ HyperGeo(C, |B|, W) new items (H3 on
    the card), keep min(n - M, |S|) old ones; W counts the items seen."""
    cap, bcap = state.cap, _bcap(batch_items, state)
    with _scope("simple.tick_map"):
        bcount = bcount.to(_I64)
        W = state.total_weight
        bf = bcount.to(_F32)
        C = torch.clamp(W + bf, max=float(n))
        M = rng.hypergeometric(draws.u_hg, C.to(_I64), bcount.expand(C.shape),
                               W.to(_I64), max_support=bcap)
        keep = torch.minimum(n - M, state.count)
        perm = rng.prefix_permutation_fast(draws.rb_perm, cap, state.count)
        picks = rng.prefix_permutation_fast(draws.rb_pick, bcap, bcount)
        src = compose_map(perm, picks, keep, M)
    return _apply(state, batch_items, src, keep, M, W + bf)


def brs_step(key, state: BufferState, batch_items: Any, bcount: torch.Tensor, *,
             n: int) -> BufferState:
    """Paper Alg. 5 (batched classical reservoir sampling, "Unif")."""
    with _scope("simple.tick_map"):
        draws = draw_brs(key, state.count.device, batch=state.count.shape)
    return brs_step_with(draws, state, batch_items, bcount, n=n)


# ---------------------------------------------------------------------------
# SW: sliding window
# ---------------------------------------------------------------------------
def sw_step(key, state: BufferState, batch_items: Any, bcount: torch.Tensor, *,
            n: int) -> BufferState:
    """The last ``n`` items in arrival order, oldest first. Deterministic:
    ``key`` is unused."""
    del key
    cap, bcap = state.cap, _bcap(batch_items, state)
    dev = state.count.device
    with _scope("simple.tick_map"):
        bcount = bcount.to(_I64)
        keep_old = torch.minimum(torch.clamp(n - bcount, min=0), state.count)
        s = torch.arange(cap, dtype=_I64, device=dev)
        ko = keep_old.unsqueeze(-1)
        base = torch.where(s < ko, s + (state.count.unsqueeze(-1) - ko), 0)
        take_new = torch.clamp(bcount, max=n).expand(keep_old.shape)
        i = torch.arange(bcap, dtype=_I64, device=dev)
        bsrc = torch.clamp(i + (bcount - take_new).unsqueeze(-1), 0, bcap - 1)
        src = compose_map(base, bsrc, keep_old, take_new)
    return _apply(state, batch_items, src, keep_old, take_new,
                  state.total_weight + bcount.to(_F32))


def realize_all(state: BufferState):
    """(mask over the cap slots, count): these schemes' samples are their
    buffers."""
    s = torch.arange(state.cap, dtype=_I64, device=state.count.device)
    return s < state.count.unsqueeze(-1), state.count
