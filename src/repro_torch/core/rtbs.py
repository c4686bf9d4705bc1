"""R-TBS: Reservoir-based Time-Biased Sampling (paper Algorithm 2), fused.

Invariant maintained (Theorem 4.2): Pr[i in S_t] = (C_t / W_t) * w_t(i).

State: the latent sample (capacity n+1 slots) and the total weight W_t.
Each :func:`step` composes the whole tick's buffer rewrite (decay
downsample, batch insert, overshoot downsample, or victim replacement) into
ONE slot map over two sources, the old reservoir (``src < cap``) and the
arriving batch (``src >= cap``), in O(cap + bcap) integer ops, then moves
the payload in one pass through the B1 kernel
(:func:`repro_torch.kernels.tbs_step.ops.tbs_step_apply`).

Both branches of Alg. 2 are computed on every tick and selected with
``torch.where`` (the JAX package's ``lax.cond``), so the tick never asks the
host which branch it is in. The scalars (``nfull``, ``weight``,
``total_weight``, ``bcount``, the decay factor) stay device tensors in f32
or int64; the C_t/W_t arithmetic repeats the JAX op order exactly.

:func:`step_ref` is the pre-fused reference step: per-stage buffer
rewrites with exact argsort permutations, one reservoir, its Alg. 2
branch chosen on the host. It is the parity oracle of the fused step and
is not on the card's path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.tbs_step import ops as tbs_ops
from repro_torch.obs.profile import scope as _scope

from . import latent as lt
from . import prng, rng

_I64, _F32 = torch.int64, torch.float32


@dataclasses.dataclass
class RTBSState:
    lat: lt.Latent
    total_weight: torch.Tensor   # float32 [...], W_t


pytree.register_dataclass(RTBSState)


def init(item_proto: Any, n: int) -> RTBSState:
    """Empty R-TBS state with max sample size n (buffer capacity n+1), on
    the device of ``item_proto``'s tensors."""
    lat = lt.make_empty(item_proto, n + 1)
    return RTBSState(lat=lat, total_weight=torch.zeros_like(lat.weight))


@dataclasses.dataclass
class TickDraws:
    """Every draw of one tick. JAX splits the tick key five ways,
    ``k_ds, k_over, k_m, k_vic, k_pick``: the stage-1 and overshoot
    downsample maps, the stochastic round of the victim count, and the
    victim and pick permutations."""

    ds: lt.DownsampleDraws
    over: lt.DownsampleDraws
    u_m: torch.Tensor          # f32 [...]
    rb_vic: torch.Tensor       # int64 [..., rounds, 2]
    rb_pick: torch.Tensor      # int64 [..., rounds, 2]


def draw_tick(key, *, cap: int, bcap: int, device,
              batch=()) -> TickDraws:
    """One tick's draws with leading dimensions ``batch`` from a host key,
    or one row of draws per row of a key tensor ``[T, 2]`` (``batch``
    empty): the keyed bank's per-key draws, row t equal to the host draw
    of key t."""
    k_ds, k_over, k_m, k_vic, k_pick = prng.split(key, 5)
    batch = tuple(batch)
    return TickDraws(
        ds=lt.draw_downsample(k_ds, cap, device, max_deleted=bcap, batch=batch),
        over=lt.draw_downsample(k_over, cap + bcap, device, max_deleted=bcap,
                                batch=batch),
        u_m=prng.uniform(k_m, batch, device),
        rb_vic=rng.draw_son_bits(k_vic, batch, device),
        rb_pick=rng.draw_son_bits(k_pick, batch, device),
    )


def tick_map(draws: TickDraws, nfull, weight, total_weight, bcount, decay, *,
             cap: int, bcap: int, n: int):
    """Compose the whole tick's buffer rewrite into ONE slot map.

    Returns ``(src [..., cap] int32, new_sample_weight, w_new)``: ``src``
    values in [0, cap) read the old reservoir, values in [cap, cap + bcap)
    read batch row ``src - cap``; int32, the B1 kernel's index type, so the
    payload pass reads it as it is. Scalars may carry leading batch
    dimensions."""
    bf = bcount.to(_F32)
    bcnt = bcount.to(_I64)
    w_prev = total_weight
    C = weight
    dev = C.device
    was_unsat = w_prev < n
    w_dec = decay * w_prev
    w_new = w_dec + bf                 # both Alg. 2 branches decay then add B
    still_sat = (~was_unsat) & (w_new >= n)
    nf = float(n)                      # exact in f32 for n < 2^24

    # ---- insert path (Alg. 2 lines 5-12 / 19-20) ----
    V = cap + bcap
    t1 = torch.where(was_unsat, w_dec, w_new - bf)
    apply1 = torch.where(was_unsat, (w_dec > 0) & (w_dec < C), True)
    ident_cap = torch.arange(cap, dtype=_I64, device=dev)
    src1 = torch.where(
        apply1.unsqueeze(-1),
        lt.downsample_map(draws.ds, cap, C, t1, max_deleted=bcap,
                          gate=apply1 & ~still_sat),
        ident_cap,
    )
    C1 = torch.where(apply1, torch.minimum(t1, C),
                     torch.minimum(C, torch.clamp(t1, min=0.0)))
    k1, _ = lt.floor_frac(C1)
    j = torch.arange(V, dtype=_I64, device=dev)
    src1_at = torch.gather(src1, -1, torch.clamp(j, max=cap - 1).expand(
        src1.shape[:-1] + (V,)))
    k1e, bce = k1.unsqueeze(-1), bcnt.unsqueeze(-1)
    partial_src = lt._take(src1, torch.clamp(k1, max=cap - 1)).unsqueeze(-1)
    mid = torch.where(
        j < k1e, src1_at,
        torch.where(j < k1e + bce, cap + (j - k1e),
                    torch.where(j == k1e + bce, partial_src, j)))
    C2 = C1 + bf
    overshoot = was_unsat & (C2 > nf)
    src2 = torch.where(
        overshoot.unsqueeze(-1),
        lt.downsample_map(draws.over, V, C2, torch.full_like(C2, nf),
                          max_deleted=bcap, gate=overshoot & ~still_sat),
        j,
    )
    src_ins = torch.gather(mid, -1, src2[..., :cap])
    C3_ins = torch.where(overshoot, nf, C2)

    # ---- replace path (Alg. 2 lines 16-17) ----
    m = rng.stochastic_round(draws.u_m, bf * n / torch.clamp(w_new, min=1e-30))
    victims = rng.prefix_permutation_fast(draws.rb_vic, cap, nfull.to(_I64),
                                          k=bcap)
    picks = rng.prefix_permutation_fast(draws.rb_pick, bcap, bcnt, k=bcap)
    i = torch.arange(bcap, dtype=_I64, device=dev)
    dest = torch.where(i < m.unsqueeze(-1), victims, cap).clamp(0, cap)
    buf = torch.cat([ident_cap.expand(dest.shape[:-1] + (cap,)),
                     dest.new_zeros(dest.shape[:-1] + (1,))], dim=-1)
    src_rep = buf.scatter(-1, dest, cap + picks)[..., :cap]

    src = torch.where(still_sat.unsqueeze(-1), src_rep, src_ins).to(torch.int32)
    C3 = torch.where(still_sat, nf, C3_ins)
    return src, C3, w_new


def _resolve_decay(lam, decay, device) -> torch.Tensor:
    """The tick's decay factor as an f32 device tensor, from ``lam``
    (``exp(-lam)`` computed on the host in double and rounded to f32, as
    :func:`repro_torch.decay.exponential` does) or from the factor itself."""
    if (lam is None) == (decay is None):
        raise ValueError(f"pass exactly one of lam= or decay=; got lam={lam!r}, "
                         f"decay={decay!r}")
    if decay is None:
        return torch.full((), math.exp(-float(lam)), dtype=_F32, device=device)
    if isinstance(decay, torch.Tensor):
        return decay.to(device=device, dtype=_F32)
    return torch.full((), float(decay), dtype=_F32, device=device)


def step_with(draws: TickDraws, state: RTBSState, batch_items: Any,
              bcount: torch.Tensor, *, n: int, decay: torch.Tensor) -> RTBSState:
    """One fused tick from given draws: the composed map, then one B1
    payload pass per item leaf."""
    bcap = pytree.tree_leaves(batch_items)[0].shape[0]
    if state.total_weight.dim():   # trials share one batch: expand it
        lead = state.total_weight.shape
        batch_items = pytree.tree_map(lambda b: b.expand(lead + b.shape),
                                      batch_items)
    with _scope("rtbs.tick_map"):
        src, C3, w_new = tick_map(draws, state.lat.nfull, state.lat.weight,
                                  state.total_weight, bcount, decay,
                                  cap=state.lat.cap, bcap=bcap, n=n)
        k3, _ = lt.floor_frac(C3)
    with _scope("rtbs.payload"):
        new_items = tbs_ops.tbs_step_apply(state.lat.items, batch_items, src)
    return RTBSState(lat=lt.Latent(items=new_items, nfull=k3, weight=C3),
                     total_weight=w_new)


def step(key: prng.Key, state: RTBSState, batch_items: Any, bcount, *, n: int,
         lam: float | None = None, decay=None) -> RTBSState:
    """Advance R-TBS by one batch arrival (paper Algorithm 2), fused.

    ``batch_items``: pytree, leaves [bcap, ...], valid prefix ``bcount``
    (a 0-d device tensor). Pass exactly one of ``lam`` and ``decay`` (the
    per-tick multiplicative factor, a float or an f32 device tensor)."""
    dev = state.total_weight.device
    decay = _resolve_decay(lam, decay, dev)
    if not isinstance(bcount, torch.Tensor):
        bcount = torch.full((), int(bcount), dtype=_I64, device=dev)
    bcap = pytree.tree_leaves(batch_items)[0].shape[0]
    draws = draw_tick(key, cap=state.lat.cap, bcap=bcap, device=dev)
    return step_with(draws, state, batch_items, bcount, n=n, decay=decay)


# ---------------------------------------------------------------------------
# the reference step: per-stage buffer rewrites, exact argsort permutations
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RefDraws:
    """Every draw :func:`step_ref` may use. JAX splits the tick key two
    ways for the unsaturated path (``k_ds, k_over``: the decay and
    overshoot downsamples) and four ways for the saturated one (``k_m,
    k_vic, k_pick, k_ds``: the victim count, the victim and pick
    permutations, the undershoot downsample)."""

    ds: lt.ExactDownsampleDraws       # unsaturated decay downsample, cap
    over: lt.ExactDownsampleDraws     # overshoot downsample, cap + bcap
    u_m: torch.Tensor                 # f32 []
    u_vic: torch.Tensor               # f32 [cap]
    u_pick: torch.Tensor              # f32 [bcap]
    sat_ds: lt.ExactDownsampleDraws   # undershoot downsample, cap


def draw_ref(key, *, cap: int, bcap: int, device) -> RefDraws:
    """Both paths' draws from one tick key, as JAX splits it."""
    k_ds, k_over = prng.split(key)
    k_m, k_vic, k_pick, k_sds = prng.split(key, 4)
    return RefDraws(
        ds=lt.draw_downsample_exact(k_ds, cap, device),
        over=lt.draw_downsample_exact(k_over, cap + bcap, device),
        u_m=prng.uniform(k_m, (), device),
        u_vic=rng.draw_prefix_permutation(k_vic, cap, (), device),
        u_pick=rng.draw_prefix_permutation(k_pick, bcap, (), device),
        sat_ds=lt.draw_downsample_exact(k_sds, cap, device))


def _unsaturated_path(draws: RefDraws, lat: lt.Latent, w_prev, batch_items, bcount,
                      n: int, decay):
    """Paper Alg. 2 lines 5-12 (previously unsaturated: C == W < n)."""
    w_dec = decay * w_prev
    # lines 6-8: decay the weight, downsample the latent to it
    if bool((w_dec > 0) & (w_dec < lat.weight)):
        lat = lt.downsample(draws.ds, lat, w_dec)
    else:
        lat = lt.Latent(items=lat.items, nfull=lat.nfull,
                        weight=torch.minimum(lat.weight, torch.clamp(w_dec, min=0.0)))
    # lines 9-10: accept ALL batch items, on a widened buffer
    cap = lat.cap
    wide = lt.Latent(items=lt.concat_items(lat.items, pytree.tree_map(torch.zeros_like,
                                                                      batch_items)),
                     nfull=lat.nfull, weight=lat.weight)
    wide = lt.insert_full(wide, batch_items, bcount)
    w_new = w_dec + bcount.to(_F32)
    # lines 11-12: overshoot -> downsample to n
    if bool(wide.weight > n):
        wide = lt.downsample(draws.over, wide, torch.full_like(wide.weight, float(n)))
    return lt.Latent(items=lt.truncate_items(wide.items, cap), nfull=wide.nfull,
                     weight=wide.weight), w_new


def _saturated_path(draws: RefDraws, lat: lt.Latent, w_prev, batch_items, bcount,
                    n: int, decay):
    """Paper Alg. 2 lines 14-20 (previously saturated: C == n <= W). W is
    rounded once here (:func:`latent.fma_f32`): XLA contracts the jitted JAX
    reference's ``decay * w_prev + bf``, whose product has no other use."""
    bf = bcount.to(_F32)
    w_new = lt.fma_f32(decay, w_prev, bf)
    if not bool(w_new >= n):
        # lines 19-20: downsample to W - B, then accept all batch items
        l2 = lt.downsample(draws.sat_ds, lat, w_new - bf)
        return lt.insert_full(l2, batch_items, bcount), w_new
    # lines 16-17: replace m = StochRound(B n / W) victims with batch items
    cap = lat.cap
    bcap = pytree.tree_leaves(batch_items)[0].shape[0]
    m = rng.stochastic_round(draws.u_m, bf * n / torch.clamp(w_new, min=1e-30))
    victims = rng.prefix_permutation(draws.u_vic, cap, lat.nfull)
    picks = rng.prefix_permutation(draws.u_pick, bcap, bcount)
    i = torch.arange(bcap, dtype=_I64, device=m.device)
    dest = torch.where(i < m, victims[torch.clamp(i, max=cap - 1)], cap)   # cap: dropped
    payload = lt.gather(batch_items, picks)

    def put(a, b):
        buf = torch.cat([a, torch.zeros_like(a[:1])])
        buf.index_copy_(0, dest, b)
        return buf[:cap]

    items = pytree.tree_map(put, lat.items, payload)
    return lt.Latent(items=items, nfull=lat.nfull,
                     weight=torch.full_like(lat.weight, float(n))), w_new


def step_ref_with(draws: RefDraws, state: RTBSState, batch_items: Any,
                  bcount: torch.Tensor, *, n: int, decay: torch.Tensor) -> RTBSState:
    """The reference step from given draws (one reservoir)."""
    bcount = bcount.to(_I64)
    path = _unsaturated_path if bool(state.total_weight < n) else _saturated_path
    lat, w_new = path(draws, state.lat, state.total_weight, batch_items, bcount, n, decay)
    return RTBSState(lat=lat, total_weight=w_new)


def step_ref(key: prng.Key, state: RTBSState, batch_items: Any, bcount, *, n: int,
             lam: float | None = None, decay=None) -> RTBSState:
    """The pre-fused R-TBS step (JAX's ``rtbs.step_ref``): per-stage buffer
    rewrites with exact argsort permutations, 2-4 sorts and several gathers
    a tick, its branch read on the host. The parity oracle of :func:`step`;
    same C_t / W_t trajectories, another RNG stream."""
    dev = state.total_weight.device
    decay = _resolve_decay(lam, decay, dev)
    if not isinstance(bcount, torch.Tensor):
        bcount = torch.full((), int(bcount), dtype=_I64, device=dev)
    bcap = pytree.tree_leaves(batch_items)[0].shape[0]
    draws = draw_ref(key, cap=state.lat.cap, bcap=bcap, device=dev)
    return step_ref_with(draws, state, batch_items, bcount, n=n, decay=decay)


def realize(key: prng.Key, state: RTBSState):
    """Draw the actual sample S_t: (mask over the n+1 slots, |S_t|). A key
    tensor draws each leading row of ``state`` from its own key."""
    return lt.realize(prng.uniform_for(key, state.lat.weight), state.lat)


def run_stream(key: prng.Key, state: RTBSState, batches: Any,
               bcounts: torch.Tensor, *, n: int, lam: float | None = None,
               decay=None, use_ref: bool = False):
    """Step over a stream of T batches (tick t uses ``split(key, T)[t]``);
    returns the final state and the per-tick trace {"C": [T], "W": [T]}.
    ``use_ref`` steps with :func:`step_ref` instead."""
    T = bcounts.shape[0]
    keys = prng.split(key, T)
    stepper = step_ref if use_ref else step
    Cs, Ws = [], []
    for t in range(T):
        batch_t = pytree.tree_map(lambda a: a[t], batches)
        state = stepper(keys[t], state, batch_t, bcounts[t], n=n, lam=lam,
                        decay=decay)
        Cs.append(state.lat.weight)
        Ws.append(state.total_weight)
    return state, {"C": torch.stack(Cs), "W": torch.stack(Ws)}
