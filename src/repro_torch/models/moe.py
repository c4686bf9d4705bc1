"""Mixture-of-Experts layer: top-k routing with capacity-bounded sort-based
dispatch (fixed shapes, honest active-expert FLOPs).

The port of the JAX package's ``models/moe.py``. Dispatch flattens the
tokens, sorts the assignments by expert id (stable), takes each one's
position in its expert from the segment start (a scatter-min), scatters the
kept ones into an [E, C, D] buffer (positions past the capacity C are
dropped), runs the per-expert products as batched matmuls over the experts
(JAX computes them outside any Pallas kernel too) and combines the outputs
weighted by the router gate.

JAX's ``vmap`` over the dispatch groups is a leading [G] dimension here.
JAX's combine is a scatter-add ``.at[token].add`` over the sorted
assignments; XLA:CPU adds each token's K contributions one by one in that
order, starting from zeros. On the card ``index_add_`` would add them
through atomics, in an order that changes from run to run, so the combine
gathers each token's K contributions into [N, K, D] in sorted-assignment
order (ascending expert id: a token's K experts are distinct) and sums them
in that order: deterministic, and JAX's order. The dispatch's gather of each
token's row for its K assignments has the same trouble in its backward, a
scatter-add over repeated token indices; :class:`_DispatchRows` sums each
token's K cotangent rows in the same fixed order instead (ROADMAP C.20).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.obs.profile import scope

from . import layers as L


def moe_params(cfg, gen: torch.Generator) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = L.param_dtype(cfg)
    return {
        "router": L.dense_init(gen, (d, e), pd),
        "wg": L.dense_init(gen, (e, d, f), pd, fan_in=d),
        "wi": L.dense_init(gen, (e, d, f), pd, fan_in=d),
        "wo": L.dense_init(gen, (e, f, d), pd, fan_in=f),
    }


def capacity(cfg, n_tokens: int) -> int:
    c = int(cfg.moe_capacity_factor * n_tokens * cfg.num_experts_per_tok
            / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


@dataclasses.dataclass
class Route:
    """One dispatch, each field with a leading [G] (the groups): ``gates``
    and ``eidx`` [G, N, K] (renormalised top-k gates and their experts),
    then over the N*K assignments in sorted order: ``order`` (the flat
    assignment n*K + j at each sorted position), ``dest`` (slot e*C + pos in
    the [E*C] buffer, E*C where dropped) and ``keep`` (pos < C)."""
    gates: torch.Tensor
    eidx: torch.Tensor
    order: torch.Tensor
    dest: torch.Tensor
    keep: torch.Tensor


def route(cfg, p, xf: torch.Tensor) -> Route:
    """The router and the sort-based positions of ``xf`` [G, N, D]."""
    G, N, _ = xf.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, N)
    logits = (xf @ p["router"].to(xf.dtype)).float()
    gate_all = torch.softmax(logits, dim=-1)
    # top-k as lax.top_k takes it: equal gates go to the lower expert first
    # (torch.topk breaks such ties otherwise), so a stable descending sort
    gates, eidx = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :K], eidx[..., :K]              # [G, N, K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(G, N * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    # position within its expert's segment = index - start of the segment
    idx = torch.arange(N * K, device=xf.device).expand(G, N * K)
    seg_start = torch.full((G, E), N * K, dtype=torch.int64, device=xf.device)
    seg_start = seg_start.scatter_reduce(1, se, idx, reduce="amin")
    pos_in_e = idx - torch.gather(seg_start, 1, se)
    keep = pos_in_e < C                                       # capacity drop
    dest = torch.where(keep, se * C + pos_in_e, E * C)        # E*C => dropped
    return Route(gates=gates, eidx=eidx, order=order, dest=dest, keep=keep)


def _experts(cfg, p, xe: torch.Tensor) -> torch.Tensor:
    """xe [E, M, D] -> [E, M, D]: each expert's MLP as one batched matmul."""
    dt = xe.dtype
    if cfg.act == "swiglu":
        g = torch.bmm(xe, p["wg"].to(dt))
        h = torch.bmm(xe, p["wi"].to(dt))
        h = F.silu(g) * h
    else:
        h = F.gelu(torch.bmm(xe, p["wi"].to(dt)), approximate="tanh")
    return torch.bmm(h, p["wo"].to(dt))


def _token_positions(order: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """[G, N*K]: each token's K sorted positions, ascending, token after
    token -- the inverse of ``order`` (flat assignment -> its sorted
    position), sorted within each token's K."""
    G, NK = order.shape
    idx = torch.arange(NK, device=order.device).expand(G, NK)
    pos = torch.empty_like(order).scatter_(1, order, idx)
    return torch.sort(pos.reshape(G, n_tokens, NK // n_tokens), dim=-1).values.reshape(G, NK)


class _DispatchRows(torch.autograd.Function):
    """``xf`` [G, N, D] -> its rows at ``tok`` [G, N*K] (the token of each
    sorted assignment), as ``torch.gather`` gives them. The gather's own
    backward is a scatter-add over repeated token indices, which the card
    adds through atomics in an order that changes from run to run; this
    backward gathers each token's K cotangent rows at its sorted positions
    ``pos`` (:func:`_token_positions`) and sums them in f32 from zeros in
    that order, rounding once to the cotangent's dtype: what the CPU's
    scatter-add does (it adds in index order, bfloat16 through an f32
    accumulator), so bit for bit the gather's gradient on the CPU, and the
    same on every run on the card."""

    @staticmethod
    def forward(ctx, xf, tok, pos):
        ctx.save_for_backward(pos)
        ctx.n_tokens = xf.shape[1]
        G, NK = tok.shape
        return torch.gather(xf, 1, tok[..., None].expand(G, NK, xf.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        G, NK, D = g.shape
        rows = torch.gather(g, 1, pos[..., None].expand(G, NK, D))
        rows = rows.reshape(G, ctx.n_tokens, NK // ctx.n_tokens, D)
        return _sum_in_order(rows, torch.float32).to(g.dtype), None, None


def combine(r: Route, ye: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """ye [G, E*C, D] -> [G, N, D]: each token's K kept outputs times their
    gates, summed from zeros in sorted-assignment order (see the module's
    docstring); dropped assignments add zero."""
    G, NK = r.order.shape
    K, D = NK // n_tokens, ye.shape[-1]
    pos = _token_positions(r.order, n_tokens)
    src = torch.gather(torch.where(r.keep, r.dest, 0), 1, pos)
    gate = torch.where(r.keep, torch.gather(r.gates.reshape(G, NK), 1, r.order), 0.0)
    parts = torch.gather(ye, 1, src[..., None].expand(G, NK, D)) \
        * torch.gather(gate, 1, pos)[..., None].to(ye.dtype)
    return _sum_in_order(parts.reshape(G, n_tokens, K, D))


def _sum_in_order(parts: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """[G, N, K, D] -> [G, N, D]: the K rows of each token added one by one
    from zeros, first to last, in ``dtype`` (default: the parts')."""
    out = torch.zeros_like(parts[:, :, 0], dtype=dtype)
    for j in range(parts.shape[2]):
        out = out + parts[:, :, j]
    return out


def _moe_groups(cfg, p, xf: torch.Tensor) -> torch.Tensor:
    """xf [G, N, D] -> [G, N, D]: JAX's ``_moe_group`` under ``vmap``."""
    G, N, D = xf.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, N)
    with scope("lm.moe_route"):
        r = route(cfg, p, xf)
        tok = torch.div(r.order, K, rounding_mode="floor")    # token of each assignment
        # dispatch: kept rows to their slots, dropped ones to the spare row E*C
        xe = xf.new_zeros((G, E * C + 1, D))
        xe.scatter_(1, r.dest[..., None].expand(G, N * K, D),
                    _DispatchRows.apply(xf, tok, _token_positions(r.order, N)))
        xe = xe[:, :E * C].reshape(G, E, C, D)
    with scope("lm.moe_experts"):
        ye = _experts(cfg, p, xe.transpose(0, 1).reshape(E, G * C, D))
        ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    with scope("lm.moe_combine"):
        return combine(r, ye, N)


def apply_moe(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]. Dispatch runs independently per group: the
    G = min(moe_groups, B) groups partition the flattened token axis."""
    B, S, D = x.shape
    G = max(1, min(cfg.moe_groups, B))
    return _moe_groups(cfg, p, x.reshape(G, (B * S) // G, D)).reshape(B, S, D)
