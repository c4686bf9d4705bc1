"""Plain PyTorch versions of B5, the Mamba2 SSD chunked scan.

:func:`ssd_ref` is the JAX package's ``kernels/ssd_scan/ref.py::ssd_ref``:
the exact per-token recurrence

    state_t = exp(dt_t * a) state_(t-1) + dt_t * B_t (x) x_t
    y_t     = C_t . state_t

in f32, the ground truth every chunked form is held against.
:func:`ssd_scan_ref` computes what the TPU kernel computes
(``kernels/ssd_scan/kernel.py::_kernel``), chunk by chunk in f32 in the
model's layout: the CPU path of :func:`..ops.ssd_scan`, and what
``chip_smoke.py`` and the card tests hold the CUDA kernel against.
:func:`ssd_chunked_ref` is the JAX model's jnp ``ssd_chunked``
(``models/ssm.py``) line for line: the Mamba2 model's CPU route, and the
function whose gradient B5's backward takes, as JAX differentiates it.
"""
from __future__ import annotations

import torch

from repro_torch.remat import remat


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor):
    """x [BH,S,P]; dt [BH,S]; a [BH]; Bm/Cm [BH,S,N] (pre-broadcast per head)
    -> (y [BH,S,P] in x's dtype, final state [BH,N,P] f32)."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bm, Cm))
    af = a.float()
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]
        da = torch.exp(dt_t * af)
        state = state * da[:, None, None] + torch.einsum(
            "b,bn,bp->bnp", dt_t, bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_ref_model_layout(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor):
    """:func:`ssd_ref` over the model layout (x [B,S,H,P], dt [B,S,H], a [H],
    Bm/Cm [B,S,G,N]; head h reads group h // (H // G)) -> (y [B,S,H,P],
    state [B,H,N,P]), as ``tests/test_kernels.py`` lays its oracle out."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]

    def per_head(t):  # [B,S,G,N] -> [B*H,S,N]
        return t.repeat_interleave(H // G, dim=2).transpose(1, 2).reshape(B * H, S, N)

    y, st = ssd_ref(x.transpose(1, 2).reshape(B * H, S, P),
                    dt.transpose(1, 2).reshape(B * H, S), a.repeat(B),
                    per_head(Bm), per_head(Cm))
    return y.reshape(B, H, S, P).transpose(1, 2), st.reshape(B, H, N, P)


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B,Q,G,N] -> [B,Q,H,N] f32: head h reads group h // rep."""
    return t.float().repeat_interleave(rep, dim=2)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, *, chunk: int, init_state: torch.Tensor | None = None):
    """x [B,S,H,P]; dt [B,S,H] f32; a [H] f32; Bm/Cm [B,S,G,N] -> (y [B,S,H,P]
    in x's dtype, final state [B,H,N,P] f32). Per chunk of Q = min(chunk, S)
    tokens, in f32: the causal scores (C_i . B_j) exp(cl_i - cl_j) dt_j for
    j <= i (selected, never multiplied by a mask: the upper triangle's exp
    may be inf), the inter-chunk term exp(cl_i) C_i . state, and the state
    update; ``cl`` is the in-chunk cumulative sum of dt * a. y is cast to
    x's dtype once, at the end."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    af = a.float()
    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ii = torch.arange(Q, device=x.device)
    tri = ii[:, None] >= ii[None, :]
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x_n, dt_n = x[:, sl].float(), dt[:, sl].float()            # [B,Q,H,P], [B,Q,H]
        B_n, C_n = _heads(Bm[:, sl], rep), _heads(Cm[:, sl], rep)  # [B,Q,H,N]
        cl = torch.cumsum(dt_n * af, dim=1)                         # [B,Q,H]
        clh = cl.transpose(1, 2)                                    # [B,H,Q]
        cb = torch.einsum("bihn,bjhn->bhij", C_n, B_n)
        decay = torch.exp(clh[..., :, None] - clh[..., None, :])
        scores = torch.where(tri, cb * decay * dt_n.transpose(1, 2)[:, :, None, :], 0.0)
        y = torch.einsum("bhij,bjhp->bihp", scores, x_n)
        y = y + torch.exp(cl)[..., None] * torch.einsum("bihn,bhnp->bihp", C_n, state)
        w = torch.exp(cl[:, -1:] - cl) * dt_n                       # [B,Q,H]
        state = state * torch.exp(cl[:, -1])[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", B_n * w[..., None], x_n)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, *, chunk: int, init_state: torch.Tensor | None = None):
    """The JAX model's chunked SSD in its own order of operations (scores and
    the inter-chunk term rounded to x's dtype before they are summed): x
    [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (< 0), Bm/Cm [B,S,G,N] ->
    (y [B,S,H,P] in x's dtype, final state [B,H,N,P] f32), by chunks of
    ``chunk`` tokens (which must divide S). Groups reach heads through
    ``expand``, never ``repeat_interleave``, so the backward sums them
    without atomics. One departure, which changes no forward value: the
    decay's exponent is masked before its ``exp`` (below), so the gradient
    stays finite where JAX's overflows to NaN."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = S // Q
    rep = H // G

    def chunk_view(t):  # [B,S,...] -> [B,nc,Q,...]
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xc, dtc = chunk_view(x), chunk_view(dt)
    Bc, Cc = chunk_view(Bm), chunk_view(Cm)

    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ii = torch.arange(Q, device=x.device)
    tri = ii[:, None] >= ii[None, :]

    def body(state, x_n, dt_n, B_n, C_n):
        # one chunk: intra-chunk quadratic part + inter-chunk state
        la = (dt_n * A[None, None, :]).float()                   # [B,Q,H]
        cl = torch.cumsum(la, dim=1)                             # [B,Q,H]
        clh = cl.transpose(1, 2)                                 # [B,H,Q]
        # intra: scores[i,j] = (C_i.B_j) exp(cl_i - cl_j) dt_j for j<=i
        CB = torch.einsum("bqgs,bkgs->bgqk", C_n, B_n)           # [B,G,Q,Q]
        CB = CB[:, :, None].expand(Bsz, G, rep, Q, Q).reshape(Bsz, H, Q, Q)
        # the exponent's upper triangle is masked to -inf BEFORE the exp: its
        # exp(cl_i - cl_j), j > i, overflows to inf at mamba2_370m's chunk of
        # 256, and the where's zero cotangent times inf would turn every
        # gradient into NaN (JAX's jnp form does, ROADMAP C.13); the kept
        # entries, and so the forward, are bit for bit JAX's
        decay = torch.exp(torch.where(tri[None, None], clh[..., :, None] - clh[..., None, :],
                                      -torch.inf))
        scores = CB.float() * decay * dt_n.transpose(1, 2)[:, :, None, :]
        scores = torch.where(tri[None, None], scores, 0.0)
        y_intra = torch.einsum("bhqk,bkhp->bqhp", scores.to(x.dtype), x_n)
        # inter: y_inter[i] = C_i . (state_prev * exp(cl_i))
        Ch = C_n.reshape(Bsz, Q, G, 1, N).expand(Bsz, Q, G, rep, N).reshape(Bsz, Q, H, N)
        y_inter = torch.einsum("bqhs,bhsp,bqh->bqhp", Ch.float(), state, torch.exp(cl))
        # state update: state = state * exp(cl_last) + sum_j exp(cl_last-cl_j) dt_j B_j x_j
        w = torch.exp(cl[:, -1:, :] - cl) * dt_n                 # [B,Q,H]
        Bh = B_n.reshape(Bsz, Q, G, 1, N).expand(Bsz, Q, G, rep, N).reshape(Bsz, Q, H, N)
        st_n = torch.einsum("bqh,bqhs,bqhp->bhsp", w.float(), Bh.float(), x_n.float())
        state = state * torch.exp(cl[:, -1])[:, :, None, None] + st_n
        return state, y_intra + y_inter.to(x.dtype)

    ys = []
    for c in range(nc):
        # under grad mode each chunk body is checkpointed, as JAX's
        # ``lax.scan(jax.checkpoint(body))`` is: its backward keeps one
        # chunk's [B, H, Q, Q] intermediates at a time
        state, y_n = remat(body, state, xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c])
        ys.append(y_n)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, state
