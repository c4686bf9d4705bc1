"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/ssm.py``. Prefill runs the chunked
SSD algorithm: quadratic attention-like math inside chunks of length Q plus
a linear state recurrence across chunks, carrying the [B,H,N,P] f32 state.
On CUDA tensors :func:`ssd_chunked` is kernel B5
(:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`), whose backward is the
gradient of the plain chunked form; on CPU tensors it is that plain form,
:func:`repro_torch.kernels.ssd_scan.ref.ssd_chunked_ref`, the line-for-line
twin of JAX's jnp ``ssd_chunked``, so the CPU tests hold the port's model
tightly against JAX's. The two compute one function; in
bf16 B5 rounds once, at its output, where the jnp form also rounds the
scores and the inter-chunk term. Decode is the O(1) recurrent update, plain
torch as in JAX.

Layout: x [B,S,H,P] (H heads, P=head_dim), B/C [B,S,G,N] (G groups, N=state),
dt [B,S,H], A = -exp(A_log) [H], skip D [H].
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.obs.profile import scope

from . import layers as L


def ssm_params(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    din, ns, g, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_dim = din + 2 * g * ns
    pd = L.param_dtype(cfg)
    dev = gen.device
    return {
        # fused in-projection: [z (din), xBC (din + 2*g*ns), dt (h)]
        "in_proj": L.dense_init(gen, (d, 2 * din + 2 * g * ns + h), pd, fan_in=d),
        "conv_w": L.dense_init(gen, (cfg.ssm_conv_width, conv_dim), pd,
                               fan_in=cfg.ssm_conv_width),
        "conv_b": torch.zeros((conv_dim,), dtype=pd, device=dev),
        "dt_bias": torch.zeros((h,), dtype=pd, device=dev),
        "A_log": torch.zeros((h,), dtype=pd, device=dev),
        "D": torch.ones((h,), dtype=pd, device=dev),
        "norm_scale": torch.zeros((din,), dtype=pd, device=dev),
        "out_proj": L.dense_init(gen, (din, d), pd, fan_in=din),
    }


def _split_proj(cfg, proj):
    din, ns, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups
    z = proj[..., :din]
    xBC = proj[..., din: 2 * din + 2 * g * ns]
    dt = proj[..., 2 * din + 2 * g * ns:]
    return z, xBC, dt


def _split_xbc(cfg, xBC):
    din, ns, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups
    x = xBC[..., :din]
    Bm = xBC[..., din: din + g * ns]
    Cm = xBC[..., din + g * ns:]
    return x, Bm, Cm


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^v) = logaddexp(v, 0), with no
    threshold (``F.softplus`` switches to the identity past 20)."""
    return torch.logaddexp(v, v.new_zeros(()))


def _causal_conv(cfg, p, xBC):
    """Depthwise causal conv1d + silu over [B, S, conv_dim]; the taps are
    summed from 0 in JAX's order, tap 0 first."""
    W = cfg.ssm_conv_width
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    w = p["conv_w"].to(xBC.dtype)
    out = sum(pad[:, i: i + xBC.shape[1], :] * w[i][None, None] for i in range(W))
    return F.silu(out + p["conv_b"].to(xBC.dtype))


def ssd_chunked(cfg, x, dt, A, Bm, Cm, init_state=None):
    """Chunked SSD. x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (<0),
    Bm/Cm [B,S,G,N]. Returns (y [B,S,H,P], final_state [B,H,N,P])."""
    S = x.shape[1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: chunk {Q} does not divide the sequence {S}")
    if x.device.type != "cpu":
        return ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, init_state=init_state)
    return ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=Q, init_state=init_state)


@dataclasses.dataclass
class SSMCache:
    conv: torch.Tensor    # [B, W-1, conv_dim] trailing conv inputs (compute dtype)
    state: torch.Tensor   # [B, H, N, P] SSM state (f32)


def init_ssm_cache(cfg, batch, dtype, *, device) -> SSMCache:
    din, ns, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * g * ns
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, ns, cfg.ssm_head_dim),
                          dtype=torch.float32, device=device),
    )


def apply_ssm(cfg, p, u, *, init_state=None):
    """Full-sequence Mamba2 block: u [B,S,D] -> ([B,S,D], SSMCache).
    The returned cache (final state + conv tail) makes this the prefill path."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    dt_ = u.dtype
    with scope("lm.ssm_in"):
        proj = u @ p["in_proj"].to(dt_)
    z, xBC_raw, dtv = _split_proj(cfg, proj)
    with scope("lm.conv"):
        # a copy: a view would keep the whole projection alive in the cache
        conv_tail = xBC_raw[:, -(cfg.ssm_conv_width - 1):, :].clone(
            memory_format=torch.contiguous_format)
        xBC = _causal_conv(cfg, p, xBC_raw)
    x, Bm, Cm = _split_xbc(cfg, xBC)
    Bsz, S = x.shape[0], x.shape[1]
    x = x.reshape(Bsz, S, H, P)          # views into the conv output
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    with scope("lm.ssd"):
        dtv = _softplus(dtv.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        y, final_state = ssd_chunked(cfg, x, dtv, A, Bm, Cm, init_state=init_state)
    with scope("lm.ssm_out"):
        y = y + x * p["D"].to(dt_)[None, None, :, None]
        y = y.reshape(Bsz, S, cfg.ssm_d_inner)
        y = L.rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
        out = y @ p["out_proj"].to(dt_)
    return out, SSMCache(conv=conv_tail, state=final_state)


def decode_ssm(cfg, p, u, cache: SSMCache):
    """One-token recurrent update. u: [B, 1, D]."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    dt_ = u.dtype
    Bsz = u.shape[0]
    with scope("lm.ssm_in"):
        proj = u @ p["in_proj"].to(dt_)
    z, xBC, dtv = _split_proj(cfg, proj)
    with scope("lm.conv"):
        # conv over [cache | new token]
        window = torch.cat([cache.conv, xBC], dim=1)              # [B, W, conv]
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(dt_)) \
            + p["conv_b"].to(dt_)
        xBC1 = F.silu(conv_out)[:, None, :]
    x, Bm, Cm = _split_xbc(cfg, xBC1)
    x = x.reshape(Bsz, H, P)
    Bm = Bm.reshape(Bsz, G, N)
    Cm = Cm.reshape(Bsz, G, N)
    with scope("lm.ssd"):
        dtv = _softplus(dtv[:, 0].float() + p["dt_bias"].float())     # [B,H]
        A = -torch.exp(p["A_log"].float())
        da = torch.exp(dtv * A[None])                                 # [B,H]
        rep = H // G
        Bh = Bm[:, :, None, :].expand(Bsz, G, rep, N).reshape(Bsz, H, N).float()
        Ch = Cm[:, :, None, :].expand(Bsz, G, rep, N).reshape(Bsz, H, N).float()
        state = cache.state * da[:, :, None, None] + torch.einsum(
            "bh,bhs,bhp->bhsp", dtv, Bh, x.float())
        y = torch.einsum("bhs,bhsp->bhp", Ch, state).to(dt_)
    with scope("lm.ssm_out"):
        y = y + x * p["D"].to(dt_)[None, :, None]
        y = y.reshape(Bsz, 1, cfg.ssm_d_inner)
        y = L.rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
        out = y @ p["out_proj"].to(dt_)
    return out, SSMCache(conv=window[:, 1:], state=state)
