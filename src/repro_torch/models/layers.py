"""Shared layers: norms, embeddings, rotary (RoPE + M-RoPE), sinusoidal
positions, MLPs, init.

The port of the JAX package's ``models/layers.py``. Initializers draw from a
``torch.Generator`` on the device the parameters live on; their numbers are
not JAX's (the tests carry JAX's parameters across with
:func:`repro_torch.convert.lm_params_from_numpy`)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in f32 on ``gen``'s device, cast to ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 with a scale-centred gain ``1 + scale``."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def norm_params(cfg, d: int, device) -> dict:
    pd = param_dtype(cfg)
    if cfg.act == "gelu":  # LayerNorm families (whisper)
        return {"scale": torch.ones((d,), dtype=pd, device=device),
                "bias": torch.zeros((d,), dtype=pd, device=device)}
    return {"scale": torch.zeros((d,), dtype=pd, device=device)}  # RMSNorm


def apply_norm(cfg, p, x):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# positions: RoPE, M-RoPE (qwen2-vl)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    ex = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), ex)


def apply_rope(x, positions, theta, mrope_sections=()):
    """x: [B, S, H, hd]; positions: [B, S] (broadcast to 3 streams for M-RoPE)
    or [3, B, S] for genuine multimodal t/h/w positions."""
    B, S, H, hd = x.shape
    half = hd // 2
    freqs = rope_frequencies(hd, theta, x.device)             # [half]
    if positions.dim() == 2:
        positions = positions[None].expand((3,) + tuple(positions.shape))
    if mrope_sections:
        # M-RoPE: frequency bands split into (t, h, w) sections, each driven
        # by its own position stream (arXiv:2409.12191).
        sec = np.asarray(mrope_sections)
        if sec.sum() != half:
            raise ValueError(f"mrope_sections {mrope_sections} do not sum to {half}")
        stream_of_band = torch.from_numpy(np.repeat(np.arange(len(sec)), sec)).to(x.device)
        pos = positions[stream_of_band]                       # [half, B, S]
        ang = torch.einsum("fbs,f->bsf", pos.float(), freqs)
    else:
        ang = positions[0].float()[..., None] * freqs[None, None, :]
    sin = torch.sin(ang)[:, :, None, :]                       # [B,S,1,half]
    cos = torch.cos(ang)[:, :, None, :]
    dt = x.dtype
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(dt)


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0, *,
                         device=None) -> torch.Tensor:
    """[seq_len, d_model] f32 absolute positions (whisper): sin then cos of
    (offset + t) / 10000 ** (i / half), the power taken in f32 as JAX
    takes it."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    half = d_model // 2
    ex = torch.arange(half, dtype=torch.float32, device=device) / half
    inv = 1.0 / torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=device), ex)
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_params(cfg, gen: torch.Generator, d: int, f: int) -> dict:
    pd = param_dtype(cfg)
    if cfg.act == "swiglu":
        return {"wg": dense_init(gen, (d, f), pd),
                "wi": dense_init(gen, (d, f), pd),
                "wo": dense_init(gen, (f, d), pd, fan_in=f)}
    p = {"wi": dense_init(gen, (d, f), pd),
         "wo": dense_init(gen, (f, d), pd, fan_in=f)}
    if cfg.use_bias:
        p["bi"] = torch.zeros((f,), dtype=pd, device=gen.device)
        p["bo"] = torch.zeros((d,), dtype=pd, device=gen.device)
    return p


def apply_mlp(cfg, p, x):
    dt = x.dtype
    if "wg" in p:
        g = x @ p["wg"].to(dt)
        h = x @ p["wi"].to(dt)
        h = F.silu(g) * h
    else:
        h = x @ p["wi"].to(dt)
        if "bi" in p:
            h = h + p["bi"].to(dt)
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out = h @ p["wo"].to(dt)
    if "bo" in p:
        out = out + p["bo"].to(dt)
    return out
