"""Plain PyTorch version of B4: the math of the JAX package's
``kernels/flash_attention/ref.py::attention_ref``. The CPU path of
:func:`..ops.flash_attention`, and what ``chip_smoke.py`` and the card tests
hold the kernel against."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,KV,hd] -> [B,S,H,hd] (f32 softmax; the
    probabilities are cast to q's dtype before the product with v)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    s = s / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, S, H, hd)
