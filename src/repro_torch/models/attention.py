"""GQA/MQA attention with causal + sliding-window masking, RoPE/M-RoPE,
contiguous KV caches (ring-buffered under SWA so decode memory is bounded).

The port of the JAX package's ``models/attention.py``. Two math paths,
selected by ``cfg.attention_impl``: ``xla`` (plain torch: :func:`sdpa`, and
:func:`chunked_sdpa` from ``cfg.attn_chunk`` tokens on) and ``pallas``,
which here is kernel B4 (``repro_torch.kernels.flash_attention``, the
hand-written CUDA flash attention; its plain version on CPU tensors). B4
takes full self-attention (no ``k_valid``, as many queries as keys): the
prefill and the forward, causal or not (whisper's encoder). Decode attends
over the cache, and whisper's decoder over the encoder's K/V
(:func:`cross_attention`), through :func:`sdpa`, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.obs.profile import scope
from repro_torch.remat import remat

from . import layers as L

NEG = -1e30


def attn_params(cfg, gen: torch.Generator) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    pd = L.param_dtype(cfg)
    p = {
        "wq": L.dense_init(gen, (d, H, hd), pd, fan_in=d),
        "wk": L.dense_init(gen, (d, KV, hd), pd, fan_in=d),
        "wv": L.dense_init(gen, (d, KV, hd), pd, fan_in=d),
        "wo": L.dense_init(gen, (H, hd, d), pd, fan_in=H * hd),
    }
    if cfg.use_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((n, hd), dtype=pd, device=gen.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * k, d)


def _project_qkv(cfg, p, xq, xkv):
    dt = xq.dtype
    q, k, v = _proj(xq, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.kv_replication > 1:
        # kv-head replication: duplicate kv heads (jnp.repeat on axis 2)
        k = torch.repeat_interleave(k, cfg.kv_replication, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_replication, dim=2)
    return q, k, v


def sdpa(cfg, q, k, v, *, q_positions=None, k_positions=None, causal=True,
         window=0, k_valid=None):
    """Scaled-dot-product GQA attention (the `xla` path; also decode's).

    q [B,S,H,hd]; k,v [B,T,KV,hd]. Masks: causal (by absolute positions),
    sliding window (0 = full), and k_valid [B,T] (cache validity)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    if q_positions is None:
        q_positions = torch.arange(S, device=dev)[None]
    if k_positions is None:
        k_positions = torch.arange(T, device=dev)[None]
    qp = q_positions[:, None, None, :, None]  # [B,1,1,S,1]
    kp = k_positions[:, None, None, None, :]  # [B,1,1,1,T]
    mask = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    scores = scores.masked_fill(~mask, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def chunked_sdpa(cfg, q, k, v, *, causal=True, window=0, block_q=1024,
                 block_k=1024):
    """Online-softmax (flash-style) attention in plain torch: a loop over
    query blocks and, inside, over key blocks. Peak memory O(block_q *
    block_k) instead of O(S * T). Same math as :func:`sdpa`. Under grad mode
    each query block is checkpointed whatever ``cfg.remat`` says, as JAX's
    ``lax.map(jax.checkpoint(one_q_block))`` is: the backward keeps one
    block's scores at a time."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq, bk = min(block_q, S), min(block_k, T)
    if S % bq or T % bk:
        raise ValueError(f"chunked_sdpa: S={S}, T={T} not multiples of the "
                         f"blocks {bq}, {bk}")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    def one_q_block(qb, i):
        qi = qb.reshape(B, bq, KV, G, hd)
        qpos = i * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=dev)
        for j in range(T // bk):
            kj, vj = k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqkgh,btkh->bkgqt", qi, kj).float() * scale
            kpos = j * bk + torch.arange(bk, device=dev)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~mask, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p.to(q.dtype), vj).float()
            m = m_new
        out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
        return out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd)

    outs = [remat(one_q_block, q[:, i * bq:(i + 1) * bq], i) for i in range(S // bq)]
    return torch.cat(outs, dim=1)


def _attend(cfg, q, k, v, **kw):
    if cfg.attention_impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa

        if kw.get("k_valid") is None and q.shape[1] == k.shape[1]:
            return fa.flash_attention(
                q, k, v, causal=kw.get("causal", True), window=kw.get("window", 0))
    S, T = q.shape[1], k.shape[1]
    if cfg.attn_chunk and S >= cfg.attn_chunk and T >= cfg.attn_chunk \
            and kw.get("k_valid") is None:
        return chunked_sdpa(
            cfg, q, k, v, causal=kw.get("causal", True), window=kw.get("window", 0),
            block_q=cfg.attn_chunk, block_k=cfg.attn_chunk)
    return sdpa(cfg, q, k, v, **kw)


def _qkv_rope(cfg, p, x, positions):
    with scope("lm.qkv"):
        q, k, v = _project_qkv(cfg, p, x, x)
    if cfg.rope_theta:
        with scope("lm.rope"):
            q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _full_attention(cfg, p, x, positions, causal):
    """Projections, RoPE, attention over the whole sequence, and the output
    projection; returns (y, k, v)."""
    q, k, v = _qkv_rope(cfg, p, x, positions)
    with scope("lm.attn"):
        out = _attend(cfg, q, k, v, causal=causal, window=cfg.sliding_window)
    with scope("lm.attn_out"):
        return _out_proj(out, p["wo"]), k, v


def self_attention(cfg, p, x, positions, *, causal=True):
    """Full-sequence self-attention (train / prefill / encoder)."""
    return _full_attention(cfg, p, x, positions, causal)[0]


# ---------------------------------------------------------------------------
# KV cache (decode). Under SWA the cache is a ring buffer of size `window`.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # [B, T, KV, hd]
    v: torch.Tensor     # [B, T, KV, hd]
    length: int         # absolute number of tokens written so far (host int)


def init_cache(cfg, batch, max_len, dtype, prefill_len=0, *, device) -> KVCache:
    T = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    KV = cfg.num_kv_heads * cfg.kv_replication
    hd = cfg.resolved_head_dim
    return KVCache(k=torch.zeros((batch, T, KV, hd), dtype=dtype, device=device),
                   v=torch.zeros((batch, T, KV, hd), dtype=dtype, device=device),
                   length=int(prefill_len))


def decode_attention(cfg, p, x, cache: KVCache):
    """One-token decode step. x: [B, 1, d]. Keys are stored pre-rotated, so the
    ring buffer needs no position bookkeeping (RoPE is relative).

    Unlike JAX's ``dynamic_update_slice``, the new token's k and v are written
    into ``cache.k`` / ``cache.v`` IN PLACE; the returned cache shares them
    and has ``length + 1``. The length is a host int, so the slot and the
    validity mask cost no device sync."""
    B = x.shape[0]
    T = cache.k.shape[1]
    pos = cache.length                     # absolute position of the new token
    pp = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv_rope(cfg, p, x, pp)
    slot = pos % T if cfg.sliding_window > 0 else min(pos, T - 1)
    with scope("lm.attn"):
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        filled = min(pos + 1, T)  # ring buffer: slot order is irrelevant
        valid = torch.arange(T, device=x.device)[None] < filled
        out = sdpa(cfg, q, cache.k, cache.v,
                   causal=False,                 # causality via the validity mask
                   window=0, k_valid=valid.expand(B, T))
    with scope("lm.attn_out"):
        y = _out_proj(out, p["wo"])
    return y, KVCache(k=cache.k, v=cache.v, length=pos + 1)


def prefill_attention(cfg, p, x, positions, max_len=None):
    """Prefill: full self-attention + return the populated cache (padded to
    ``max_len`` slots so decode can append)."""
    B, S, _ = x.shape
    y, k, v = _full_attention(cfg, p, x, positions, causal=True)
    max_len = max_len or S
    if cfg.sliding_window and cfg.sliding_window < S:
        W = cfg.sliding_window
        # ring-align: token at absolute position p sits at slot p % W
        shift = S % W
        cache = KVCache(k=torch.roll(k[:, -W:], shift, dims=1),
                        v=torch.roll(v[:, -W:], shift, dims=1), length=S)
    else:
        T = max(max_len, S)
        kc = k.new_zeros((B, T) + tuple(k.shape[2:]))
        vc = v.new_zeros((B, T) + tuple(v.shape[2:]))
        kc[:, :S] = k
        vc[:, :S] = v
        cache = KVCache(k=kc, v=vc, length=S)
    return y, cache


def cross_attention(cfg, p, x, enc_kv):
    """Cross-attention against precomputed encoder K/V (whisper decoder):
    x [B,S,d], enc_kv = (k, v) [B,T,KV,hd]; the plain :func:`sdpa`, no mask."""
    with scope("lm.qkv"):
        q = _proj(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"].to(x.dtype)
    k, v = enc_kv
    with scope("lm.cross_attn"):
        out = sdpa(cfg, q, k, v, causal=False)
    with scope("lm.attn_out"):
        return _out_proj(out, p["wo"])


def encode_cross_kv(cfg, p, enc_out):
    """The encoder output's K and V for one decoder layer's cross-attention."""
    with scope("lm.qkv"):
        k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
        if "bk" in p:
            k = k + p["bk"].to(enc_out.dtype)
            v = v + p["bv"].to(enc_out.dtype)
    return k, v
