"""Whisper-style encoder-decoder (audio): bidirectional encoder over stubbed
frame embeddings + causal decoder with cross-attention. Sinusoidal absolute
positions (the JAX package's deviation from learned decoder positions).

The port of the JAX package's ``models/encdec.py``. Parameters: ``{"embed",
"enc", "enc_norm", "dec", "final_norm"}``, where ``enc`` and ``dec`` are
LISTS of per-layer blocks (JAX stacks them on a leading axis); the logits
use the tied embedding. Decode state: ``{"kv": one KVCache a decoder layer,
"cross": one (k, v) of the encoder output a decoder layer}``. On the card a
prefill launches B4 once an encoder layer (non-causal) and once a decoder
layer (causal) under ``attention_impl="pallas"``; cross-attention and
decode attend through the plain :func:`.attention.sdpa`, as in JAX. Under
grad mode with ``cfg.remat`` each encoder block and each decoder block (with
its cross K/V projection of the encoder output) is checkpointed, as JAX
wraps them in ``jax.checkpoint``.
"""
from __future__ import annotations

import torch

from repro_torch.obs.profile import scope
from repro_torch.remat import remat

from . import attention as A
from . import layers as L
from . import transformer as T


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in ``cfg.param_dtype``."""
    pd = L.param_dtype(cfg)
    dev = gen.device
    d = cfg.d_model

    def enc_block():
        return {"ln1": L.norm_params(cfg, d, dev), "attn": A.attn_params(cfg, gen),
                "ln2": L.norm_params(cfg, d, dev),
                "mlp": L.mlp_params(cfg, gen, d, cfg.d_ff)}

    def dec_block():
        return {"ln1": L.norm_params(cfg, d, dev), "self_attn": A.attn_params(cfg, gen),
                "ln_x": L.norm_params(cfg, d, dev), "cross_attn": A.attn_params(cfg, gen),
                "ln2": L.norm_params(cfg, d, dev),
                "mlp": L.mlp_params(cfg, gen, d, cfg.d_ff)}

    return {
        "embed": L.embed_init(gen, (cfg.padded_vocab, d), pd),
        "enc": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_norm": L.norm_params(cfg, d, dev),
        "dec": [dec_block() for _ in range(cfg.num_layers)],
        "final_norm": L.norm_params(cfg, d, dev),
    }


def _norm(cfg, p, x):
    with scope("lm.norm"):
        return L.apply_norm(cfg, p, x)


def _mlp(cfg, p, x):
    with scope("lm.mlp"):
        return L.apply_mlp(cfg, p, x)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int64, device=x.device)[None].expand(B, S)


def _add_positions(cfg, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    with scope("lm.embed"):
        pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, offset, device=x.device)
        return x + pe.to(x.dtype)[None]


def _enc_block(cfg, p, x, positions):
    x = x + A.self_attention(cfg, p["attn"], _norm(cfg, p["ln1"], x), positions,
                             causal=False)
    return x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))


def encode(cfg, params, frame_embeds):
    """frame_embeds [B, T_enc, D] (stubbed conv frontend output) -> the
    encoder's normed output [B, T_enc, D]."""
    x = _add_positions(cfg, frame_embeds.to(L.compute_dtype(cfg)))
    positions = _positions(x)
    for p in params["enc"]:
        x = remat(_enc_block, cfg, p, x, positions, on=cfg.remat)
    return _norm(cfg, params["enc_norm"], x)


def _embed_tokens(cfg, params, tokens):
    with scope("lm.embed"):
        x = params["embed"][tokens].to(L.compute_dtype(cfg))
    return x


def _dec_block(cfg, p, h, positions, enc_kv):
    h = h + A.self_attention(cfg, p["self_attn"], _norm(cfg, p["ln1"], h), positions,
                             causal=True)
    h = h + A.cross_attention(cfg, p["cross_attn"], _norm(cfg, p["ln_x"], h), enc_kv)
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], h))


def _dec_block_over(cfg, p, h, positions, enc_out):
    """A decoder block with its cross K/V projected from ``enc_out``."""
    return _dec_block(cfg, p, h, positions, A.encode_cross_kv(cfg, p["cross_attn"], enc_out))


def forward(cfg, params, batch):
    """Teacher-forced training: frame embeds -> encoder; tokens -> decoder."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    enc_out = encode(cfg, params, batch["frontend_embeds"])
    x = _add_positions(cfg, _embed_tokens(cfg, params, batch["tokens"]))
    positions = _positions(x)
    for p in params["dec"]:
        x = remat(_dec_block_over, cfg, p, x, positions, enc_out, on=cfg.remat)
    x = _norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x)


def prefill(cfg, params, batch, max_len):
    """Encode the (stubbed) audio frames, teacher-force the prompt through the
    decoder -> (last logits [B,1,Vp], {"kv": self-attn caches, "cross": the
    cross K/V of each decoder layer})."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    enc_out = encode(cfg, params, batch["frontend_embeds"])
    x = _add_positions(cfg, _embed_tokens(cfg, params, batch["tokens"]))
    positions = _positions(x)
    kv, cross = [], []
    for p in params["dec"]:
        enc_kv = A.encode_cross_kv(cfg, p["cross_attn"], enc_out)
        y, kv_c = A.prefill_attention(cfg, p["self_attn"], _norm(cfg, p["ln1"], x),
                                      positions, max_len)
        x = x + y
        x = x + A.cross_attention(cfg, p["cross_attn"], _norm(cfg, p["ln_x"], x), enc_kv)
        x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
        kv.append(kv_c)
        cross.append(enc_kv)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return T.logits_from_hidden(cfg, params, x), {"kv": kv, "cross": cross}


def init_decode_state(cfg, batch, max_len, prefill_len=0, *, device):
    """Decoder self-attn caches + zero cross K/V over ``encoder_seq`` frames
    (fill them with :func:`precompute_cross`)."""
    dt = L.compute_dtype(cfg)
    KV = cfg.num_kv_heads * cfg.kv_replication
    shape = (batch, cfg.encoder_seq, KV, cfg.resolved_head_dim)
    return {
        "kv": [A.init_cache(cfg, batch, max_len, dt, prefill_len, device=device)
               for _ in range(cfg.num_layers)],
        "cross": [(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))
                  for _ in range(cfg.num_layers)],
    }


def precompute_cross(cfg, params, enc_out):
    """Each decoder layer's cross K/V of ``enc_out`` (the ``"cross"`` state)."""
    return [A.encode_cross_kv(cfg, p["cross_attn"], enc_out) for p in params["dec"]]


def decode_step(cfg, params, caches, tokens):
    """One-token decode: tokens [B, 1] -> (logits [B,1,Vp], new caches). The
    sinusoidal offset is the caches' length (a host int); the self-attention
    caches are written in place."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x = _add_positions(cfg, _embed_tokens(cfg, params, tokens), caches["kv"][0].length)
    kv = []
    for p, kv_c, enc_kv in zip(params["dec"], caches["kv"], caches["cross"]):
        y, kv_c = A.decode_attention(cfg, p["self_attn"], _norm(cfg, p["ln1"], x), kv_c)
        x = x + y
        x = x + A.cross_attention(cfg, p["cross_attn"], _norm(cfg, p["ln_x"], x), enc_kv)
        x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
        kv.append(kv_c)
    x = _norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x), {"kv": kv, "cross": caches["cross"]}
