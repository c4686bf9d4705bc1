"""Decoder-only transformer LM, dense family (stablelm, granite-20b,
command-r, mistral-large): GQA/MQA/SWA attention, RMSNorm, SwiGLU.

The port of the JAX package's ``models/transformer.py``. Parameters are plain
dictionaries, as the JAX pytree is: ``{"embed", "blocks", "final_norm"}``
(+ ``"unembed"`` unless tied), where ``blocks`` is a LIST of per-layer
dictionaries ``{"ln1", "attn", "ln2", "mlp"}`` in place of JAX's leaves
stacked on a leading layer axis; ``lax.scan`` over the stack becomes a
Python loop over the list. ``remat`` has no meaning in a no-grad forward.
Decode caches are a list of per-layer :class:`~.attention.KVCache`.
MoE blocks (``num_experts > 0``) come with the moe slice (ROADMAP A.11b).
"""
from __future__ import annotations

import torch

from repro_torch.obs.profile import scope

from . import attention as A
from . import layers as L


def _dense_only(cfg) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported to repro_torch yet "
            f"(ROADMAP A.11b, moe and vlm serving)")


def init_block_params(cfg, gen: torch.Generator) -> dict:
    _dense_only(cfg)
    dev = gen.device
    return {
        "ln1": L.norm_params(cfg, cfg.d_model, dev),
        "attn": A.attn_params(cfg, gen),
        "ln2": L.norm_params(cfg, cfg.d_model, dev),
        "mlp": L.mlp_params(cfg, gen, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in ``cfg.param_dtype``."""
    pd = L.param_dtype(cfg)
    params = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), pd),
        "blocks": [init_block_params(cfg, gen) for _ in range(cfg.num_layers)],
        "final_norm": L.norm_params(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), pd,
                                         fan_in=cfg.d_model)
    return params


def _block_fwd(cfg, p, x, positions):
    with scope("lm.norm"):
        hn = L.apply_norm(cfg, p["ln1"], x)
    h = x + A.self_attention(cfg, p["attn"], hn, positions)
    return h + _ffn(cfg, p, h)


def _ffn(cfg, p, h):
    _dense_only(cfg)
    with scope("lm.norm"):
        hn = L.apply_norm(cfg, p["ln2"], h)
    with scope("lm.mlp"):
        return L.apply_mlp(cfg, p["mlp"], hn)


def _embed_inputs(cfg, params, batch):
    """Token embeddings -> (x [B,S,D], positions [B,S]). Frontend
    embeddings (vlm / audio) come with their slices."""
    if batch.get("frontend_embeds") is not None:
        raise NotImplementedError("frontend embeddings come with the vlm and "
                                  "audio slices (ROADMAP A.11b, A.11c)")
    dt = L.compute_dtype(cfg)
    tokens = batch["tokens"]
    with scope("lm.embed"):
        x = params["embed"][tokens].to(dt)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int64, device=x.device)[None].expand(B, S)
    return x, positions


def logits_from_hidden(cfg, params, h):
    dt = h.dtype
    with scope("lm.logits"):
        if cfg.tie_embeddings:
            return h @ params["embed"].to(dt).T
        return h @ params["unembed"].to(dt)


def forward(cfg, params, batch):
    """Training/eval forward over the full sequence -> logits [B,S,Vp]."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x, positions = _embed_inputs(cfg, params, batch)
    for p in params["blocks"]:
        x = _block_fwd(cfg, p, x, positions)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_decode_state(cfg, batch, max_len, prefill_len=0, *, device):
    """One empty :class:`~.attention.KVCache` per layer."""
    dt = L.compute_dtype(cfg)
    return [A.init_cache(cfg, batch, max_len, dt, prefill_len, device=device)
            for _ in range(cfg.num_layers)]


def prefill(cfg, params, batch, max_len):
    """Run the full prompt, returning (last-position logits [B,1,Vp], the
    per-layer caches)."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x, positions = _embed_inputs(cfg, params, batch)
    caches = []
    for p in params["blocks"]:
        with scope("lm.norm"):
            hn = L.apply_norm(cfg, p["ln1"], x)
        y, cache = A.prefill_attention(cfg, p["attn"], hn, positions, max_len)
        x = x + y
        x = x + _ffn(cfg, p, x)
        caches.append(cache)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return logits_from_hidden(cfg, params, x), caches


def decode_step(cfg, params, caches, tokens):
    """One-token decode: tokens [B, 1] -> (logits [B,1,Vp], new caches).
    Each layer's cache is written in place (:func:`.attention.decode_attention`)."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    dt = L.compute_dtype(cfg)
    with scope("lm.embed"):
        x = params["embed"][tokens].to(dt)
    out = []
    for p, cache in zip(params["blocks"], caches):
        with scope("lm.norm"):
            hn = L.apply_norm(cfg, p["ln1"], x)
        y, cache = A.decode_attention(cfg, p["attn"], hn, cache)
        x = x + y
        x = x + _ffn(cfg, p, x)
        out.append(cache)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), out
