"""Zamba2-style hybrid LM: Mamba2 backbone + ONE shared attention+MLP block
invoked every ``attn_every`` layers (weights shared across invocations, one
KV cache per invocation). [arXiv:2411.15242]

The port of the JAX package's ``models/hybrid.py``. Parameters: ``{"embed",
"mamba", "shared", "final_norm"}`` (+ ``"unembed"`` unless tied), where
``mamba`` is a LIST of per-layer ``{"ln", "ssm"}`` (JAX stacks them on a
leading axis) and ``shared`` is one transformer block
(:func:`.transformer.init_block_params`), the same tensors at each of its
G = num_layers / attn_every invocations. JAX's scans over the groups and
over each group's layers are Python loops here. Decode state: ``{"ssm":
[G][attn_every] SSMCache, "kv": [G] KVCache}``. On the card a prefill
launches B5 once a Mamba2 layer and B4 once an invocation (under
``attention_impl="pallas"``). Under grad mode with ``cfg.remat`` the
forward nests two checkpoints, as JAX does: each Mamba2 layer, and each
whole group (its ``attn_every`` layers and the shared block), so the shared
block's intermediates are not kept once an invocation; a train step
launches B5 three times a layer (the forward, the group's recompute, the
layer's own). As in JAX, the shared block takes the plain
hidden state (the original also concatenates the initial embeddings and
adds per-invocation LoRA).
"""
from __future__ import annotations

import torch

from repro_torch.obs.profile import scope
from repro_torch.remat import remat

from . import attention as A
from . import layers as L
from . import ssm as S
from . import transformer as T


def _groups(cfg) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not groups of "
                         f"attn_every = {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in ``cfg.param_dtype``."""
    pd = L.param_dtype(cfg)
    dev = gen.device
    params = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), pd),
        "mamba": [{"ln": L.norm_params(cfg, cfg.d_model, dev),
                   "ssm": S.ssm_params(cfg, gen)} for _ in range(cfg.num_layers)],
        "shared": T.init_block_params(cfg, gen),
        "final_norm": L.norm_params(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), pd,
                                         fan_in=cfg.d_model)
    return params


def _group_layers(cfg, params, g: int) -> list:
    return params["mamba"][g * cfg.attn_every:(g + 1) * cfg.attn_every]


def _mamba_layer(cfg, p, h):
    with scope("lm.norm"):
        hn = L.apply_norm(cfg, p["ln"], h)
    y, cache = S.apply_ssm(cfg, p["ssm"], hn)
    return h + y, cache


def _mamba_out(cfg, p, h):
    return _mamba_layer(cfg, p, h)[0]


def _group(cfg, params, g, h, positions):
    """Group ``g``'s Mamba2 layers, each checkpointed, then the shared block."""
    for p in _group_layers(cfg, params, g):
        h = remat(_mamba_out, cfg, p, h, on=cfg.remat)
    return T._block_fwd(cfg, params["shared"], h, positions)


def forward(cfg, params, batch):
    """Training/eval forward over the full sequence -> logits [B,S,Vp]."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x, positions = T._embed_inputs(cfg, params, batch)
    for g in range(_groups(cfg)):
        x = remat(_group, cfg, params, g, x, positions, on=cfg.remat)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x)


def prefill(cfg, params, batch, max_len):
    """Prompt pass -> (last-position logits [B,1,Vp], {"ssm": per-layer
    SSMCaches [G][attn_every], "kv": one KVCache per invocation [G]})."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x, positions = T._embed_inputs(cfg, params, batch)
    shared = params["shared"]
    ssm_c, kv_c = [], []
    for g in range(_groups(cfg)):
        group = []
        for p in _group_layers(cfg, params, g):
            x, cache = _mamba_layer(cfg, p, x)
            group.append(cache)
        with scope("lm.norm"):
            hn = L.apply_norm(cfg, shared["ln1"], x)
        y, kv = A.prefill_attention(cfg, shared["attn"], hn, positions, max_len)
        x = x + y
        x = x + T._ffn(cfg, shared, x)
        ssm_c.append(group)
        kv_c.append(kv)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return T.logits_from_hidden(cfg, params, x), {"ssm": ssm_c, "kv": kv_c}


def init_decode_state(cfg, batch, max_len, prefill_len=0, *, device):
    """Empty caches: one SSMCache a Mamba2 layer, one KVCache an invocation."""
    dt = L.compute_dtype(cfg)
    G = _groups(cfg)
    return {
        "ssm": [[S.init_ssm_cache(cfg, batch, dt, device=device)
                 for _ in range(cfg.attn_every)] for _ in range(G)],
        "kv": [A.init_cache(cfg, batch, max_len, dt, prefill_len, device=device)
               for _ in range(G)],
    }


def decode_step(cfg, params, caches, tokens):
    """One-token decode: tokens [B, 1] -> (logits [B,1,Vp], new caches).
    The KV caches are written in place (:func:`.attention.decode_attention`)."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    dt = L.compute_dtype(cfg)
    shared = params["shared"]
    with scope("lm.embed"):
        x = params["embed"][tokens].to(dt)
    ssm_out, kv_out = [], []
    for g in range(_groups(cfg)):
        group = []
        for p, cache in zip(_group_layers(cfg, params, g), caches["ssm"][g]):
            with scope("lm.norm"):
                hn = L.apply_norm(cfg, p["ln"], x)
            y, cache = S.decode_ssm(cfg, p["ssm"], hn, cache)
            x = x + y
            group.append(cache)
        with scope("lm.norm"):
            hn = L.apply_norm(cfg, shared["ln1"], x)
        y, kv = A.decode_attention(cfg, shared["attn"], hn, caches["kv"][g])
        x = x + y
        x = x + T._ffn(cfg, shared, x)
        ssm_out.append(group)
        kv_out.append(kv)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x), {"ssm": ssm_out, "kv": kv_out}
