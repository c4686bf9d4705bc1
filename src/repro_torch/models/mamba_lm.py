"""Pure Mamba2 (SSD) language model -- attention-free (mamba2-370m).

The port of the JAX package's ``models/mamba_lm.py``. Parameters are plain
dictionaries: ``{"embed", "blocks", "final_norm"}`` (+ ``"unembed"``
unless tied), ``blocks`` a list of per-layer ``{"ln", "ssm"}``. Decode
state is a list of per-layer :class:`~.ssm.SSMCache`, O(1) in context
length. On the card every prefill (and forward) launches kernel B5 once a
layer; decode launches none. Under grad mode with ``cfg.remat`` each layer
of :func:`forward` is checkpointed (JAX's ``jax.checkpoint``), so a train
step launches B5 twice a layer: the forward and its recompute.
"""
from __future__ import annotations

import torch

from repro_torch.obs.profile import scope
from repro_torch.remat import remat

from . import layers as L
from . import ssm as S
from . import transformer as T


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in ``cfg.param_dtype``."""
    pd = L.param_dtype(cfg)
    dev = gen.device
    params = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), pd),
        "blocks": [{"ln": L.norm_params(cfg, cfg.d_model, dev),
                    "ssm": S.ssm_params(cfg, gen)} for _ in range(cfg.num_layers)],
        "final_norm": L.norm_params(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), pd,
                                         fan_in=cfg.d_model)
    return params


def _layer(cfg, p, h):
    with scope("lm.norm"):
        hn = L.apply_norm(cfg, p["ln"], h)
    y, cache = S.apply_ssm(cfg, p["ssm"], hn)
    return h + y, cache


def _layer_out(cfg, p, h):
    return _layer(cfg, p, h)[0]


def forward(cfg, params, batch):
    """Training/eval forward over the full sequence -> logits [B,S,Vp]."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    x, _ = T._embed_inputs(cfg, params, batch)
    for p in params["blocks"]:
        x = remat(_layer_out, cfg, p, x, on=cfg.remat)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x)


def prefill(cfg, params, batch, max_len):
    """Run the full prompt through the chunked SSD path, returning
    (last-position logits [B,1,Vp], per-layer SSMCaches). max_len unused:
    SSM state is O(1) in context length."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    del max_len
    x, _ = T._embed_inputs(cfg, params, batch)
    caches = []
    for p in params["blocks"]:
        x, cache = _layer(cfg, p, x)
        caches.append(cache)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return T.logits_from_hidden(cfg, params, x), caches


def init_decode_state(cfg, batch, max_len, prefill_len=0, *, device):
    """One empty :class:`~.ssm.SSMCache` per layer."""
    del max_len, prefill_len  # SSM state is O(1) in context length
    dt = L.compute_dtype(cfg)
    return [S.init_ssm_cache(cfg, batch, dt, device=device) for _ in range(cfg.num_layers)]


def decode_step(cfg, params, caches, tokens):
    """One-token decode: tokens [B, 1] -> (logits [B,1,Vp], new caches)."""
    from . import zoo as _zoo

    params = _zoo.precast(cfg, params)
    dt = L.compute_dtype(cfg)
    with scope("lm.embed"):
        x = params["embed"][tokens].to(dt)
    out = []
    for p, cache in zip(params["blocks"], caches):
        with scope("lm.norm"):
            hn = L.apply_norm(cfg, p["ln"], x)
        y, cache = S.decode_ssm(cfg, p["ssm"], hn, cache)
        x = x + y
        out.append(cache)
    with scope("lm.norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return T.logits_from_hidden(cfg, params, x), out
