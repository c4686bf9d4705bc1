"""Unified model API over the zoo: the port of the JAX package's
``models/zoo.py`` (``ModelAPI`` with its ``loss``, ``build``, ``precast``,
``loss_fn``, ``make_demo_batch``).

The dense family (``transformer``) and the ssm family (``mamba_lm``) are
built so far; the other families raise naming their slice. ``input_specs``
serves the dry run and comes with it (ROADMAP A.12). Where JAX takes a ``jax.random`` key, the port takes a seed
(``init_params``) or a ``torch.Generator`` (``make_demo_batch``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.config import FAMILY_SLICE, ModelConfig, not_ported

from . import mamba_lm, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]          # (seed, *, device=None) -> params
    forward: Callable[[Any, Any], torch.Tensor]
    prefill: Callable[[Any, Any, int], Any]
    init_decode_state: Callable[..., Any]    # (batch, max_len, prefill_len=0, *, device=None)
    decode_step: Callable[[Any, Any, torch.Tensor], Any]

    def loss(self, params, batch):
        return loss_fn(self.cfg, self.forward, params, batch)


def build(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in FAMILY_SLICE:
        raise not_ported(cfg.name, fam)
    if fam == "dense":
        mod = transformer
    elif fam == "ssm":
        mod = mamba_lm
    else:
        raise ValueError(fam)

    def init_params(seed: int, *, device=None):
        """Random parameters from a seeded generator on ``device`` (the card
        unless ``device="cpu"``)."""
        dev = _device.resolve(device)
        return mod.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))

    def init_decode_state(batch, max_len, prefill_len=0, *, device=None):
        return mod.init_decode_state(cfg, batch, max_len, prefill_len,
                                     device=_device.resolve(device))

    return ModelAPI(
        cfg=cfg,
        init_params=init_params,
        forward=lambda params, batch: mod.forward(cfg, params, batch),
        prefill=lambda params, batch, max_len: mod.prefill(cfg, params, batch, max_len),
        init_decode_state=init_decode_state,
        decode_step=lambda params, caches, tokens: mod.decode_step(
            cfg, params, caches, tokens),
    )


def precast(cfg, params):
    """With ``cfg.cast_params_once``, cast every floating parameter to the
    compute dtype ONCE before the layer stack, so each use's cast is a no-op
    (JAX's optimization barrier, which pins the cast ahead of FSDP gathers,
    has no counterpart in eager torch)."""
    if not cfg.cast_params_once:
        return params
    dt = getattr(torch, cfg.dtype)
    return pytree.tree_map(lambda p: p.to(dt) if p.is_floating_point() else p, params)


def loss_fn(cfg, forward, params, batch):
    """Next-token cross entropy in f32 (padded-vocab logits; labels < vocab),
    averaged over ``batch["loss_mask"][:, 1:]`` when the batch carries one.
    Logits past a frontend prefix (``logits.shape[1] - tokens.shape[1]``
    positions) are dropped, as in JAX."""
    logits = forward(params, batch)
    tokens = batch["tokens"]
    offset = logits.shape[1] - tokens.shape[1]
    logits = logits[:, offset:][:, :-1].float()
    labels = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        m = mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def make_demo_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                    seq: int) -> dict:
    """Concrete random token batch on ``gen``'s device (the dense family's
    batch; the vlm / audio frontend stubs come with their slices)."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                    device=gen.device, dtype=torch.int64)}
