"""Unified model API over the zoo: the port of the JAX package's
``models/zoo.py`` (``ModelAPI`` with its ``loss``, ``build``, ``precast``,
``loss_fn``, ``make_demo_batch``).

Every family builds: dense, moe and vlm through ``transformer``, ssm
through ``mamba_lm``, hybrid through ``hybrid`` and audio through
``encdec``. ``input_specs`` gives the dry run's inputs
(:mod:`repro_torch.launch.dryrun`) as tensors on the meta device, and
``init_params`` / ``init_decode_state`` take ``device="meta"`` for its
parameters and caches. Where JAX takes a ``jax.random`` key, the port takes
a seed (``init_params``) or a ``torch.Generator`` (``make_demo_batch``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.config import ModelConfig, ShapeConfig

from . import encdec, hybrid, mamba_lm, transformer

VLM_PATCHES = 256  # stubbed vision prefix length (qwen2-vl dynamic-res stub)


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is the meta device: the initializers
    draw on ``gen.device``, and a meta draw takes a CPU generator but a
    meta one cannot be built (the meta device is no accelerator)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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
    if fam in ("dense", "moe", "vlm"):
        mod = transformer
    elif fam == "ssm":
        mod = mamba_lm
    elif fam == "hybrid":
        mod = hybrid
    elif fam == "audio":
        mod = encdec
    else:
        raise ValueError(fam)

    def init_params(seed: int, *, device=None):
        """Random parameters from a seeded generator on ``device`` (the card
        unless ``device="cpu"``; ``"meta"``: shapes and dtypes only)."""
        dev = _device.resolve(device)
        gen = _MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
        return mod.init_params(cfg, gen.manual_seed(seed))

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One global batch of this (arch, shape) cell as meta tensors, JAX's
    ``ShapeDtypeStruct`` stand-ins: int32 ``tokens`` [B, S] ([B, 1] for a
    decode step).

    [vlm]/[audio] entries: the modality frontend is a STUB -- precomputed
    patch/frame embeddings (``frontend_embeds`` in ``cfg.dtype``) are model
    inputs: a vlm batch's S positions are VLM_PATCHES patches and S -
    VLM_PATCHES tokens, an audio batch adds ``encoder_seq`` frames."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta((B, 1), torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": meta((B, S - VLM_PATCHES), torch.int32),
                "frontend_embeds": meta((B, VLM_PATCHES, cfg.d_model), dt)}
    if cfg.family == "audio":
        return {"tokens": meta((B, S), torch.int32),
                "frontend_embeds": meta((B, cfg.encoder_seq, cfg.d_model), dt)}
    return {"tokens": meta((B, S), torch.int32)}


def make_demo_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                    seq: int) -> dict:
    """Concrete random batch on ``gen``'s device: ``tokens`` [batch, seq];
    a vlm batch's first ``min(8, seq // 2)`` positions are stubbed patch
    embeddings (``frontend_embeds``, normal * 0.02 in ``cfg.dtype``) and its
    tokens the rest; an audio batch adds ``frontend_embeds`` [batch,
    encoder_seq, d_model], the stubbed frames."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                   device=dev, dtype=torch.int64)}
    dt = getattr(torch, cfg.dtype)
    frames = {"vlm": min(8, seq // 2), "audio": cfg.encoder_seq}.get(cfg.family)
    if frames is not None:
        if cfg.family == "vlm":
            out["tokens"] = out["tokens"][:, : seq - frames]
        out["frontend_embeds"] = (torch.randn((batch, frames, cfg.d_model), generator=gen,
                                              device=dev) * 0.02).to(dt)
    return out
