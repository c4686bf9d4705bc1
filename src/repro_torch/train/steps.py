"""Jit-free step factories over a :class:`~repro_torch.models.zoo.ModelAPI`:
the port of the JAX package's ``make_prefill_step`` and ``make_decode_step``.
``make_train_step`` comes with the training slice (ROADMAP A.11d)."""
from __future__ import annotations

import torch


def make_prefill_step(api, max_len: int):
    def prefill_step(params, batch):
        return api.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(api):
    def decode_step(params, caches, tokens):
        logits, caches = api.decode_step(params, caches, tokens)
        # greedy next token over the real vocabulary (the padded rows never win)
        nxt = torch.argmax(logits[:, :, : api.cfg.vocab_size], dim=-1)
        return nxt, caches

    return decode_step
