"""Step factories over a :class:`~repro_torch.models.zoo.ModelAPI`: the
port of the JAX package's ``train/steps.py`` -- train (CE + AdamW, optional
gradient-accumulation microbatching), prefill, decode."""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.obs.profile import scope
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.schedule import cosine_schedule


def make_train_step(api, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    total_steps: int = 100_000, warmup: int = 1000):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``metrics = {"loss", "grad_norm"}`` as f32 0-d device
    tensors.

    ``microbatches > 1`` runs gradient accumulation: the batch is split on
    its leading axis, each part's gradients are summed into f32 accumulators
    in order, and loss and gradients are divided by the count, as JAX's scan
    does. The learning rate is ``opt_cfg.lr`` times
    :func:`~repro_torch.optim.schedule.cosine_schedule` of the optimizer's
    step count. Phases run under the profiler scopes ``train.forward``,
    ``train.backward`` and ``train.optim``; nothing reads the host."""

    def grads_of(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            with scope("train.forward"):
                loss = api.loss(pytree.tree_unflatten(live, spec), batch)
            with scope("train.backward"):
                grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            split = pytree.tree_map(
                lambda x: x.reshape((microbatches, x.shape[0] // microbatches)
                                    + tuple(x.shape[1:])), batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=pytree.tree_leaves(params)[0].device)
            gsum = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                         device=p.device), params)
            for i in range(microbatches):
                l_i, g_i = grads_of(params, pytree.tree_map(lambda x: x[i], split))
                gsum = pytree.tree_map(lambda a, g: a + g.float(), gsum, g_i)
                loss = loss + l_i
            loss = loss / microbatches
            grads = pytree.tree_map(lambda g: g / microbatches, gsum)
        with scope("train.optim"):
            lr_scale = cosine_schedule(opt_state["count"], warmup=warmup, total=total_steps)
            params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params, lr_scale)
        return params, opt_state, {"loss": loss, **om}

    return train_step


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
