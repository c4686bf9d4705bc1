"""Model adapters for the online model-management loop.

A :class:`ModelAdapter` is the model-side counterpart of
:class:`repro_torch.core.api.Sampler`:

  * ``init()``                          -> params on the adapter's device
  * ``fit(key, params, view)``          -> params retrained on a realized
                                           :class:`~repro_torch.core.api.SampleView`
  * ``evaluate(params, batch, bcount)`` -> f32 0-d metric on the NEXT batch
                                           (prequential; lower is better)

  ===========  ==========================  ===========================
  name         model                       metric
  ===========  ==========================  ===========================
  linreg       least-squares regression    mean squared error
  naive_bayes  multinomial NB              misclassification fraction
  knn          k-nearest-neighbour         misclassification fraction
  ===========  ==========================  ===========================

plus :func:`make_sgd_adapter`, which wraps a gradient-trained model
(:func:`repro_torch.train.steps.make_train_step`) so LMs from the zoo run in
the same loop: ``fit`` performs ``retrain_steps`` SGD steps on minibatches
resampled from the sample view.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.core.api import SampleView
from repro_torch.models import simple_ml

_F32 = torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAdapter:
    """A model bound to its shapes and device; see the module docstring."""

    name: str
    init: Callable[[], Any]
    fit: Callable[[Any, Any, SampleView], Any]
    evaluate: Callable[[Any, Any, torch.Tensor], torch.Tensor]
    hyper: Mapping[str, Any]
    device: torch.device


_REGISTRY: dict[str, Callable[..., ModelAdapter]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_model(name: str, *, device=None, **hyper) -> ModelAdapter:
    """Construct a registered adapter, e.g. ``make_model("linreg", dim=2)``.
    ``device=None`` means the CUDA card (raises without one)."""
    builder = _REGISTRY.get(name)
    if builder is None:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}")
    return builder(device=_device.resolve(device), **hyper)


def _prefix_mean(values: torch.Tensor, bcount: torch.Tensor) -> torch.Tensor:
    """Mean of values[:bcount]; NaN for an empty tick."""
    n = values.shape[0]
    w = (torch.arange(n, device=values.device) < bcount).to(_F32)
    mean = torch.sum(values * w) / torch.clamp(bcount.to(_F32), min=1.0)
    return torch.where(bcount > 0, mean, torch.nan)


@register("linreg")
def _make_linreg(*, dim: int = 2, device: torch.device) -> ModelAdapter:
    """Least-squares regression (paper Sec. 6.3). Items: {"x": [dim], "y": []}."""

    def fit(key, params, view: SampleView):
        return simple_ml.linreg_fit(view.items["x"], view.items["y"], view.mask)

    def evaluate(params, batch, bcount):
        pred = simple_ml.linreg_predict(params, batch["x"])
        return _prefix_mean((pred - batch["y"]) ** 2, bcount)

    return ModelAdapter(
        name="linreg",
        init=lambda: torch.zeros((dim + 1,), dtype=_F32, device=device),
        fit=fit, evaluate=evaluate, hyper={"dim": dim}, device=device)


@register("naive_bayes")
def _make_naive_bayes(*, vocab: int, num_classes: int = 2,
                      device: torch.device) -> ModelAdapter:
    """Multinomial NB (paper Sec. 6.4). Items: {"x": [vocab] counts, "y": []}."""

    def fit(key, params, view: SampleView):
        return simple_ml.nb_fit(view.items["x"], view.items["y"], view.mask,
                                num_classes=num_classes)

    def evaluate(params, batch, bcount):
        pred = simple_ml.nb_predict(params, batch["x"])
        return _prefix_mean((pred != batch["y"]).to(_F32), bcount)

    return ModelAdapter(
        name="naive_bayes",
        init=lambda: (torch.zeros((num_classes,), dtype=_F32, device=device),
                      torch.zeros((num_classes, vocab), dtype=_F32, device=device)),
        fit=fit, evaluate=evaluate,
        hyper={"vocab": vocab, "num_classes": num_classes}, device=device)


@register("knn")
def _make_knn(*, cap: int, dim: int = 2, k: int = 7, num_classes: int = 100,
              device: torch.device) -> ModelAdapter:
    """kNN classification (paper Sec. 6.2). The "params" ARE the stored
    sample (x, y, valid), so ``cap`` must match the sampler's buffer
    capacity (n+1 for rtbs)."""

    def fit(key, params, view: SampleView):
        return {"x": view.items["x"], "y": view.items["y"], "valid": view.mask}

    def evaluate(params, batch, bcount):
        pred = simple_ml.knn_predict(params["x"], params["y"], params["valid"],
                                     batch["x"], k=k, num_classes=num_classes)
        return _prefix_mean((pred != batch["y"]).to(_F32), bcount)

    return ModelAdapter(
        name="knn",
        init=lambda: {
            "x": torch.zeros((cap, dim), dtype=_F32, device=device),
            "y": torch.zeros((cap,), dtype=torch.int32, device=device),
            "valid": torch.zeros((cap,), dtype=torch.bool, device=device),
        },
        fit=fit, evaluate=evaluate,
        hyper={"cap": cap, "dim": dim, "k": k, "num_classes": num_classes},
        device=device)


def rows_from_uniforms(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows drawn with replacement in proportion to ``mask`` from uniforms
    ``u`` in [0, 1) (any shape), by ``jax.random.choice``'s formula: the
    cumulative sum of ``mask / max(mask.sum(), 1)`` searched (left) at
    ``total * (1 - u)``. Returns int64 row indices shaped like ``u``."""
    m = mask.to(_F32)
    probs = m / torch.clamp(m.sum(), min=1.0)
    cum = torch.cumsum(probs, dim=0)
    r = cum[-1] * (1 - u)
    return torch.searchsorted(cum, r.reshape(-1)).reshape(u.shape)


def draw_rows(key: prng.Key, mask: torch.Tensor, steps: int, batch: int) -> torch.Tensor:
    """The SGD adapter's minibatch rows, int64 [steps, batch]: step i splits
    the running key, as JAX's ``fit`` does (``key, k_sel = split(key)``), and
    draws ``batch`` uniforms from ``k_sel``."""
    us = []
    for _ in range(steps):
        key, k_sel = prng.split(key, 2)
        us.append(prng.uniform(k_sel, (batch,), mask.device))
    return rows_from_uniforms(torch.stack(us), mask)


def make_sgd_adapter(*, init_params: Callable[[], Any],
                     train_step: Callable[[Any, Any, Any], tuple],
                     init_opt_state: Callable[[Any], Any],
                     loss: Callable[[Any, Any], torch.Tensor],
                     batch_field: str,
                     train_batch: int,
                     retrain_steps: int,
                     row_loss: Callable[[Any, Any], torch.Tensor] | None = None,
                     name: str = "sgd", device=None) -> ModelAdapter:
    """Adapter for gradient-trained models (the LM path of the paper's loop).

    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    is a step from :func:`repro_torch.train.steps.make_train_step`;
    ``loss(params, batch) -> 0-d`` is the prequential objective. The state
    is ``{"params", "opt"}``.

    ``fit(key, state, view, rows=None)`` runs one train step on each of
    ``retrain_steps`` minibatches of ``train_batch`` rows of the sample
    view, drawn with replacement in proportion to the membership mask
    (:func:`draw_rows`). The draw's random bits are an operand: ``rows``
    (int64 [retrain_steps, train_batch]) replaces the draw, so a test can
    feed the rows JAX drew. An empty sample leaves the state as it is; that
    guard reads the view's size on the host, which a retrain tick may do
    (a tick without a fit never calls it).

    ``evaluate`` runs without gradients. With the default ``row_loss=None``
    it is the scalar ``loss`` over ALL rows of the eval batch, so every row
    must be valid; pass ``row_loss(params, batch) -> [rows]`` for a
    bcount-masked prefix mean instead, which makes padding harmless.
    ``device=None`` means the CUDA card (raises without one).
    """
    dev = _device.resolve(device)

    def init():
        params = init_params()
        return {"params": params, "opt": init_opt_state(params)}

    def fit(key, state, view: SampleView, rows: torch.Tensor | None = None):
        if int(view.size) <= 0:          # empty-sample guard: nothing to train on yet
            return state
        if rows is None:
            rows = draw_rows(key, view.mask, retrain_steps, train_batch)
        params, opt = state["params"], state["opt"]
        for i in range(retrain_steps):
            mb = pytree.tree_map(lambda a: a[rows[i]], view.items)
            params, opt, _ = train_step(params, opt, {batch_field: mb})
        return {"params": params, "opt": opt}

    if row_loss is None:
        @torch.no_grad()
        def evaluate(state, batch, bcount):
            del bcount  # scalar loss: caller guarantees no padded rows
            return loss(state["params"], {batch_field: batch})
    else:
        @torch.no_grad()
        def evaluate(state, batch, bcount):
            return _prefix_mean(row_loss(state["params"], {batch_field: batch}), bcount)

    return ModelAdapter(
        name=name, init=init, fit=fit, evaluate=evaluate,
        hyper={"train_batch": train_batch, "retrain_steps": retrain_steps,
               "batch_field": batch_field},
        device=dev)
