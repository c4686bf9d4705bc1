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

The SGD adapter for the LM zoo waits for the LM slice (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch import _device
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
