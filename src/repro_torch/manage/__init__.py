"""repro_torch.manage -- the paper's online model-management loop: a stream
-> a :class:`repro_torch.core.api.Sampler` -> periodic retraining ->
prequential eval (:mod:`.loop`), with the closed-form model adapters
(:mod:`.models`)."""
from .loop import (  # noqa: F401
    item_proto,
    make_manage_step,
    make_run_loop,
    materialize_stream,
    run_loop,
    tick_keys,
)
from .models import ModelAdapter, available_models, make_model  # noqa: F401
