"""repro_torch.manage -- the paper's online model-management loop: a stream
-> a :class:`repro_torch.core.api.Sampler` -> periodic retraining ->
prequential eval (:mod:`.loop`), its keyed twin over a
:class:`repro_torch.bank.SamplerBank` (:mod:`.bank_loop`), and the
model adapters (:mod:`.models`), closed-form and SGD."""
from .bank_loop import (  # noqa: F401
    keyed_item_proto,
    make_bank_manage_step,
    make_bank_run_loop,
    pooled_view,
)
from .loop import (  # noqa: F401
    item_proto,
    make_manage_step,
    make_run_farm,
    make_run_loop,
    materialize_stream,
    run_farm,
    run_loop,
    tick_keys,
)
from .models import (  # noqa: F401
    ModelAdapter, available_models, draw_rows, make_model, make_sgd_adapter, rows_from_uniforms,
)
