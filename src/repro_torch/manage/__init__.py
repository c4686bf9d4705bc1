"""repro_torch.manage -- the paper's online model-management loop: a stream
-> a :class:`repro_torch.core.api.Sampler` -> periodic retraining ->
prequential eval (:mod:`.loop`, with the sharded loops of the
distributed schemes), its keyed twin over a
:class:`repro_torch.bank.SamplerBank` (:mod:`.bank_loop`, with the
key-sharded loop), and the
model adapters (:mod:`.models`), closed-form and SGD."""
from .bank_loop import (  # noqa: F401
    keyed_item_proto,
    make_bank_manage_step,
    make_bank_run_loop,
    make_sharded_bank_loop,
    make_sharded_bank_manage_step,
    pooled_view,
    shard_keyed_stream,
)
from .loop import (  # noqa: F401
    init_sharded_state,
    item_proto,
    make_manage_step,
    make_run_farm,
    make_run_loop,
    make_sharded_manage_step,
    make_sharded_resume_loop,
    make_sharded_run_farm,
    make_sharded_run_loop,
    materialize_stream,
    run_farm,
    run_loop,
    shard_stream,
    tick_keys,
)
from .models import (  # noqa: F401
    ModelAdapter, available_models, draw_rows, make_model, make_sgd_adapter, rows_from_uniforms,
)
