"""repro_torch.obs -- telemetry, profiler hooks and sampler health monitors
(the JAX package's ``repro.obs``, DESIGN.md Sec. 14).

Per-tick gauges (sample size, fill fraction, stored mass C, decayed weight
W, the applied decay and the controller's lambda / hold / pulse, retrain
events, the bank's routing gauges and probed tenant) are computed on the
device inside the loops' ticks (:mod:`.probe`), gathered in a device buffer
and drained in ``every``-tick blocks through event-marked non-blocking
copies (:mod:`.telemetry`), so fast ticks stay free of host syncs. Drained
records run through health monitors (:mod:`.monitors`) and fan out to sinks
(:mod:`.sinks`: JSONL / stdout / in-memory). Profiler hooks live in
:mod:`.profile`.

Thread a handle through any loop builder::

    tel = obs.make_telemetry("runs/exp1", every=64)
    run = make_run_loop(sampler, model, retrain_every=5, telemetry=tel)

``telemetry=None`` (the default) runs the loop as it was, bit for bit.
"""
from .monitors import (  # noqa: F401
    InclusionDrift,
    Monitor,
    NanAlarm,
    OverflowAlarm,
    SampleSizeStability,
    StuckLambda,
    default_monitors,
)
from .probe import (  # noqa: F401
    make_bank_probe_stats,
    make_state_stats,
    state_nbytes,
    static_decay,
    tree_nbytes,
)
from .profile import annotation, profile_span, scope  # noqa: F401
from .sinks import (  # noqa: F401
    JsonlSink,
    MemorySink,
    Sink,
    StdoutSink,
    as_json_record,
)
from .telemetry import RowDrain, Telemetry, make_telemetry  # noqa: F401
