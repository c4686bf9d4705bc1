"""repro_torch.decay -- per-tick decay schedules and the closed-loop
adaptive controller (the JAX package's ``repro.decay``). Threading points:
``make_sampler(..., decay=...)`` (:mod:`repro_torch.core.api`) and
``make_run_loop(..., controller=...)`` (:mod:`repro_torch.manage.loop`)."""
from .adaptive import (  # noqa: F401
    AdaptiveDecay,
    ControllerState,
    loss_ratio,
)
from .schedules import (  # noqa: F401
    DecayedState,
    DecaySchedule,
    decay_profile,
    exponential,
    from_callable,
    piecewise,
    polynomial,
    resolve,
)
