"""repro_torch.decay -- per-tick decay schedules (the adaptive controller of
the JAX package is not ported yet)."""
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
