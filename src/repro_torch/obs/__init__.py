"""repro_torch.obs -- profiler scopes (the telemetry, sinks and monitors of
the JAX package are not ported yet)."""
from .profile import scope  # noqa: F401
