"""repro_torch.models -- the paper's closed-form application models (the LM
zoo of the JAX package is not ported yet)."""
from . import simple_ml  # noqa: F401
