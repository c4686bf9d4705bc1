"""repro_torch.data -- the paper's stream generators (numpy, host side)."""
from . import streams  # noqa: F401
