"""H1, the delete-complement loop of the R-TBS downsample map, as one CUDA
thread per trial row (``ops.swap_delete``)."""
from . import ops, ref  # noqa: F401
