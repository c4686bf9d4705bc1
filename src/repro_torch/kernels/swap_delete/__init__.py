"""H1, the delete-complement map of the R-TBS downsample map
(``ops.swap_delete``): on the card a parallel last-writer forest for long
rows, one thread a row for the bank's short ones."""
from . import ops, ref  # noqa: F401
