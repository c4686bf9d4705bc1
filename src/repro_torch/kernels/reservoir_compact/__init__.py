"""B2, reservoir compaction: the stable pack behind every sample
materialization (``ops.reservoir_compact``)."""
from . import ops, ref  # noqa: F401
