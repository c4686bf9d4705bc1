"""B1, the fused TBS-step payload pass: the whole R-TBS tick's buffer rewrite
as one two-source row copy (``ops.tbs_step_apply``)."""
from . import ops, ref  # noqa: F401
