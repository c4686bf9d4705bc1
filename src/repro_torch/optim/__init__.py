"""repro_torch.optim -- AdamW and the LR schedule of the LM training path
(the sharded path's gradient compression comes with ROADMAP A.7)."""
from .adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
)
from .schedule import cosine_schedule  # noqa: F401
