"""repro_torch.optim -- AdamW and the LR schedule of the LM training path
(gradient compression for a sharded run over several cards, the JAX
package's ``optim/compress.py``, waits: ROADMAP A.7)."""
from .adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
)
from .schedule import cosine_schedule  # noqa: F401
