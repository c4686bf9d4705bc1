"""repro_torch.optim -- AdamW and the LR schedule of the LM training path,
and error-feedback int8 gradient compression (:mod:`.compress`)."""
from .adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
)
from .schedule import cosine_schedule  # noqa: F401
from .compress import compress_grads, decompress_grads, ef_init  # noqa: F401
