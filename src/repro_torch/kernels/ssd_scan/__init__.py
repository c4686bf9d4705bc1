"""B5, the Mamba2 SSD chunked scan (``ops.ssd_scan``): the Mamba2 block's
prefill on the card (``models.ssm.ssd_chunked``)."""
from . import ops, ref  # noqa: F401
