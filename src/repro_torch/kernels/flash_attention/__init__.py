"""B4, flash attention: online-softmax GQA attention with causal and
sliding-window masks (``ops.flash_attention``), the prefill's attention
when ``cfg.attention_impl == "pallas"``."""
from . import ops, ref  # noqa: F401
