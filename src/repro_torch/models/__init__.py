"""repro_torch.models -- the paper's closed-form application models
(``simple_ml``) and the LM zoo, built through ``zoo``: the decoder-only
transformer (``layers``, ``attention``, ``transformer``; dense, MoE via
``moe`` and vlm), Mamba2 (``ssm``, ``mamba_lm``), the zamba2-style hybrid
(``hybrid``) and the whisper-style encoder-decoder (``encdec``)."""
from . import simple_ml  # noqa: F401
