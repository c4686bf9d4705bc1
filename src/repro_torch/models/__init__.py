"""repro_torch.models -- the paper's closed-form application models
(``simple_ml``) and the LM zoo's dense decoder-only transformer (``layers``,
``attention``, ``transformer``) and Mamba2 model (``ssm``, ``mamba_lm``),
built through ``zoo``; the other LM families are not ported yet."""
from . import simple_ml  # noqa: F401
