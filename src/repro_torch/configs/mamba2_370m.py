"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality). [arXiv:2405.21060]

Attention-free: decode state is O(1) in context length.
d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_groups=1,
    ssm_chunk=8,
    tie_embeddings=True,
)
