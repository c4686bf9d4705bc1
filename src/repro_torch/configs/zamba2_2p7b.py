"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention block.

The Zamba2 pattern: every ``attn_every`` Mamba2 layers, one attention+MLP block
whose WEIGHTS ARE SHARED across all invocations (each invocation has its own KV
cache). [arXiv:2411.15242]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_2p7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_groups=1,
    attn_every=6,                  # 9 shared-attention invocations over 54 layers
    act="swiglu",
)

SMOKE = ModelConfig(
    name="zamba2_smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_groups=1,
    ssm_chunk=8,
    attn_every=2,
)
