"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.

Note: the assignment's config field says 40e top-8 (the inline hf pointer is
the smaller granite-3.0-1b-a400m sibling); we implement the stated 40e/top-8.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_3b",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite_moe_smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
    act="swiglu",
    tie_embeddings=True,
)
