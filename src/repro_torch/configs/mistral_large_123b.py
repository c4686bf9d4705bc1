"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. The memory-pressure stressor of the assigned pool.
[hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral_large_123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="mistral_large_smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=512,
    act="swiglu",
)
