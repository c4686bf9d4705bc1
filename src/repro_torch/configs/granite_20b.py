"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576
vocab=49152 -- llama-arch code model. [arXiv:2405.04324]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite_20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="granite_20b_smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    act="swiglu",
)
