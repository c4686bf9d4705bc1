"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

SWA makes the decode KV cache bounded by the window, so this arch RUNS the
long_500k cell (sub-quadratic serving; DESIGN.md §5).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="mixtral_smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
    sliding_window=16,
    act="swiglu",
)
