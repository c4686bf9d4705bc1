"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (temporal/height/width rotary sections) + dynamic-resolution vision
frontend; per the assignment the frontend is a STUB -- precomputed patch
embeddings (``batch["frontend_embeds"]``, ``zoo.make_demo_batch``) are
prepended to the text tokens, and the backbone here is the full transformer. [arXiv:2409.12191]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # half-dim rotary sections (t, h, w)
    act="swiglu",
    use_bias=True,                 # qwen2 uses qkv bias
    tie_embeddings=True,
    embed_stub=True,
)

SMOKE = ModelConfig(
    name="qwen2_vl_2b_smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mrope_sections=(2, 3, 3),
    act="swiglu",
    use_bias=True,
    tie_embeddings=True,
    embed_stub=True,
)
