"""whisper-large-v3 [audio]: enc-dec, 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866, conv frontend STUB. [arXiv:2212.04356]

Per the assignment, the modality frontend is a stub: ``batch["frontend_embeds"]``
(``zoo.make_demo_batch``) provides precomputed log-mel frame embeddings (1500
frames after the conv downsampler).
32 encoder layers (bidirectional) + 32 decoder layers (causal self-attn +
cross-attn). Sinusoidal positions (deviation from learned decoder positions is
noted in DESIGN.md -- keeps position tables O(1) for the mechanical 32k-decode
shape). Decode shapes lower the DECODER with a self-attn KV cache of the given
length + precomputed cross-attention K/V over the 1500 encoder frames.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_seq=1500,
    act="gelu",
    use_bias=True,
    rope_theta=0.0,           # 0 -> sinusoidal absolute positions, no RoPE
    embed_stub=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper_smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    is_encoder_decoder=True,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encoder_seq=12,
    act="gelu",
    use_bias=True,
    rope_theta=0.0,
    embed_stub=True,
    tie_embeddings=True,
)
