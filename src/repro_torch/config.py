"""Configuration system: model / shape configs + the arch registry, a copy of
the JAX package's ``repro/config.py`` with the same fields, defaults and
derived properties, so a config compares 1:1 with its JAX twin.

Every assigned architecture is a ``ModelConfig``; ``get_config(name)``
resolves it from ``repro_torch/configs/<id>.py``. All ten architectures
are here and build: dense, moe and vlm through ``models/transformer.py``,
ssm through ``mamba_lm.py``, hybrid through ``hybrid.py`` and audio through
``encdec.py``.
Shapes (the assignment's per-arch input shapes) are ``ShapeConfig``s. The
dry-run grid ``cells()`` waits for the dry-run slice (ROADMAP A.12).

``attention_impl`` keeps the JAX values: ``"xla"`` is the plain torch path
(:func:`repro_torch.models.attention.sdpa` / ``chunked_sdpa``) and
``"pallas"`` selects kernel B4, the hand-written CUDA flash attention in
``repro_torch/kernels/flash_attention`` (its plain version on CPU tensors).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 32000
    # attention
    rope_theta: float = 1e6
    sliding_window: int = 0           # 0 -> full attention
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim sections
    norm_eps: float = 1e-5
    act: str = "swiglu"               # swiglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    # dispatch groups: routing/capacity is computed per group; set to the DP
    # shard count by the launcher so dispatch buffers stay batch-sharded
    moe_groups: int = 1
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2-style): one shared attention block every `attn_every` layers
    attn_every: int = 0
    # encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500           # stubbed conv-frontend output frames
    # modality frontend stubs (vlm/audio): inputs are precomputed embeddings
    embed_stub: bool = False
    # kv-head replication for decode caches when num_kv_heads < TP degree
    # (set by the launcher; repeats kv heads so the cache shards TP-ways)
    kv_replication: int = 1
    # online-softmax chunked attention threshold/block (0 = always-dense SDPA);
    # sequences >= this length use flash-style blocked attention
    attn_chunk: int = 8192
    # §Perf knobs (beyond-paper; baselines keep the defaults)
    cast_params_once: bool = False   # pre-cast params to bf16 before the layer
    #                                  stack: FSDP all-gathers move bf16 not f32
    fsdp_params: bool = True         # False = inference weight layout (TP-only,
    #                                  no per-step weight gathers for decode)
    # numerics / perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True                # remat each block in train fwd
    scan_layers: bool = True          # lax.scan over stacked layer params
    attention_impl: str = "xla"       # xla | pallas (= kernel B4 here)

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for clean 2-axis sharding
        (standard practice; padding rows are never routed to)."""
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state / hybrid /
        bounded sliding-window cache.)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding unpadded; used for 6ND)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = self._ssm_layer_params()
            return emb + self.num_layers * per + d  # final norm
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.act == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.num_experts:
            mlp = self.num_experts * mlp + d * self.num_experts  # + router
        norms = 2 * d
        per_layer = attn + mlp + norms
        if self.family == "hybrid":
            n_attn = self.num_layers // max(self.attn_every, 1)
            per_ssm = self._ssm_layer_params()
            return emb + self.num_layers * per_ssm + 1 * (attn + 2 * d * self.d_ff) + d
        total = emb + self.num_layers * per_layer + d
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder adds cross-attn (already in
            # num_layers loop? no -- count decoder cross attn explicitly)
            enc = self.encoder_layers * (attn + mlp + norms)
            cross = self.num_layers * (attn + d)
            total += enc + cross
        return total

    def _ssm_layer_params(self) -> int:
        d, din, ns = self.d_model, self.ssm_d_inner, self.ssm_state
        g, h = self.ssm_groups, self.ssm_heads
        in_proj = d * (2 * din + 2 * g * ns + h)
        conv = (din + 2 * g * ns) * self.ssm_conv_width
        out = din * d
        return in_proj + conv + out + 2 * h + din + d

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top-k of experts) for 6*N_active*D."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        mlp_all = self.num_experts * (3 if self.act == "swiglu" else 2) * d * self.d_ff
        mlp_act = self.num_experts_per_tok * (3 if self.act == "swiglu" else 2) * d * self.d_ff
        return self.param_count() - self.num_layers * (mlp_all - mlp_act)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode
    microbatches: int = 1   # gradient-accumulation factor for train shapes


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "qwen2_vl_2b",
    "zamba2_2p7b",
    "granite_moe_3b",
    "mixtral_8x22b",
    "mamba2_370m",
    "granite_20b",
    "command_r_35b",
    "stablelm_12b",
    "mistral_large_123b",
    "whisper_large_v3",
]

# external-name -> module-name aliases (assignment ids use dashes/dots)
ALIASES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-370m": "mamba2_370m",
    "granite-20b": "granite_20b",
    "command-r-35b": "command_r_35b",
    "stablelm-12b": "stablelm_12b",
    "mistral-large-123b": "mistral_large_123b",
    "whisper-large-v3": "whisper_large_v3",
}


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{ALIASES.get(name, name)}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE
