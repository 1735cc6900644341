"""Model configuration shared by every architecture family.

A field-for-field copy of the reference package's ``ModelConfig``, so a
config means the same thing on both sides.  The port reads every
family's fields; the reference's mesh-sharding knobs are kept so
configs stay identical; the mesh step builders read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts (DeepSeek-MoE)
    d_expert: int = 0         # expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25
    every: int = 1            # MoE on every k-th layer (Jamba: 2)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    # attention
    qkv_bias: bool = False                # qwen1.5
    qk_norm: bool = False                 # chameleon
    sliding_window: Optional[int] = None  # h2o-danube SWA
    rope_theta: float = 10_000.0
    use_rope: bool = True                 # jamba/whisper: no rotary
    # MoE
    moe: Optional[MoEConfig] = None
    # hybrid (jamba): attention on layers where i % attn_period == attn_offset
    attn_period: int = 0
    attn_offset: int = 0
    # ssm
    ssm_kind: str = ""                    # "xlstm" | "mamba"
    slstm_layers: Tuple[int, ...] = ()    # xLSTM: which layers are sLSTM
    d_state: int = 16                     # mamba state dim
    d_conv: int = 4                       # mamba depthwise conv width
    expand: int = 2                       # mamba inner expansion
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    # norm / glue
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    act: str = "silu"                     # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"                   # none | full (per-layer recompute)
    # the reference's chunking knobs (attn_chunk: attention over explicit
    # masks and on a mesh; moe_chunk, mamba_chunk) and mesh knobs
    # (model_axis_role, sequence_parallel, grad_accum, decode_batch_shard:
    # read by launch/steps.py and the rules it builds)
    attn_chunk: int = 512
    moe_chunk: int = 256
    mamba_chunk: int = 128
    scan_unroll: bool = False
    optimizer: str = "adamw"
    # worker-step kernel selection ("auto" | variant | per-op overrides,
    # see repro_torch.kernels.interface); validated upstream by api.spec
    kernels: str = "auto"
    model_axis_role: str = "tp"
    sequence_parallel: bool = True
    grad_accum: int = 1
    decode_batch_shard: bool = True
    kv_cache_dtype: str = ""
    # embedding tables padded up to a multiple of this; padded logits are
    # masked in unembed
    vocab_pad_to: int = 16

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def is_attention_layer(self, i: int) -> bool:
        """Hybrid interleave (Jamba 1:7 -> attn_period=8)."""
        if self.attn_period <= 0:
            return True
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1)

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        from repro_torch.models.registry import count_params  # avoids cycle
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through: the routed experts it is not
        sent to left out."""
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **overrides)
