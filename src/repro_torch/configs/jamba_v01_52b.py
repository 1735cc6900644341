"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
[arXiv:2403.19887; hf]  The same config as the reference package's.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    attn_period=8, attn_offset=3, use_rope=False,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, every=2),
    d_state=16, d_conv=4, expand=2,
    optimizer="adafactor",
    grad_accum=8,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, head_dim=16,
                         attn_period=4, attn_offset=1,
                         moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                                       every=2),
                         dtype="float32", remat="none")
