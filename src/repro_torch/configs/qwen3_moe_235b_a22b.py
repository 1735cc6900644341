"""qwen3-moe-235b-a22b — MoE, 128 experts top-8, fine-grained d_ff=1536.

94L d_model=4096 64H (GQA kv=4) d_ff=1536(expert) vocab=151936.
[hf:Qwen/Qwen3-30B-A3B family scaling; hf]  The same config as the
reference package's.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    optimizer="adafactor",
    grad_accum=16,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=96, vocab_size=256, head_dim=16,
                         moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
                         dtype="float32", remat="none")
