"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.

28L d_model=2048 16H (MHA kv=16) d_ff=1408(expert) vocab=102400.
[arXiv:2401.06066; hf]  The same config as the reference package's.

Simplification vs HF checkpoint: the real model keeps layer 0 as a dense
FFN; here every layer is MoE + shared experts (uniform layer body), as
in the reference package.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    grad_accum=4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=96, vocab_size=256,
                         moe=MoEConfig(n_experts=8, top_k=2, n_shared=1,
                                       d_expert=96),
                         dtype="float32", remat="none")
