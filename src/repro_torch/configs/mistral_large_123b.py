"""mistral-large-123b — dense GQA.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]  The same config
as the reference package's.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1_000_000.0,
    optimizer="adafactor",
    grad_accum=16,
    decode_batch_shard=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                         d_ff=224, vocab_size=256, head_dim=16,
                         dtype="float32", remat="none")
