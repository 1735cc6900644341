"""chameleon-34b — early-fusion VLM: VQ image tokens share the text vocab,
so the backbone is a dense LM with qk-norm over a 65536 vocab.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
[arXiv:2405.09818; unverified]  The same config as the reference
package's.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope_theta=10_000.0,
    optimizer="adafactor",
    grad_accum=16,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=160, vocab_size=256, dtype="float32",
                         remat="none")
