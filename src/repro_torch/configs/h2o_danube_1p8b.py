"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
[arXiv:2401.16818; hf]  The same config as the reference package's.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0,
    grad_accum=1, model_axis_role="dp",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=160, vocab_size=256, sliding_window=16,
                         dtype="float32", remat="none")
