"""qwen1.5-32b — dense with QKV bias; 40 heads, MHA (kv=40), and an int8
KV cache for serving.

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
[hf:Qwen/Qwen1.5-0.5B family scaling; hf]  The same config as the
reference package's.  Its smoke config has head dim 12 (d_model 60, 5
heads), which the attention kernel takes padded to 16.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    optimizer="adafactor",
    grad_accum=8,
    decode_batch_shard=False,
    kv_cache_dtype="int8",     # quantized K/V, per-(token, head) scales
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=60, n_heads=5, n_kv_heads=5,
                         d_ff=144, vocab_size=256, dtype="float32",
                         remat="none")
