"""whisper-tiny — encoder-decoder backbone; the conv/mel frontend is a
stub (the data stream provides precomputed frame embeddings).

4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865, LayerNorm+GELU,
tied embeddings.  [arXiv:2212.04356]  The same config as the reference
package's.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, n_encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    norm="layernorm", act="gelu", use_rope=False, tie_embeddings=True,
    grad_accum=1, model_axis_role="dp",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, n_encoder_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                         dtype="float32", remat="none")
