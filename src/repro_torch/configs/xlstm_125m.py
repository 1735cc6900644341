"""xlstm-125m — sLSTM + mLSTM blocks (xLSTM[7:1]-ish at 12 layers).

12L d_model=768 4H vocab=50304 (d_ff=0: blocks carry their own
projections).  [arXiv:2405.04517]  The same config as the reference
package's.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_kind="xlstm", slstm_layers=(5, 11),  # ~7:1 mix at 12 layers
    tie_embeddings=True,
    grad_accum=1, model_axis_role="dp",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
                         vocab_size=256, slstm_layers=(1,),
                         dtype="float32", remat="none")
