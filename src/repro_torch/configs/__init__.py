"""Architecture configs: every one of the reference package's ten — the
dense h2o-danube-1.8b, qwen1.5-110b, qwen1.5-32b and mistral-large-123b,
the early-fusion VLM chameleon-34b, the MoE transformers
qwen3-moe-235b-a22b and deepseek-moe-16b, the hybrid jamba-v0.1-52b, the
recurrent xlstm-125m (``ssm``) and the encoder-decoder whisper-tiny
(``audio``).

Each module exposes ``CONFIG`` (full-scale) and ``smoke_config()``
(reduced, same family), equal to the reference package's.
"""

import importlib

from repro_torch.models.config import ModelConfig

# CLI ids use dashes, as in the reference package
_ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen1.5-32b": "qwen15_32b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "chameleon-34b": "chameleon_34b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-125m": "xlstm_125m",
    "whisper-tiny": "whisper_tiny",
}


def arch_names():
    return list(_ALIASES)


def _module(name: str):
    mod = _ALIASES.get(name)
    if mod is None:
        raise KeyError(f"unknown architecture {name!r} (the port has "
                       f"{arch_names()})")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
