"""Optimizers and gradient compression."""

from repro_torch.optim.compression import (
    Compressor,
    int8_compressor,
    make_compressor,
    topk_compressor,
)
from repro_torch.optim.optimizers import (
    AdafactorState,
    AdamState,
    Optimizer,
    adafactor,
    adamw,
    make_optimizer,
    momentum,
    sgd,
)

__all__ = [
    "Optimizer", "sgd", "momentum", "adamw", "adafactor", "make_optimizer",
    "AdamState", "AdafactorState",
    "Compressor", "make_compressor", "int8_compressor", "topk_compressor",
]
