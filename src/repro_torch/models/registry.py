"""Architecture registry: config -> param defs / init / loss.

The port covers the dense family (``transformer.py``); the reference's
moe / ssm / hybrid / audio / vlm families come with ROADMAP queue 1,
item 10.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1, item 10)")


def param_defs(cfg: ModelConfig) -> Any:
    _dense(cfg)
    return transformer.param_defs(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Any:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (default ``cuda:0``; raises without CUDA — pass
    ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return P.init_tree(param_defs(cfg), gen, cfg.dtype, dev)


def count_params(cfg: ModelConfig) -> int:
    return P.count(param_defs(cfg))


def loss_fn(cfg: ModelConfig) -> Callable:
    _dense(cfg)
    return functools.partial(transformer.loss_fn, cfg)
