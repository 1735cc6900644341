"""Architecture registry: config -> param defs / init / loss.

Counterpart of ``repro/models/registry.py`` for the families the port
runs: ``dense`` (``transformer.py``) and ``hybrid`` (``hybrid.py``,
Jamba).  The reference's moe / ssm / audio / vlm families come with
ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import hybrid, transformer
from repro_torch.models import params as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_entropy


@dataclasses.dataclass(frozen=True)
class Family:
    param_defs: Callable[[ModelConfig], Any]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


def _hybrid_loss(cfg: ModelConfig, params, batch):
    logits, aux = hybrid.forward(cfg, params, batch["tokens"])
    nll = cross_entropy(logits, batch["labels"])
    w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return nll + w * aux, {"loss": nll, "aux_loss": aux}


FAMILIES: Dict[str, Family] = {
    "dense": Family(transformer.param_defs, transformer.loss_fn),
    "hybrid": Family(hybrid.param_defs, _hybrid_loss),
}


def family(cfg: ModelConfig) -> Family:
    fam = FAMILIES.get(cfg.family)
    if fam is None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1, item 10)")
    return fam


def param_defs(cfg: ModelConfig) -> Any:
    return family(cfg).param_defs(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Any:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (default ``cuda:0``; raises without CUDA — pass
    ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return P.init_tree(param_defs(cfg), gen, cfg.dtype, dev)


def abstract_params(cfg: ModelConfig) -> Any:
    """The parameter tree's shapes and dtypes as ``meta`` tensors: what
    a shard plan needs, with no memory behind it."""
    from repro_torch import tree as tree_util
    return tree_util.tree_map(
        lambda d: torch.empty(d.shape, device="meta",
                              dtype=P.torch_dtype(d.dtype or cfg.dtype)),
        param_defs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return P.count(param_defs(cfg))


def loss_fn(cfg: ModelConfig) -> Callable:
    return functools.partial(family(cfg).loss_fn, cfg)
