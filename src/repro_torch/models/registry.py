"""Architecture registry: config -> param defs / init / loss / decode.

Counterpart of ``repro/models/registry.py``, every family of it:

  dense | moe | vlm -> transformer.py (llama/qwen/mistral/qwen3/deepseek;
                       chameleon: early-fusion VQ tokens = LM)
  ssm               -> ssm.py         (xLSTM)
  hybrid            -> hybrid.py      (jamba)
  audio             -> encdec.py      (whisper backbone, stub frontend)

The reference's ``state_specs`` (decode state on a mesh) comes with
ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models import params as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_entropy


@dataclasses.dataclass(frozen=True)
class Family:
    param_defs: Callable[[ModelConfig], Any]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    #: ``(cfg, params, token, state, index) -> (logits, state)``
    decode_fn: Optional[Callable[..., Any]] = None
    #: ``(cfg, batch, max_seq, device=None) -> state`` (the audio
    #: family's also takes the encoder length, as the reference's)
    init_state: Optional[Callable[..., Any]] = None


def _ssm_loss(cfg: ModelConfig, params, batch):
    logits, aux = ssm.xlstm_forward(cfg, params, batch["tokens"])
    return cross_entropy(logits, batch["labels"]), {"aux_loss": aux}


def _hybrid_loss(cfg: ModelConfig, params, batch):
    logits, aux = hybrid.forward(cfg, params, batch["tokens"])
    nll = cross_entropy(logits, batch["labels"])
    w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return nll + w * aux, {"loss": nll, "aux_loss": aux}


def _encdec_loss(cfg: ModelConfig, params, batch):
    logits, aux = encdec.forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"]), {"aux_loss": aux}


def _lm_init_state(cfg: ModelConfig, batch: int, max_seq: int,
                   device=None):
    return transformer.init_cache(cfg, batch, max_seq, device=device)


_LM = Family(transformer.param_defs, transformer.loss_fn,
             transformer.forward_decode, _lm_init_state)

FAMILIES: Dict[str, Family] = {
    "dense": _LM,
    "moe": _LM,
    "vlm": _LM,
    "ssm": Family(ssm.xlstm_param_defs, _ssm_loss, ssm.xlstm_decode,
                  ssm.xlstm_init_state),
    "hybrid": Family(hybrid.param_defs, _hybrid_loss, hybrid.forward_decode,
                     hybrid.init_state),
    "audio": Family(encdec.param_defs, _encdec_loss, encdec.forward_decode,
                    encdec.init_cache),
}


def family(cfg: ModelConfig) -> Family:
    return FAMILIES[cfg.family]


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


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters; with ``active_only`` the routed experts a token
    is not sent to are left out (the reference's count, exactly)."""
    total = P.count(param_defs(cfg))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * (m.d_expert or cfg.d_ff)
        n_moe_layers = sum(1 for i in range(cfg.n_layers)
                           if cfg.is_moe_layer(i))
        if cfg.family == "hybrid":
            period = cfg.attn_period or 1
            n_moe_layers = (cfg.n_layers // period) * sum(
                1 for j in range(period) if cfg.is_moe_layer(j))
        total -= max(0, n_moe_layers * (m.n_experts - m.top_k) * per_expert)
    return total


def loss_fn(cfg: ModelConfig) -> Callable:
    return functools.partial(family(cfg).loss_fn, cfg)


def decode_fn(cfg: ModelConfig) -> Callable:
    return functools.partial(family(cfg).decode_fn, cfg)
