"""Architecture registry: config -> param defs / init / loss / decode.

Counterpart of ``repro/models/registry.py``, every family of it:

  dense | moe | vlm -> transformer.py (llama/qwen/mistral/qwen3/deepseek;
                       chameleon: early-fusion VQ tokens = LM)
  ssm               -> ssm.py         (xLSTM)
  hybrid            -> hybrid.py      (jamba)
  audio             -> encdec.py      (whisper backbone, stub frontend)

``state_specs`` gives each family's decode state its placement on a
mesh, as the reference's does.
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
    #: ``(cfg, batch, max_seq, rules) -> PartitionSpec tree`` of the
    #: decode state (the audio family's also takes the encoder length)
    state_specs: Optional[Callable[..., Any]] = None


def _ssm_loss(cfg: ModelConfig, params, batch):
    logits, aux = ssm.xlstm_forward(cfg, params, batch["tokens"])
    return cross_entropy(logits, batch["labels"]), {"aux_loss": aux}


def _encdec_loss(cfg: ModelConfig, params, batch):
    logits, aux = encdec.forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"]), {"aux_loss": aux}


def _lm_init_state(cfg: ModelConfig, batch: int, max_seq: int,
                   device=None):
    return transformer.init_cache(cfg, batch, max_seq, device=device)


def _lm_state_specs(cfg: ModelConfig, batch: int, max_seq: int, rules):
    return transformer.cache_specs(cfg, batch, max_seq, rules)


def _ssm_state_specs(cfg: ModelConfig, batch: int, max_seq: int, rules):
    from repro_torch import tree as tree_util
    from repro_torch.models.sharding import PartitionSpec
    state = ssm.xlstm_init_state(cfg, batch, device="meta")

    def leaf_spec(x):
        if rules is None:
            return PartitionSpec()
        # (layer, batch, heads, [hd, [hd]]): batch over DP axes; the
        # per-head state dim over 'model' where it divides (192/16 ok)
        axes = [None] * x.dim()
        if x.dim() >= 2:
            axes[1] = "batch"
        if x.dim() >= 4:
            axes[3] = "model"
        return rules.spec(axes, x.shape)

    return tree_util.tree_map(leaf_spec, state)


def _hybrid_state_specs(cfg: ModelConfig, batch: int, max_seq: int, rules):
    return hybrid.state_specs(cfg, batch, max_seq, rules)


_LM = Family(transformer.param_defs, transformer.loss_fn,
             transformer.forward_decode, _lm_init_state, _lm_state_specs)

FAMILIES: Dict[str, Family] = {
    "dense": _LM,
    "moe": _LM,
    "vlm": _LM,
    "ssm": Family(ssm.xlstm_param_defs, _ssm_loss, ssm.xlstm_decode,
                  ssm.xlstm_init_state, _ssm_state_specs),
    "hybrid": Family(hybrid.param_defs, hybrid.loss_fn, hybrid.forward_decode,
                     hybrid.init_state, _hybrid_state_specs),
    "audio": Family(encdec.param_defs, _encdec_loss, encdec.forward_decode,
                    encdec.init_cache, encdec.cache_specs),
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
    return P.sds_tree(param_defs(cfg), cfg.dtype)


def param_specs(cfg: ModelConfig, rules) -> Any:
    return P.spec_tree(param_defs(cfg), rules)



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


def loss_fn(cfg: ModelConfig, moe_means: Optional[Callable] = None
            ) -> Callable:
    """``(params, batch) -> (loss, parts)``; ``moe_means`` replaces the
    MoE aux loss's hook (``moe.moe_block``) of a model with experts."""
    if moe_means is None or cfg.moe is None:
        return functools.partial(family(cfg).loss_fn, cfg)
    return functools.partial(family(cfg).loss_fn, cfg,
                             part=transformer.Whole(moe_means))


def decode_fn(cfg: ModelConfig) -> Callable:
    return functools.partial(family(cfg).decode_fn, cfg)
