"""Dense decoder-only transformer (the llama / mistral family) — training
forward and loss.

Counterpart of the dense path of ``repro/models/transformer.py``: the
same parameter tree (stacked per-layer weights under ``layers`` with a
leading layer axis), pre-norm blocks of GQA(+SWA) attention and a SwiGLU
MLP.  The reference scans over layers; here a Python loop walks the
layers over ``unbind`` views of the stacked weights (one stack of the
per-layer grads in backward, not one full-size scatter per layer).
``cfg.remat == "full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does around the
reference's scan body.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, torch_dtype


# --------------------------------------------------------------- param defs
def attn_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    defs: Dict[str, ParamDef] = {
        "wq": ParamDef((n, d, hq, hd), fan_in_dims=(1,)),
        "wk": ParamDef((n, d, hkv, hd), fan_in_dims=(1,)),
        "wv": ParamDef((n, d, hkv, hd), fan_in_dims=(1,)),
        "wo": ParamDef((n, hq, hd, d), fan_in_dims=(1, 2)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((n, hq, hd), init="zeros")
        defs["bk"] = ParamDef((n, hkv, hd), init="zeros")
        defs["bv"] = ParamDef((n, hkv, hd), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((n, hd), init="ones")
        defs["k_norm"] = ParamDef((n, hd), init="ones")
    return defs


def mlp_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((n, d, f), fan_in_dims=(1,)),
        "w_up": ParamDef((n, d, f), fan_in_dims=(1,)),
        "w_down": ParamDef((n, f, d), fan_in_dims=(1,)),
    }


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.moe is not None or cfg.norm != "rmsnorm" or cfg.act != "silu":
        raise NotImplementedError(
            f"{cfg.name}: only the dense rmsnorm/SwiGLU transformer is "
            "ported (other families: ROADMAP queue 1, item 10)")
    n = cfg.n_layers
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), init="embed",
                          fan_in_dims=(1,)),
        "final_norm": {"scale": ParamDef((cfg.d_model,), init="ones")},
        "layers": {
            "attn": attn_defs(cfg, n),
            "attn_norm": {"scale": ParamDef((n, cfg.d_model), init="ones")},
            "mlp_norm": {"scale": ParamDef((n, cfg.d_model), init="ones")},
            "mlp": mlp_defs(cfg, n),
        },
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                   fan_in_dims=(1,))
    return defs


# --------------------------------------------------------------- layer body
def _layer(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Pre-norm residual block."""
    h = L.apply_norm(cfg, x, w["attn_norm"])
    att = L.attention_block(cfg, h, w["attn"], cos, sin)
    # fused residual-add + norm: one pass produces the updated stream
    # AND its normed view for the MLP
    x, h = L.residual_apply_norm(cfg, att, x, w["mlp_norm"])
    return x + L.mlp_block(cfg, h, w["mlp"])


def _layer_weights(layer_params: Any, n: int):
    """Per-layer weight trees: views of the stacked leaves."""
    flat, treedef = tree_util.flatten(layer_params)
    per_leaf = [leaf.unbind(0) for leaf in flat]
    return [tree_util.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(n)]


# --------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (b, l) -> logits (b, l, v), aux."""
    b, l = tokens.shape
    x = L.embed(tokens, params["embed"]).to(torch_dtype(cfg.dtype))
    positions = torch.arange(l, device=tokens.device)
    cos, sin = L.rotary_embedding(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    for w in _layer_weights(params["layers"], cfg.n_layers):
        if cfg.remat == "full":
            x = checkpoint(_layer, cfg, x, w, cos, sin, use_reentrant=False)
        else:
            x = _layer(cfg, x, w, cos, sin)
    x = L.apply_norm(cfg, x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return (L.unembed(x, table, cfg.vocab_size),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    logits, aux = forward(cfg, params, batch["tokens"])
    nll = L.cross_entropy(logits, batch["labels"])
    return nll, {"loss": nll, "aux_loss": aux}
