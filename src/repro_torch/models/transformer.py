"""Decoder-only transformer (llama / qwen / mistral / chameleon, and the
MoE transformers qwen3-moe / deepseek-moe) — training forward and loss,
serving prefill and KV-cache decode.

Counterpart of ``repro/models/transformer.py``: the same parameter tree
(stacked per-layer weights under ``layers`` with a leading layer axis),
pre-norm blocks of GQA(+SWA) attention, with optional QKV bias and q/k
norms, and a SwiGLU MLP, or with ``cfg.moe`` an MoE FFN (``moe.py``)
whose load-balancing loss each layer returns and ``forward`` sums.  The
GELU MLP and the layernorm ``norm_defs`` serve the encoder-decoder
(``encdec.py``).  The reference scans over layers; here a Python loop walks the
layers over ``unbind`` views of the stacked weights (one stack of the
per-layer grads in backward, not one full-size scatter per layer).
``cfg.remat == "full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does around the
reference's scan body.

Serving (``forward_prefill``, ``init_cache``, ``forward_decode``) is the
reference's, with one difference of form: decode updates the cache
tensors in place and returns the same dict (the reference's scan
returns new arrays).  The reference's ``cache_specs`` places the cache
on a mesh; it comes with the SPMD slice (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
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
    if cfg.act == "silu":
        return {
            "w_gate": ParamDef((n, d, f), fan_in_dims=(1,)),
            "w_up": ParamDef((n, d, f), fan_in_dims=(1,)),
            "w_down": ParamDef((n, f, d), fan_in_dims=(1,)),
        }
    return {
        "w_up": ParamDef((n, d, f), fan_in_dims=(1,)),
        "b_up": ParamDef((n, f), init="zeros"),
        "w_down": ParamDef((n, f, d), fan_in_dims=(1,)),
        "b_down": ParamDef((n, d), init="zeros"),
    }


def norm_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    """A stacked norm: ``scale``, and ``bias`` under layernorm."""
    defs = {"scale": ParamDef((n, cfg.d_model), init="ones")}
    if cfg.norm == "layernorm":
        defs["bias"] = ParamDef((n, cfg.d_model), init="zeros")
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    n = cfg.n_layers
    layer: Dict[str, Any] = {
        "attn": attn_defs(cfg, n),
        "attn_norm": norm_defs(cfg, n),
        "mlp_norm": norm_defs(cfg, n),
    }
    if cfg.moe is not None:
        layer["moe"] = moe_lib.moe_defs(cfg, n)
    else:
        layer["mlp"] = mlp_defs(cfg, n)
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), init="embed",
                          fan_in_dims=(1,)),
        "final_norm": _unstack_norm(cfg),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                   fan_in_dims=(1,))
    return defs


def _unstack_norm(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """One norm (the final one): ``scale``, and ``bias`` under
    layernorm."""
    defs = {"scale": ParamDef((cfg.d_model,), init="ones")}
    if cfg.norm == "layernorm":
        defs["bias"] = ParamDef((cfg.d_model,), init="zeros")
    return defs


# --------------------------------------------------------------- layer body
def _ffn(cfg: ModelConfig, h: torch.Tensor, w: Dict[str, Any]):
    """The FFN sublayer: (out, the MoE's aux loss, or None for the dense
    MLP, whose aux is zero)."""
    if "moe" in w:
        return moe_lib.moe_block(cfg, h, w["moe"])
    return L.mlp_block(cfg, h, w["mlp"]), None


def _layer(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
           cos: torch.Tensor, sin: torch.Tensor, collect_kv: bool = False):
    """Pre-norm residual block.  Returns (x, aux) (aux None for a dense
    MLP); with ``collect_kv`` also the attention's post-rotary (k, v)."""
    h = L.apply_norm(cfg, x, w["attn_norm"])
    att = L.attention_block(cfg, h, w["attn"], cos, sin,
                            collect_kv=collect_kv)
    if collect_kv:
        att, kv = att
    # fused residual-add + norm: one pass produces the updated stream
    # AND its normed view for the FFN
    x, h = L.residual_apply_norm(cfg, att, x, w["mlp_norm"])
    out, aux = _ffn(cfg, h, w)
    return (x + out, aux, kv) if collect_kv else (x + out, aux)


def layer_weights(layer_params: Any, n: int):
    """Per-layer weight trees: views of the stacked leaves."""
    flat, treedef = tree_util.flatten(layer_params)
    per_leaf = [leaf.unbind(0) for leaf in flat]
    return [tree_util.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(n)]


# --------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (b, l) -> logits (b, l, v), the aux loss
    summed over layers (zero without MoE)."""
    b, l = tokens.shape
    x = L.embed(tokens, params["embed"]).to(torch_dtype(cfg.dtype))
    positions = torch.arange(l, device=tokens.device)
    cos, sin = L.rotary_embedding(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for w in layer_weights(params["layers"], cfg.n_layers):
        if cfg.remat == "full":
            # the checkpointed layer returns its aux too, so the aux
            # loss's gradient flows through the recompute
            x, aux = checkpoint(_layer, cfg, x, w, cos, sin,
                                use_reentrant=False)
        else:
            x, aux = _layer(cfg, x, w, cos, sin)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.apply_norm(cfg, x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.vocab_size), aux_total


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``nll + aux_loss_weight · aux`` (the weight 0 without MoE), and
    the parts: ``loss`` is the nll."""
    logits, aux = forward(cfg, params, batch["tokens"])
    nll = L.cross_entropy(logits, batch["labels"])
    weight = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return nll + weight * aux, {"loss": nll, "aux_loss": aux}


# --------------------------------------------------------------- serving
def forward_prefill(cfg: ModelConfig, params: Dict[str, Any],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Serving prefill: last-position logits (b, 1, v) and the populated
    KV cache.

    Only the final position is normed and unembedded; the per-layer
    post-rotary K/V are stacked into the decode cache layout
    (n_layers, b, l, hkv, hd), quantized when ``cfg.kv_cache_dtype ==
    'int8'``.  An inference path: no remat."""
    b, l = tokens.shape
    dt = torch_dtype(cfg.dtype)
    x = L.embed(tokens, params["embed"]).to(dt)
    positions = torch.arange(l, device=tokens.device)
    cos, sin = L.rotary_embedding(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    quantized = cfg.kv_cache_dtype == "int8"
    kv = {}
    for w in layer_weights(params["layers"], cfg.n_layers):
        x, _, (k, v) = _layer(cfg, x, w, cos, sin, collect_kv=True)
        if quantized:
            for name, t in (("k", k), ("v", v)):
                q, s = L.quantize_kv(t)
                kv.setdefault(name, []).append(q)
                kv.setdefault(name + "_scale", []).append(s)
        else:
            kv.setdefault("k", []).append(k.to(dt))
            kv.setdefault("v", []).append(v.to(dt))
    x = L.apply_norm(cfg, x[:, -1:].contiguous(), params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return (L.unembed(x, table, cfg.vocab_size),
            {name: torch.stack(ts) for name, ts in kv.items()})


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None
               ) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV cache of zeros.  SWA models cap the ring at
    the window; ``cfg.kv_cache_dtype == 'int8'`` stores quantized K/V
    with per-(token, head) f32 scales (``layers.quantize_kv``)."""
    if cfg.sliding_window is not None:
        max_seq = min(max_seq, cfg.sliding_window)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def forward_decode(cfg: ModelConfig, params: Dict[str, Any],
                   token: torch.Tensor, cache: Dict[str, torch.Tensor],
                   index: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token (b, 1) at position ``index`` (a host int);
    cache leaves (n_layers, ...), updated in place.  Returns (logits
    (b, 1, v), cache).  Two norms a layer, as the reference's step: no
    fused residual+norm on this path.  An MoE FFN routes the one token in
    a single dispatch (``moe_block``'s branch for l = 1)."""
    x = L.embed(token, params["embed"]).to(torch_dtype(cfg.dtype))
    ws = layer_weights(params["layers"], cfg.n_layers)
    for i, w in enumerate(ws):
        layer_cache = {name: t[i] for name, t in cache.items()}
        h = L.apply_norm(cfg, x, w["attn_norm"])
        x = x + L.decode_attention_block(cfg, h, w["attn"], layer_cache,
                                         index)
        h = L.apply_norm(cfg, x, w["mlp_norm"])
        x = x + _ffn(cfg, h, w)[0]
    x = L.apply_norm(cfg, x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.vocab_size), cache
