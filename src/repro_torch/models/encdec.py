"""Whisper-style encoder-decoder backbone — training forward and the
serving halves.

Counterpart of ``repro/models/encdec.py``: the mel/conv frontend is a
stub (the data stream provides precomputed frame embeddings ``frames``
(batch, frames, d_model)); the encoder adds sinusoidal positions, the
decoder learned ones.  Pre-LN blocks with LayerNorm (with bias), a GELU
MLP, tied embeddings, causal self-attention and cross-attention to the
encoder output.  Every op is plain PyTorch, as the reference's are XLA:
its attention passes an explicit mask and no causal structure, so it
never reaches the kernel registry (``layers.masked_attention``).

The reference scans over layers; here a Python loop walks ``unbind``
views of the stacked weights, each layer under ``torch.utils.checkpoint``
when ``cfg.remat == "full"``, as ``transformer.forward`` does.

Serving: ``prefill_cross_kv`` computes every decoder layer's cross K/V
once from the encoder output; ``forward_decode`` decodes one token over
a self-attention KV ring cache, updated in place.  The serving engine
refuses the audio family in both packages (its prompts are tokens, not
frames).  ``cache_specs`` places the cache on a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.models.sharding import remat_contexts


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    ne = cfg.n_encoder_layers or cfg.n_layers
    nd = cfg.n_layers
    d = cfg.d_model
    enc_layer = {
        "attn": T.attn_defs(cfg, ne),
        "attn_norm": T.norm_defs(cfg, ne),
        "mlp": T.mlp_defs(cfg, ne),
        "mlp_norm": T.norm_defs(cfg, ne),
    }
    dec_layer = {
        "self_attn": T.attn_defs(cfg, nd),
        "self_norm": T.norm_defs(cfg, nd),
        "cross_attn": T.attn_defs(cfg, nd),
        "cross_norm": T.norm_defs(cfg, nd),
        "mlp": T.mlp_defs(cfg, nd),
        "mlp_norm": T.norm_defs(cfg, nd),
    }
    return {
        "embed": ParamDef((cfg.padded_vocab, d), init="embed",
                          fan_in_dims=(1,), axes=("model", "fsdp")),
        # sized for the reference's largest decode shape (32k); real
        # whisper caps at 448
        "pos_embed": ParamDef((32768, d), scale=0.02, axes=(None, "fsdp")),
        "encoder": enc_layer,
        "enc_final": T._unstack_norm(cfg),
        "decoder": dec_layer,
        "dec_final": T._unstack_norm(cfg),
    }


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sines then cosines of ``pos / 10000^(2i/d)``,
    each division by a tensor (IEEE on the card too)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    expo = 2 * dim / torch.full((), d, dtype=torch.float32, device=device)
    ang = pos / torch.pow(10000.0, expo)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _xattn(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
           kv_src: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None,
           precomputed_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Self- or cross-attention without rotary (whisper uses absolute
    positions); ``mask`` (lq, lk), all True when None."""
    q = L._project(x, w["wq"])
    if cfg.qkv_bias:
        q = q + w["bq"]
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if kv_src is None else kv_src
        k = L._project(src, w["wk"])
        v = L._project(src, w["wv"])
        if cfg.qkv_bias:
            k, v = k + w["bk"], v + w["bv"]
    if mask is None:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
    out = L.masked_attention(cfg, q, k, v, mask)
    return L._out_project(out, w["wo"])


def _enc_layer(cfg: ModelConfig, x: torch.Tensor,
               w: Dict[str, Any]) -> torch.Tensor:
    h = L.apply_norm(cfg, x, w["attn_norm"])
    y = x + _xattn(cfg, h, w["attn"])
    h = L.apply_norm(cfg, y, w["mlp_norm"])
    return y + L.mlp_block(cfg, h, w["mlp"])


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
               enc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, x, w["self_norm"])
    y = x + _xattn(cfg, h, w["self_attn"], mask=mask)
    h = L.apply_norm(cfg, y, w["cross_norm"])
    y = y + _xattn(cfg, h, w["cross_attn"], kv_src=enc)
    h = L.apply_norm(cfg, y, w["mlp_norm"])
    return y + L.mlp_block(cfg, h, w["mlp"])


def _run(cfg: ModelConfig, body, x: torch.Tensor, layer_params: Any,
         n: int, *extra) -> torch.Tensor:
    """``body`` over the stacked layers, checkpointed under remat."""
    for w in T.layer_weights(layer_params, n):
        if cfg.remat == "full":
            x = checkpoint(body, cfg, x, w, *extra, use_reentrant=False,
                           context_fn=remat_contexts)
        else:
            x = body(cfg, x, w, *extra)
    return x


def encode(cfg: ModelConfig, params: Dict[str, Any],
           frames: torch.Tensor) -> torch.Tensor:
    """frames (b, l_enc, d_model) -> encoder states (b, l_enc, d_model)."""
    _, l, d = frames.shape
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt) + _sinusoid(l, d, device=frames.device).to(dt)[None]
    x = _run(cfg, _enc_layer, x, params["encoder"],
             cfg.n_encoder_layers or cfg.n_layers)
    return L.apply_norm(cfg, x, params["enc_final"])


def decode_train(cfg: ModelConfig, params: Dict[str, Any],
                 tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens (b, l) and the encoder states ->
    f32 logits (b, l, v_padded)."""
    _, l = tokens.shape
    x = (L.embed(tokens, params["embed"])
         + params["pos_embed"][:l][None]).to(torch_dtype(cfg.dtype))
    mask = L.causal_window_mask(l, l, device=tokens.device)
    x = _run(cfg, _dec_layer, x, params["decoder"], cfg.n_layers, enc,
             mask)
    x = L.apply_norm(cfg, x, params["dec_final"])
    return L.unembed(x, params["embed"], cfg.vocab_size)


def forward(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, a zero aux loss) of a batch with ``frames`` and
    ``tokens``."""
    enc = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, batch["tokens"], enc)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


# --------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer self-attention KV cache and cross K/V, zeros."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    shape = lambda s: (cfg.n_layers, batch, s, hkv, hd)
    return {name: torch.zeros(shape(s), dtype=dt, device=device)
            for name, s in (("self_k", max_seq), ("self_v", max_seq),
                            ("cross_k", enc_len), ("cross_v", enc_len))}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                rules) -> Dict[str, Any]:
    """The cache's ``PartitionSpec``s: batch over the data axes, the
    sequence over ``cache_seq`` (``rules=None``: replicated)."""
    from repro_torch.models.sharding import PartitionSpec as P
    nd = cfg.n_layers
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    axes = (None, "batch", "cache_seq", None, None)

    def spec(s):
        return P() if rules is None else rules.spec(axes, s)

    return {
        "self_k": spec((nd, batch, max_seq, hkv, hd)),
        "self_v": spec((nd, batch, max_seq, hkv, hd)),
        "cross_k": spec((nd, batch, enc_len, hkv, hd)),
        "cross_v": spec((nd, batch, enc_len, hkv, hd)),
    }


def prefill_cross_kv(cfg: ModelConfig, params: Dict[str, Any],
                     enc: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V of every decoder layer from the encoder output, stacked
    (n_layers, b, l_enc, hkv, hd) in the model dtype."""
    dt = torch_dtype(cfg.dtype)
    ks, vs = [], []
    for w in T.layer_weights(params["decoder"], cfg.n_layers):
        k = L._project(enc, w["cross_attn"]["wk"])
        v = L._project(enc, w["cross_attn"]["wv"])
        if cfg.qkv_bias:
            k = k + w["cross_attn"]["bk"]
            v = v + w["cross_attn"]["bv"]
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    return torch.stack(ks), torch.stack(vs)


def forward_decode(cfg: ModelConfig, params: Dict[str, Any],
                   token: torch.Tensor, cache: Dict[str, torch.Tensor],
                   index: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (b, 1) at position ``index`` (a host int)
    over the self-attention ring (updated in place) and the precomputed
    cross K/V.  Returns (logits (b, 1, v), cache)."""
    x = (L.embed(token, params["embed"])
         + params["pos_embed"][index][None, None]).to(torch_dtype(cfg.dtype))
    for i, w in enumerate(T.layer_weights(params["decoder"], cfg.n_layers)):
        h = L.apply_norm(cfg, x, w["self_norm"])
        y = x + L.decode_attention_block(
            cfg, h, w["self_attn"],
            {"k": cache["self_k"][i], "v": cache["self_v"][i]}, index)
        h = L.apply_norm(cfg, y, w["cross_norm"])
        y = y + _xattn(cfg, h, w["cross_attn"],
                       precomputed_kv=(cache["cross_k"][i],
                                       cache["cross_v"][i]))
        h = L.apply_norm(cfg, y, w["mlp_norm"])
        x = y + L.mlp_block(cfg, h, w["mlp"])
    x = L.apply_norm(cfg, x, params["dec_final"])
    return L.unembed(x, params["embed"], cfg.vocab_size), cache
