"""Jamba-style hybrid: Mamba/attention 1:7 interleave + MoE every 2nd
layer — training forward and decode.

Counterpart of the training half of ``repro/models/hybrid.py``: layer
``i`` is an attention layer iff ``i % attn_period == attn_offset``
(Jamba: period 8, offset 3); the FFN sublayer is MoE on every
``moe.every``-th slot of a period (Jamba: 2), dense SwiGLU otherwise,
and with ``moe=None``.  The parameter tree is the reference's: a
``"slots"`` tuple of per-slot dicts, each leaf with a leading axis of
``n_layers / attn_period`` period groups, so the packed wire plan lays
out the same bytes.  The reference scans over the groups; here a Python
loop walks them.  ``cfg.remat == "full"`` recomputes each slot in the
backward pass (``torch.utils.checkpoint``), as the reference's per-slot
``jax.checkpoint`` does; the reference's outer checkpoint around the
whole group only bounds what its scan saves, which a loop of per-slot
checkpoints already does.

Decode (``init_state``, ``forward_decode``) is the reference's: one
token through every group, the attention slot over its KV cache and
each Mamba slot one recurrence step (``ssm.mamba_decode``), the state
updated in place and returned.  The reference's ``state_specs`` places
the state on a mesh; it comes with the SPMD slice (ROADMAP queue 1,
item 11).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, torch_dtype


def _slot_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per period-slot: ('attn'|'mamba', 'moe'|'mlp')."""
    period = cfg.attn_period or 1
    kinds = []
    for j in range(period):
        mixer = "attn" if cfg.is_attention_layer(j) else "mamba"
        ffn = "moe" if cfg.is_moe_layer(j) else "mlp"
        kinds.append((mixer, ffn))
    return kinds


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    period = cfg.attn_period or 1
    if cfg.n_layers % period:
        raise ValueError("n_layers must be a multiple of attn_period")
    groups = cfg.n_layers // period
    norm = {"scale": ParamDef((groups, cfg.d_model), init="ones")}
    slots = []
    for mixer, ffn in _slot_kinds(cfg):
        slot: Dict[str, Any] = {"mixer_norm": dict(norm),
                                "ffn_norm": dict(norm)}
        if mixer == "attn":
            slot["attn"] = T.attn_defs(cfg, groups)
        else:
            slot["mamba"] = ssm.mamba_defs(cfg, groups)
        if ffn == "moe":
            slot["moe"] = moe_lib.moe_defs(cfg, groups)
        else:
            slot["mlp"] = T.mlp_defs(cfg, groups)
        slots.append(slot)
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), init="embed",
                          fan_in_dims=(1,)),
        "final_norm": {"scale": ParamDef((cfg.d_model,), init="ones")},
        "slots": tuple(slots),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                   fan_in_dims=(1,))
    return defs


def _slot_body(cfg: ModelConfig, mixer: str, ffn: str, x: torch.Tensor,
               w: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.apply_norm(cfg, x, w["mixer_norm"])
    if mixer == "attn":
        # rope is off for jamba (use_rope=False): no cos/sin
        mix = L.attention_block(cfg, h, w["attn"], None, None)
    else:
        mix = ssm.mamba_block(cfg, h, w["mamba"])
    # fused residual-add + norm via the kernel registry
    x, h = L.residual_apply_norm(cfg, mix, x, w["ffn_norm"])
    if ffn == "moe":
        out, aux = moe_lib.moe_block(cfg, h, w["moe"])
    else:
        out = L.mlp_block(cfg, h, w["mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (b, l) -> logits (b, l, v), summed aux."""
    kinds = _slot_kinds(cfg)
    groups = cfg.n_layers // (cfg.attn_period or 1)
    x = L.embed(tokens, params["embed"]).to(torch_dtype(cfg.dtype))
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # per slot: its weights of every group, as views of the stacked leaves
    per_slot = [T.layer_weights(slot, groups) for slot in params["slots"]]
    for g in range(groups):
        for (mixer, ffn), ws in zip(kinds, per_slot):
            if cfg.remat == "full":
                x, aux = checkpoint(_slot_body, cfg, mixer, ffn, x, ws[g],
                                    use_reentrant=False)
            else:
                x, aux = _slot_body(cfg, mixer, ffn, x, ws[g])
            aux_total = aux_total + aux
    x = L.apply_norm(cfg, x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.vocab_size), aux_total


# --------------------------------------------------------------- serving
def init_state(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Any]:
    """Decode state of zeros: one attention layer's KV cache per group,
    and the conv tail and f32 scan state of each group's period-1 Mamba
    slots."""
    period = cfg.attn_period or 1
    groups = cfg.n_layers // period
    di = cfg.expand * cfg.d_model
    dt = torch_dtype(cfg.dtype)
    kv_shape = (groups, batch, max_seq, cfg.n_kv_heads,
                cfg.resolved_head_dim)
    return {
        "kv": {"k": torch.zeros(kv_shape, dtype=dt, device=device),
               "v": torch.zeros(kv_shape, dtype=dt, device=device)},
        "mamba": {
            "conv": torch.zeros((groups, period - 1, batch, cfg.d_conv - 1,
                                 di), dtype=dt, device=device),
            "h": torch.zeros((groups, period - 1, batch, di, cfg.d_state),
                             dtype=torch.float32, device=device),
        },
    }


def forward_decode(cfg: ModelConfig, params: Dict[str, Any],
                   token: torch.Tensor, state: Dict[str, Any], index: int,
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (b, 1) at position ``index`` (a host int).
    Returns (logits (b, 1, v), state), the state updated in place."""
    kinds = _slot_kinds(cfg)
    groups = cfg.n_layers // (cfg.attn_period or 1)
    x = L.embed(token, params["embed"]).to(torch_dtype(cfg.dtype))
    per_slot = [T.layer_weights(slot, groups) for slot in params["slots"]]
    kv, mamba = state["kv"], state["mamba"]
    for g in range(groups):
        mi = 0  # mamba slot counter within the group
        for (mixer, ffn), ws in zip(kinds, per_slot):
            w = ws[g]
            h = L.apply_norm(cfg, x, w["mixer_norm"])
            if mixer == "attn":
                out = L.decode_attention_block(
                    cfg, h, w["attn"], {"k": kv["k"][g], "v": kv["v"][g]},
                    index)
            else:
                out, st = ssm.mamba_decode(
                    cfg, h, w["mamba"], {"conv": mamba["conv"][g, mi],
                                         "h": mamba["h"][g, mi]})
                mamba["conv"][g, mi] = st["conv"]
                mamba["h"][g, mi] = st["h"]
                mi += 1
            x = x + out
            h = L.apply_norm(cfg, x, w["ffn_norm"])
            if ffn == "moe":
                out, _ = moe_lib.moe_block(cfg, h, w["moe"])
            else:
                out = L.mlp_block(cfg, h, w["mlp"])
            x = x + out
    x = L.apply_norm(cfg, x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.vocab_size), state
