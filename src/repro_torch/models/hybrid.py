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
checkpoints already does.  ``forward`` and ``loss_fn`` reach the
parameters and the compute through ``transformer.Whole``'s hooks
(``mamba`` among them), so one forward serves one device and a mesh
(``models.partition``, whose per-slot gathers run inside each slot's
checkpoint).

Decode (``init_state``, ``forward_decode``) is the reference's: one
token through every group, the attention slot over its KV cache and
each Mamba slot one recurrence step (``ssm.mamba_decode``), the state
updated in place and returned.  ``state_specs`` places the state on a
mesh; ``forward_decode`` takes the same hooks (``decode_attention``,
``mamba_decode`` among them), so a mesh decodes on its blocks.
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
from repro_torch.models.sharding import remat_contexts


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
                          fan_in_dims=(1,), axes=("model", "fsdp")),
        "final_norm": {"scale": ParamDef((cfg.d_model,), init="ones")},
        "slots": tuple(slots),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.padded_vocab, cfg.d_model),
                                   fan_in_dims=(1,), axes=("model", "fsdp"))
    return defs


def _slot_body(cfg: ModelConfig, mixer: str, ffn: str, x: torch.Tensor,
               w: Dict[str, Any], part: T.Whole = T.WHOLE, slot: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    w = part.layer(w, slot)
    h = L.apply_norm(cfg, x, w["mixer_norm"])
    if mixer == "attn":
        # rope is off for jamba (use_rope=False): no cos/sin
        mix = part.attention(cfg, h, w["attn"], None, None)
    else:
        mix = part.mamba(cfg, h, w["mamba"])
    # fused residual-add + norm via the kernel registry
    x, h = L.residual_apply_norm(cfg, mix, x, w["ffn_norm"])
    out, aux = part.ffn(cfg, h, w)
    if aux is None:      # the dense SwiGLU
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            part: T.Whole = T.WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (b, l) -> logits (b, l, v), summed aux.
    ``part``: the hooks of ``transformer.Whole`` (its ``moe_means`` the
    MoE aux loss's), or a rank's block of the compute on a mesh
    (``models.partition``; its logits are then the rank's vocabulary
    block)."""
    kinds = _slot_kinds(cfg)
    groups = cfg.n_layers // (cfg.attn_period or 1)
    x = part.embed(cfg, tokens, params["embed"]).to(torch_dtype(cfg.dtype))
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # per slot: its weights of every group, as views of the stacked leaves
    per_slot = [T.layer_weights(slot, groups) for slot in params["slots"]]
    for g in range(groups):
        for j, ((mixer, ffn), ws) in enumerate(zip(kinds, per_slot)):
            if cfg.remat == "full":
                # a mesh's per-slot gathers run inside the checkpoint, so
                # the recompute gathers again
                x, aux = checkpoint(_slot_body, cfg, mixer, ffn, x, ws[g],
                                    part, j, use_reentrant=False,
                                    context_fn=remat_contexts)
            else:
                x, aux = _slot_body(cfg, mixer, ffn, x, ws[g], part, j)
            aux_total = aux_total + aux
    x = L.apply_norm(cfg, x, part.final_norm(params["final_norm"]))
    name = "embed" if cfg.tie_embeddings else "unembed"
    return part.unembed(cfg, x, params[name], name), aux_total


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], part: T.Whole = T.WHOLE
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``nll + aux_loss_weight · aux`` (the weight 0 without MoE), and
    the parts: ``loss`` is the nll."""
    logits, aux = forward(cfg, params, batch["tokens"], part)
    nll = part.cross_entropy(logits, batch["labels"])
    w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return nll + w * aux, {"loss": nll, "aux_loss": aux}


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


def state_specs(cfg: ModelConfig, batch: int, max_seq: int, rules):
    """The decode state's ``PartitionSpec``s (``rules=None``:
    replicated)."""
    from repro_torch.models.sharding import PartitionSpec as P
    period = cfg.attn_period or 1
    groups = cfg.n_layers // period
    di = cfg.expand * cfg.d_model
    hd = cfg.resolved_head_dim

    def spec(axes, shape):
        return P() if rules is None else rules.spec(axes, shape)

    kv_shape = (groups, batch, max_seq, cfg.n_kv_heads, hd)
    kv = spec((None, "batch", "cache_seq", None, None), kv_shape)
    return {
        "kv": {"k": kv, "v": kv},
        "mamba": {
            "conv": spec((None, None, "batch", None, "model"),
                         (groups, period - 1, batch, cfg.d_conv - 1, di)),
            "h": spec((None, None, "batch", "model", None),
                      (groups, period - 1, batch, di, cfg.d_state)),
        },
    }


def forward_decode(cfg: ModelConfig, params: Dict[str, Any],
                   token: torch.Tensor, state: Dict[str, Any], index: int,
                   part: T.Whole = T.WHOLE
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (b, 1) at position ``index`` (a host int).
    Returns (logits (b, 1, v), state), the state updated in place.
    ``part``: a rank's block of the compute on a mesh
    (``models.partition``): the state is then the rank's block of
    ``state_specs``, the logits the rank's vocabulary block
    (``part.greedy`` takes the token)."""
    kinds = _slot_kinds(cfg)
    groups = cfg.n_layers // (cfg.attn_period or 1)
    x = part.embed(cfg, token, params["embed"]).to(torch_dtype(cfg.dtype))
    per_slot = [T.layer_weights(slot, groups) for slot in params["slots"]]
    kv, mamba = state["kv"], state["mamba"]
    for g in range(groups):
        mi = 0  # mamba slot counter within the group
        for j, ((mixer, _), ws) in enumerate(zip(kinds, per_slot)):
            w = part.layer(ws[g], j)
            h = L.apply_norm(cfg, x, w["mixer_norm"])
            if mixer == "attn":
                out = part.decode_attention(
                    cfg, h, w["attn"], {"k": kv["k"][g], "v": kv["v"][g]},
                    index)
            else:
                out, st = part.mamba_decode(
                    cfg, h, w["mamba"], {"conv": mamba["conv"][g, mi],
                                         "h": mamba["h"][g, mi]})
                mamba["conv"][g, mi] = st["conv"]
                mamba["h"][g, mi] = st["h"]
                mi += 1
            x = x + out
            h = L.apply_norm(cfg, x, w["ffn_norm"])
            x = x + part.ffn(cfg, h, w)[0]
    x = L.apply_norm(cfg, x, part.final_norm(params["final_norm"]))
    name = "embed" if cfg.tie_embeddings else "unembed"
    return part.unembed_row(cfg, x, params[name], name), state
