"""Mixture-of-Experts FFN (GShard-style capacity dispatch), plain PyTorch.

Counterpart of ``repro/models/moe.py``: top-k routing with a capacity
per (row, chunk) group, the sequence processed in chunks of
``cfg.moe_chunk`` so the dispatch and combine one-hot tensors stay
small, DeepSeek-style shared experts beside the routed ones, and the
Switch/GShard load-balancing auxiliary loss.  The reference has no
Pallas kernel here, so neither does the port.  On one device there is
no expert parallelism: the reference's sharding annotations have no
counterpart.

The load-balancing loss's two means (``frac``, ``meanp``) run over the
batch and the chunk; under GSPMD that batch is global.  ``moe_block``
takes a hook ``means(frac, meanp)`` that a mesh's step gives to average
them over the batch's ranks before the product; ``local_means``, the
default, keeps the means over the rows the call sees.

``lax.top_k`` ranks equal probabilities by the lower expert index
first; a stable descending sort does the same, so the capacity cut-off
keeps the same tokens.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_expert or cfg.d_ff
    e = m.n_experts
    defs: Dict[str, ParamDef] = {
        "router": ParamDef((n, d, e), fan_in_dims=(1,),
                           axes=(None, "fsdp", None)),
        "w_gate": ParamDef((n, e, d, f), fan_in_dims=(2,),
                           axes=(None, "model", "fsdp", None)),
        "w_up": ParamDef((n, e, d, f), fan_in_dims=(2,),
                         axes=(None, "model", "fsdp", None)),
        "w_down": ParamDef((n, e, f, d), fan_in_dims=(2,),
                           axes=(None, "model", None, "fsdp")),
    }
    if m.n_shared:
        fs = f * m.n_shared
        defs["shared_gate"] = ParamDef((n, d, fs), fan_in_dims=(1,),
                                       axes=(None, "fsdp", "model"))
        defs["shared_up"] = ParamDef((n, d, fs), fan_in_dims=(1,),
                                     axes=(None, "fsdp", "model"))
        defs["shared_down"] = ParamDef((n, fs, d), fan_in_dims=(1,),
                                       axes=(None, "model", "fsdp"))
    return defs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def local_means(frac: torch.Tensor, meanp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-device hook of ``moe_block``: the aux loss's means over
    the rows this call sees, unchanged."""
    return frac, meanp


def _route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor,
           means: Callable = local_means,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> combine (b, s, e, c) f32, dispatch (same, model
    dtype), aux load-balance loss (scalar)."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    s = x.shape[1]
    capacity = max(k, int(m.capacity_factor * s * k / e))

    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                       # (b, s, e)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)          # renormalize

    # Load-balance aux loss (Switch/GShard): e * sum_e fraction_e * meanprob_e
    frac = _one_hot(expert_idx[..., 0], e).mean(dim=(0, 1))
    meanp = probs.mean(dim=(0, 1))
    frac, meanp = means(frac, meanp)
    aux = e * torch.sum(frac * meanp)

    # Position-in-expert per (row, chunk) group, k slots in priority order.
    combine = torch.zeros((x.shape[0], s, e, capacity), dtype=torch.float32,
                          device=x.device)
    base = torch.zeros((x.shape[0], 1, e), dtype=torch.float32,
                       device=x.device)                         # used slots
    for j in range(k):
        onehot_e = _one_hot(expert_idx[..., j], e)              # (b, s, e)
        pos = torch.cumsum(onehot_e, dim=1) - onehot_e + base   # (b, s, e)
        within = (pos < capacity) & (onehot_e > 0)
        pos_oh = _one_hot(pos.long(), capacity)                 # (b,s,e,c)
        combine = combine + (gate_vals[..., j][..., None, None]
                             * within[..., None] * pos_oh
                             * onehot_e[..., None])
        base = base + onehot_e.sum(dim=1, keepdim=True)
    dispatch = (combine > 0).to(x.dtype)
    return combine, dispatch, aux


def _expert_ffn(cfg: ModelConfig, xe: torch.Tensor,
                w: Dict[str, Any]) -> torch.Tensor:
    """xe (e, b, c, d) -> (e, b, c, d)."""
    gate = torch.einsum("ebcd,edf->ebcf", xe, w["w_gate"])
    up = torch.einsum("ebcd,edf->ebcf", xe, w["w_up"])
    h = F.silu(gate.float()).to(xe.dtype) * up
    return torch.einsum("ebcf,efd->ebcd", h, w["w_down"])


def _moe_chunk(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
               means: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route + dispatch + compute + combine for one (b, chunk, d) slab."""
    combine, dispatch, aux = _route(cfg, x, w["router"], means)
    xe = torch.einsum("bsd,bsec->ebcd", x, dispatch)
    ye = _expert_ffn(cfg, xe, w)
    y = torch.einsum("ebcd,bsec->bsd", ye, combine.to(x.dtype))
    return y, aux


def moe_block(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
              means: Callable = local_means,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, l, d) -> (y (b, l, d), aux scalar), over chunks of the
    sequence; ``means`` the aux loss's hook (module docstring), applied
    per chunk."""
    m = cfg.moe
    b, l, d = x.shape
    chunk = min(cfg.moe_chunk, l) if cfg.moe_chunk > 0 else l
    out_shared = torch.zeros_like(x)
    if m.n_shared:
        x2 = x.reshape(b * l, d)
        gate = x2 @ w["shared_gate"]
        up = x2 @ w["shared_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
        out_shared = (h @ w["shared_down"]).view(b, l, d)

    if chunk >= l or l % chunk != 0:   # decode / cost-mode: single dispatch
        y, aux = _moe_chunk(cfg, x, w, means)
        return y + out_shared, aux

    ys, auxs = [], []
    for c0 in range(0, l, chunk):
        y, aux = _moe_chunk(cfg, x[:, c0:c0 + chunk], w, means)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys, dim=1) + out_shared, torch.stack(auxs).mean()
