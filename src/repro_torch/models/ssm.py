"""State-space families: the Mamba (S6) block, training and decode.

Counterpart of the Mamba half of ``repro/models/ssm.py`` (``mamba_defs``,
``_causal_conv``, ``mamba_block``, ``mamba_decode``): the same parameter
names and shapes, the same order of casts and products.  The selective
scan goes through ``repro_torch.kernels.registry.ssm_scan`` by
``cfg.kernels``: the Hopper kernel on the card, the chunked associative
scan on the CPU.  ``mamba_decode`` is one recurrence step in plain
PyTorch, as the reference's is plain XLA: it runs no kernel.

mLSTM and sLSTM (xLSTM) come with a later slice (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import registry as K
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


def mamba_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.expand * d
    ds = cfg.d_state
    dt_rank = max(1, d // 16)
    return {
        "w_in": ParamDef((n, d, 2 * di), fan_in_dims=(1,)),
        "conv_w": ParamDef((n, cfg.d_conv, di), scale=1.0, fan_in_dims=(1,)),
        "conv_b": ParamDef((n, di), init="zeros"),
        "w_bcdt": ParamDef((n, di, 2 * ds + dt_rank), fan_in_dims=(1,)),
        "dt_proj": ParamDef((n, dt_rank, di), fan_in_dims=(1,)),
        "dt_bias": ParamDef((n, di), init="zeros"),
        "a_log": ParamDef((n, di, ds), init="ones"),
        "d_skip": ParamDef((n, di), init="ones"),
        "w_out": ParamDef((n, di, d), fan_in_dims=(1,)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (b, l, di), w (k, di). Returns
    (y, new_tail)."""
    k = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    l = x.shape[1]
    y = xp[:, 0:l] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + l] * w[i]
    new_tail = xp[:, -(k - 1):] if k > 1 else pad
    return (y + b).to(x.dtype), new_tail


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,de->ble") as one matmul."""
    b, l, d = x.shape
    return (x.reshape(b * l, d) @ w).view(b, l, w.shape[-1])


def mamba_block(cfg: ModelConfig, x: torch.Tensor,
                w: Dict[str, Any]) -> torch.Tensor:
    b, l, d = x.shape
    di = cfg.expand * d
    ds = cfg.d_state
    xin, z = _matmul(x, w["w_in"]).split(di, dim=-1)
    xc, _ = _causal_conv(xin, w["conv_w"], w["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    bcdt = _matmul(xc, w["w_bcdt"]).float()
    # the kernel reads B and C contiguous; they are (b, l, ds), small
    bmat = bcdt[..., :ds].contiguous()
    cmat = bcdt[..., ds:2 * ds].contiguous()
    dt = bcdt[..., 2 * ds:]
    delta = F.softplus(_matmul(dt, w["dt_proj"].float())
                       + w["dt_bias"].float())
    a = -torch.exp(w["a_log"].float())
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    chunk = cfg.mamba_chunk if cfg.mamba_chunk > 0 else l
    xcf = xc.float()
    y, _ = K.ssm_scan(xcf, delta, a, bmat, cmat, h0, chunk=chunk,
                      kernels=cfg.kernels)
    y = y + xcf * w["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _matmul(y, w["w_out"])


def mamba_decode(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (b, 1, d); state conv (b, k-1, di), h (b, di, ds) f32.
    Returns (out (b, 1, d), new state)."""
    ds = cfg.d_state
    di = cfg.expand * cfg.d_model
    xin, z = _matmul(x, w["w_in"]).split(di, dim=-1)
    xc, new_tail = _causal_conv(xin, w["conv_w"], w["conv_b"],
                                tail=state["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    bcdt = _matmul(xc, w["w_bcdt"]).float()
    bmat, cmat, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., 2 * ds:]
    delta = F.softplus(_matmul(dt, w["dt_proj"].float())
                       + w["dt_bias"].float())                 # (b, 1, di)
    a = -torch.exp(w["a_log"].float())
    abar = torch.exp(delta[..., None] * a[None, None])[:, 0]   # (b, di, ds)
    xcf = xc.float()
    bbar = (delta[..., None] * bmat[:, :, None, :] * xcf[..., None])[:, 0]
    h = abar * state["h"] + bbar
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])
    y = y + xcf[:, 0] * w["d_skip"].float()
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _matmul(y, w["w_out"]), {"conv": new_tail, "h": h}
