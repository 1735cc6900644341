"""Shared neural building blocks (the dense transformer's).

Counterpart of ``repro/models/layers.py`` on one device: the worker-step
hot ops (attention, RMSNorm, fused residual+RMSNorm) route through
``repro_torch.kernels.registry`` by ``cfg.kernels``; the projections and
the MLP products stay ``torch.matmul``, as the reference leaves them to
XLA.

Conventions:
  activations   (batch, seq, d_model)                 bf16/f32
  q/k/v         (batch, seq, heads, head_dim)
  softmax/norm accumulation always float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import registry as K
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30  # large-but-finite: -inf breaks softmax rows that are fully masked


# ----------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             kernels: str = "auto") -> torch.Tensor:
    """Registry-dispatched RMSNorm (``kernels`` = ``cfg.kernels``)."""
    return K.rmsnorm(x, weight, eps=eps, kernels=kernels)


def apply_norm(cfg: ModelConfig, x: torch.Tensor,
               w: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            "layernorm families come with ROADMAP queue 1, item 10")
    return rms_norm(x, w["scale"], kernels=cfg.kernels)


def residual_apply_norm(cfg: ModelConfig, delta: torch.Tensor,
                        x: torch.Tensor, w: Dict[str, torch.Tensor],
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block glue: ``(x + delta, norm(x + delta))`` through the
    registry's fused residual+RMSNorm op."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            "layernorm families come with ROADMAP queue 1, item 10")
    return K.residual_rmsnorm(delta, x, w["scale"], kernels=cfg.kernels)


# ----------------------------------------------------------------- rotary
def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d); cos/sin (s, d/2)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def causal_window_mask(lq: int, lk: int, *, q_offset: int = 0,
                       window: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """(lq, lk) bool mask: True = attend. Causal plus optional sliding
    window of width ``window`` (inclusive of self)."""
    qpos = torch.arange(lq, device=device)[:, None] + q_offset
    kpos = torch.arange(lk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention with the structured mask
    ``causal_window_mask(lq, lk, q_offset=lk-lq, window=window)``:
    q (b, lq, hq, d); k/v (b, lk, hkv, d) -> (b, lq, hq, d).

    The reference's other paths (decode, the mesh-sharded SP/TP
    formulations) come with the serving and SPMD slices."""
    return K.attention(q, k, v, causal=causal, window=window,
                       kernels=cfg.kernels)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matmul."""
    b, l, d = x.shape
    return (x.reshape(b * l, d) @ w.reshape(d, -1)).view(b, l, *w.shape[1:])


def attention_block(cfg: ModelConfig, x: torch.Tensor,
                    w: Dict[str, torch.Tensor], cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Full self-attention sublayer (training path), causal with
    ``cfg.sliding_window``."""
    b, l, _ = x.shape
    q = _project(x, w["wq"])
    k = _project(x, w["wk"])
    v = _project(x, w["wv"])
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], kernels=cfg.kernels)
        k = rms_norm(k, w["k_norm"], kernels=cfg.kernels)
    if cfg.use_rope:
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    out = attention(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    hq, hd, d = w["wo"].shape
    return (out.reshape(b * l, hq * hd) @ w["wo"].reshape(hq * hd, d)
            ).view(b, l, d)


# ----------------------------------------------------------------- MLP
def mlp_block(cfg: ModelConfig, x: torch.Tensor,
              w: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.act != "silu":
        raise NotImplementedError(
            "GELU MLPs (whisper) come with ROADMAP queue 1, item 10")
    b, l, d = x.shape
    x2 = x.reshape(b * l, d)
    gate = x2 @ w["w_gate"]
    up = x2 @ w["w_up"]
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return (h @ w["w_down"]).view(b, l, d)


# ----------------------------------------------------------------- embeddings
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


class _Bf16Unembed(torch.autograd.Function):
    """bf16 x @ table^T on the tensor cores, accumulated and written in
    f32 (``aten::mm.dtype``).  The backward keeps the f32 products that
    autograd of ``x.float() @ table.float().t()`` computes: the
    cotangent is f32, and the reference rounds nothing there either."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, table.t(), out_dtype=torch.float32)
        return out.view(*x.shape[:-1], table.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g2 = g.reshape(-1, table.shape[0])
        gx = gt = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ table.float()).to(x.dtype).view(x.shape)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            gt = (x2.t() @ g2).t().to(table.dtype)
        return gx, gt


def unembed(x: torch.Tensor, table: torch.Tensor,
            vocab_size: Optional[int] = None) -> torch.Tensor:
    """x (b, l, d) @ table^T (v_padded, d) -> f32 logits (b, l, v_padded).

    Products of the storage dtype are exact in f32 and summed in f32, as
    the reference's ``preferred_element_type=float32``: on CUDA in bf16,
    one tensor-core product that accumulates and writes in f32; elsewhere
    an f32 product.  Padded columns are masked to -1e30."""
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        logits = _Bf16Unembed.apply(x, table)
    else:
        logits = x.float() @ table.float().t()
    v_padded = table.shape[0]
    if vocab_size is not None and vocab_size < v_padded:
        col = torch.arange(v_padded, device=x.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32; labels (b, l) with ignore_id masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    weights = (labels != ignore_id).float()
    return torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)
