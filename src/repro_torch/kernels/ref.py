"""Plain PyTorch oracles for every ported kernel (the correctness contract).

Each function is the definition its kernel must reproduce, written as in
the reference package's ``kernels/ref.py``.  They run on any device: the
CPU path of every kernel wrapper, the ``xla`` registry variant, the
backward of every kernel op (autograd through these), and the
comparison ``chip_smoke.py`` makes on the card.

All of them compute in f32 and store in the input dtypes.  They are
eager PyTorch, one operation at a time, so no multiply-add is ever
contracted: ``fused_update_ref`` rounds exactly where its formula says.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # the reference's mask value (finite: fully-masked rows stay defined)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        head_dim: Optional[int] = None) -> torch.Tensor:
    """q (b, lq, hq, d); k/v (b, lk, hkv, d); GQA broadcast; f32 softmax.

    Positions are aligned at the END: query i sits at absolute position
    lk - lq + i.  Scores are scaled by 1/sqrt(``head_dim``), d unless
    given (the true head dim of zero-padded inputs).
    """
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) \
        / math.sqrt(head_dim or d)
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v.float())
    return out.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def residual_rmsnorm_ref(x: torch.Tensor, res: torch.Tensor,
                         weight: torch.Tensor, eps: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + res; (s, rms_norm(s) * weight)`` with the sum and the
    reduction in f32, both outputs cast back to x's dtype."""
    sf = x.float() + res.float()
    var = torch.mean(sf * sf, dim=-1, keepdim=True)
    normed = sf * torch.rsqrt(var + eps) * weight.float()
    return sf.to(x.dtype), normed.to(x.dtype)


def ssm_scan_ref(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, h0: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan (Mamba S6) as the literal sequential recurrence

        h_t = exp(delta_t * A) * h_{t-1} + (delta_t * B_t) * u_t
        y_t = C_t . h_t

    u/delta (b, l, di); a (di, ds); bmat/cmat (b, l, ds); h0 (b, di, ds).
    Returns (y (b, l, di) in u's dtype, h_last (b, di, ds) f32).  All
    math in f32, products in the reference's order.

    The inputs are split per timestep with ``unbind`` (as ``lax.scan``
    slices its xs): its backward stacks the per-step gradients once,
    where indexing ``x[:, t]`` would scatter each into a full-size zero
    tensor."""
    af = a.float()
    h = h0.float()
    ys = []
    for ut, dt, bt, ct in zip(u.float().unbind(1), delta.float().unbind(1),
                              bmat.float().unbind(1), cmat.float().unbind(1)):
        abar = torch.exp(dt[..., None] * af[None])       # (b, di, ds)
        bbar = dt[..., None] * bt[:, None, :] * ut[..., None]
        h = abar * h + bbar
        ys.append(torch.einsum("bds,bs->bd", h, ct))
    if not ys:
        return u.new_empty(u.shape), h
    return torch.stack(ys, dim=1).to(u.dtype), h


def fused_update_ref(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *,
                     lr: float, beta: float, scale: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One momentum-SGD step: ``m' = beta*m + scale*g; p' = p - lr*m'``
    in f32 (every product and sum rounded), cast back to the input
    dtypes."""
    mf = beta * m.float() + scale * g.float()
    pf = p.float() - lr * mf
    return pf.to(p.dtype), mf.to(m.dtype)


def fused_update_batched_ref(p: torch.Tensor, m: torch.Tensor, gs, *,
                             lr: float, beta: float, scales=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K gradients folded through momentum in enqueue order, each step
    cast back to the storage dtype exactly as a standalone
    ``fused_update`` launch stores it: K sequential ``fused_update_ref``
    calls.  ``gs`` is a stacked ``(K,) + p.shape`` tensor or a sequence
    of K tensors of ``p``'s shape."""
    k = len(gs)
    if scales is None:
        scales = (1.0,) * k
    for j in range(k):
        p, m = fused_update_ref(p, m, gs[j], lr=lr, beta=beta,
                                scale=scales[j])
    return p, m


def _per_tile(buf: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """(R, 512) wire buffer -> (R // rows, rows * 512) tile-major view."""
    r, lanes = buf.shape
    return buf.reshape(r // rows, rows * lanes)


def fused_int8_ef_ref(g: torch.Tensor, e: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(8, 512)-tile symmetric int8 quantise/dequantise with error
    feedback: ``gf = g + e``; ``scale = max(max|gf|, 1e-12) / 127``;
    ``q = clip(round(gf / scale), -127, 127)`` (half to even);
    returns ``(q * scale`` in g's dtype, ``gf - q * scale`` in f32)."""
    if g.shape[0] == 0:
        return g, e
    gf = _per_tile(g.float() + e)
    amax = gf.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not the IEEE quotient the
    # reference (and the kernel) computes.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(gf / scale), -127.0, 127.0)
    dq = q * scale
    return dq.reshape(g.shape).to(g.dtype), (gf - dq).reshape(g.shape)


def fused_topk_ef_ref(g: torch.Tensor, e: torch.Tensor, *,
                      fraction: float = 0.05, iters: int = 24
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile magnitude top-k with error feedback.  The threshold is
    bisected ``iters`` times on the count curve ``|{|x| >= t}|`` against
    ``target = float32(fraction * 4096)``; every entry with
    ``|x| >= lo`` is kept (ties too), the rest is carried in the error."""
    if g.shape[0] == 0:
        return g, e
    gf = _per_tile(g.float() + e)
    mag = gf.abs()
    target = torch.tensor(fraction * mag.shape[1], dtype=torch.float32)
    lo = torch.zeros((mag.shape[0], 1), dtype=torch.float32,
                     device=g.device)
    hi = mag.amax(dim=1, keepdim=True) + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        keep = (mag >= mid).float().sum(dim=1, keepdim=True)
        take = keep >= target.to(g.device)
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    kept = torch.where(mag >= lo, gf, torch.zeros((), device=g.device))
    return kept.reshape(g.shape).to(g.dtype), (gf - kept).reshape(g.shape)
