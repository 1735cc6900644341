"""Enum-dispatched kernel registry: ONE call site per worker-step hot op.

Counterpart of ``repro/kernels/registry.py``.  Each public function is
the single entry point the model calls for its op — ``attention``,
``rmsnorm``, ``residual_rmsnorm`` — dispatched over ``KernelType`` by the
validated ``model.kernels`` string (``repro_torch.kernels.interface``):

    variant   what runs
    --------  -----------------------------------------------------------
    KERNEL    the Hopper kernel, inside a ``torch.autograd.Function``
              whose backward is autograd through the matching
              ``kernels/ref.py`` oracle (as the reference pairs each
              Pallas forward with a ``jax.custom_vjp`` backward)
    PLAIN     the ``kernels/ref.py`` formulation with native autograd

The backward through the oracle is the only place a plain version runs
on the card's main path.  There is no attention fallback: the kernel
masks ragged tiles, so every sequence length takes it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import residual_rmsnorm as _rrn
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels.interface import AUTO, KernelType, resolve


def resolved(op: str, kernels: str, x: torch.Tensor) -> KernelType:
    """The variant a spec string picks for ``op`` on ``x``'s device."""
    return resolve(kernels, op, cuda=x.is_cuda)


def _vjp_through(fn: Callable, inputs: Sequence[torch.Tensor],
                 douts: Sequence[torch.Tensor],
                 needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``fn(*inputs)`` for the inputs that need one,
    recomputed through ``fn`` (the plain oracle)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(outs, wrt, douts) if wrt else ())
    return tuple(next(grads) if n else None for n in needs)


# ================================================================ attention
class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = _vjp_through(
            lambda q_, k_, v_: _ref.flash_attention_ref(
                q_, k_, v_, causal=ctx.causal, window=ctx.window),
            (q, k, v), (dout,), ctx.needs_input_grad[:3])
        return grads + (None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kernels: str = AUTO) -> torch.Tensor:
    """q (b, lq, hq, d); k/v (b, lk, hkv, d); GQA; positions END-aligned
    (query i at absolute position lk - lq + i)."""
    if resolved("attention", kernels, q) is KernelType.KERNEL:
        return _Attention.apply(q, k, v, causal, window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)


# ================================================================= rmsnorm
class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rn.rmsnorm(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        grads = _vjp_through(
            lambda x_, w_: _ref.rmsnorm_ref(x_, w_, ctx.eps),
            (x, weight), (dout,), ctx.needs_input_grad[:2])
        return grads + (None,)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            kernels: str = AUTO) -> torch.Tensor:
    """x (..., d), weight (d,) -> same shape/dtype as x; f32 reduction."""
    if resolved("rmsnorm", kernels, x) is KernelType.KERNEL:
        return _RMSNorm.apply(x, weight, eps)
    return _ref.rmsnorm_ref(x, weight, eps)


# ======================================================== residual+rmsnorm
class _ResidualRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, weight, eps: float):
        ctx.save_for_backward(x, res, weight)
        ctx.eps = eps
        return _rrn.residual_rmsnorm(x, res, weight, eps=eps)

    @staticmethod
    def backward(ctx, ds, dout):
        x, res, weight = ctx.saved_tensors
        grads = _vjp_through(
            lambda x_, r_, w_: _ref.residual_rmsnorm_ref(x_, r_, w_, ctx.eps),
            (x, res, weight), (ds, dout), ctx.needs_input_grad[:3])
        return grads + (None,)


def residual_rmsnorm(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                     *, eps: float = 1e-6, kernels: str = AUTO
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pre-norm block glue: ``s = x + res`` (f32) ->
    ``(s, rms_norm(s) * weight)``, both in x's dtype."""
    if resolved("residual_rmsnorm", kernels, x) is KernelType.KERNEL:
        return _ResidualRMSNorm.apply(x, res, weight, eps)
    return _ref.residual_rmsnorm_ref(x, res, weight, eps)
