"""Fused DSSP delayed-gradient apply: the Hopper kernels and their plain versions.

Counterpart of ``repro/kernels/fused_update.py``:

* ``fused_update`` (body ``_fused_update_kernel``): one momentum-SGD step
  over a packed shard region, ``m' = beta*m + scale*g; p' = p - lr*m'``
  in f32, stored in the input dtype;
* ``fused_update_batched`` (body ``_fused_update_batched_kernel``): K
  gradients, each with its own scale, folded through that step in
  enqueue order in ONE launch — the coalesced server apply.  After each
  step the carried p and m are rounded to the storage dtype, so the
  result is bit for bit K sequential ``fused_update`` calls.

The kernels are in ``csrc/fused_update.cu``; the plain versions are
``ref.fused_update_ref`` / ``ref.fused_update_batched_ref`` and agree
with them bit for bit (the kernels round every product and sum, as eager
PyTorch does).

The kernel writes NEW output tensors, as the Pallas kernel's
``out_shape`` does: the server hands out references to its buffers as
pulled snapshots, so an apply must never update them in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import \
    fused_update_batched_ref as fused_update_batched_plain
from repro_torch.kernels.ref import fused_update_ref as fused_update_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["fused_update", "fused_update_plain", "fused_update_batched",
           "fused_update_batched_plain", "MAX_BATCH"]

#: Contributions one batched launch folds (``kMaxBatch`` in the source);
#: a longer window folds in consecutive launches of at most this many,
#: which is the same sequential fold, bit for bit.
MAX_BATCH = 32


def fused_update(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *,
                 lr: float, beta: float = 0.9, scale: float = 1.0,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused momentum step; returns new ``(p', m')``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    p, m and g must be contiguous, of one shape and one dtype (float32 or
    bfloat16), on one device — anything else raises.
    """
    if p.device.type == "cpu":
        return fused_update_plain(p, m, g, lr=lr, beta=beta, scale=scale)
    dev = cuda.require_cuda("fused_update", p, m, g)
    if not (p.shape == m.shape == g.shape):
        raise ValueError(f"fused_update: shapes differ: p {tuple(p.shape)}, "
                         f"m {tuple(m.shape)}, g {tuple(g.shape)}")
    if not (p.dtype == m.dtype == g.dtype):
        raise TypeError(f"fused_update: dtypes differ: {p.dtype}, "
                        f"{m.dtype}, {g.dtype}")
    code = cuda.dtype_code(p, "fused_update")
    po = torch.empty_like(p)
    mo = torch.empty_like(m)
    if p.numel() == 0:
        return po, mo
    lib = cuda.library()
    cuda.check(lib.repro_fused_update(
        p.data_ptr(), m.data_ptr(), g.data_ptr(), po.data_ptr(),
        mo.data_ptr(), p.numel(), float(lr), float(beta), float(scale),
        code, dev.index, cuda.stream(dev)), "fused_update")
    LAUNCHES.fused_update += 1
    return po, mo


def fused_update_batched(p: torch.Tensor, m: torch.Tensor,
                         gs: Union[torch.Tensor, Sequence[torch.Tensor]], *,
                         lr: float, beta: float = 0.9,
                         scales: Optional[Sequence[float]] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold K gradients into ``(p, m)`` in order; returns new ``(p', m')``.

    ``gs`` is a stacked ``(K,) + p.shape`` tensor or a sequence of K
    tensors of ``p``'s shape (the server passes its queued regions as
    they are, without stacking them); ``scales`` holds one step scale
    per gradient (default 1.0).  K = 1 is ``fused_update``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel once (for
    K <= ``MAX_BATCH``), and every tensor must then be contiguous, of
    one dtype (float32 or bfloat16) and on one device — anything else
    raises.
    """
    k = len(gs)
    if k == 0:
        raise ValueError("fused_update_batched: no gradients to fold")
    if scales is None:
        scales = (1.0,) * k
    if len(scales) != k:
        raise ValueError(f"{len(scales)} scales for {k} stacked grads")
    for j in range(k):
        if tuple(gs[j].shape) != tuple(p.shape):
            raise ValueError(
                f"stacked grads {tuple(gs[j].shape)} do not match "
                f"parameter shape {tuple(p.shape)}")
    if k == 1:
        # The standalone kernel IS the one-contribution fold.
        return fused_update(p, m, gs[0], lr=lr, beta=beta,
                            scale=float(scales[0]))
    if p.device.type == "cpu":
        return fused_update_batched_plain(p, m, gs, lr=lr, beta=beta,
                                          scales=scales)
    g_list = [gs[j] for j in range(k)]
    dev = cuda.require_cuda("fused_update_batched", p, m, *g_list)
    if not (p.shape == m.shape):
        raise ValueError(f"fused_update_batched: shapes differ: p "
                         f"{tuple(p.shape)}, m {tuple(m.shape)}")
    if any(t.dtype != p.dtype for t in [m] + g_list):
        raise TypeError("fused_update_batched: p, m and every gradient "
                        "must share one dtype")
    code = cuda.dtype_code(p, "fused_update_batched")
    lib = cuda.library()
    for j0 in range(0, k, MAX_BATCH):
        chunk = g_list[j0:j0 + MAX_BATCH]
        po = torch.empty_like(p)
        mo = torch.empty_like(m)
        if p.numel():
            ptrs = (ctypes.c_void_p * len(chunk))(
                *[t.data_ptr() for t in chunk])
            sc = (ctypes.c_float * len(chunk))(
                *[float(s) for s in scales[j0:j0 + MAX_BATCH]])
            cuda.check(lib.repro_fused_update_batched(
                p.data_ptr(), m.data_ptr(), ptrs, sc, len(chunk),
                po.data_ptr(), mo.data_ptr(), p.numel(), float(lr),
                float(beta), code, dev.index, cuda.stream(dev)),
                "fused_update_batched")
            LAUNCHES.fused_update_batched += 1
        p, m = po, mo
    return p, m
