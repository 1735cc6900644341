"""Fused DSSP delayed-gradient apply: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/fused_update.py`` (``fused_update``, body
``_fused_update_kernel``): one momentum-SGD step over a packed shard
region, ``m' = beta*m + scale*g; p' = p - lr*m'`` in f32, stored in the
input dtype.  The kernel is ``csrc/fused_update.cu``; the plain version
is ``ref.fused_update_ref`` and the two agree bit for bit (the kernel
rounds every product and sum, as eager PyTorch does).

The kernel writes NEW output tensors, as the Pallas kernel's
``out_shape`` does: the server hands out references to its buffers as
pulled snapshots, so an apply must never update them in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import fused_update_ref as fused_update_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["fused_update", "fused_update_plain"]


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
