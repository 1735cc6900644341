"""Fused residual-add + RMSNorm: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/residual_rmsnorm.py``
(``residual_rmsnorm``, body ``_residual_rmsnorm_kernel``): ``s = x + res``
in f32, returning ``(s, rmsnorm(s) * w)`` in x's dtype.  The kernel is
``csrc/residual_rmsnorm.cu``; the plain version is
``ref.residual_rmsnorm_ref``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import \
    residual_rmsnorm_ref as residual_rmsnorm_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["residual_rmsnorm", "residual_rmsnorm_plain"]


def residual_rmsnorm(x: torch.Tensor, res: torch.Tensor,
                     weight: torch.Tensor, *, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/res (..., d), weight (d,) -> (x + res, rms_norm(x + res) * w).

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    all three contiguous, one dtype (float32 or bfloat16), one device.
    """
    if x.device.type == "cpu":
        return residual_rmsnorm_plain(x, res, weight, eps)
    dev = cuda.require_cuda("residual_rmsnorm", x, res, weight)
    d = x.shape[-1]
    if res.shape != x.shape or tuple(weight.shape) != (d,):
        raise ValueError(
            f"residual_rmsnorm: shapes x {tuple(x.shape)}, res "
            f"{tuple(res.shape)}, weight {tuple(weight.shape)} do not match")
    if not (res.dtype == weight.dtype == x.dtype):
        raise TypeError(f"residual_rmsnorm: dtypes differ: {x.dtype}, "
                        f"{res.dtype}, {weight.dtype}")
    code = cuda.dtype_code(x, "residual_rmsnorm")
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return s, out
    lib = cuda.library()
    cuda.check(lib.repro_residual_rmsnorm(
        x.data_ptr(), res.data_ptr(), weight.data_ptr(), s.data_ptr(),
        out.data_ptr(), rows, d, float(eps), code, dev.index,
        cuda.stream(dev)), "residual_rmsnorm")
    LAUNCHES.residual_rmsnorm += 1
    return s, out
