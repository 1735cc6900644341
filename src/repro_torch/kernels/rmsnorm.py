"""Fused RMSNorm: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/rmsnorm.py`` (``rmsnorm``, body
``_rmsnorm_kernel``): ``x * rsqrt(mean(x²) + eps) * w`` over the last
axis, reducing in f32, stored in x's dtype.  The kernel is
``csrc/rmsnorm.cu``; the plain version is ``ref.rmsnorm_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["rmsnorm", "rmsnorm_plain"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), weight (d,) -> same shape/dtype as x.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    x and weight contiguous, one dtype (float32 or bfloat16), one device.
    """
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    dev = cuda.require_cuda("rmsnorm", x, weight)
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does not "
                         f"match the last axis of x {tuple(x.shape)}")
    if weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm: weight dtype {weight.dtype} != x dtype "
                        f"{x.dtype}")
    code = cuda.dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = cuda.library()
    cuda.check(lib.repro_rmsnorm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, float(eps),
        code, dev.index, cuda.stream(dev)), "rmsnorm")
    LAUNCHES.rmsnorm += 1
    return out
