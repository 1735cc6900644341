"""Selective scan (Mamba S6): the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/ssm_scan.py`` (``ssm_scan``, body
``_ssm_scan_kernel``): ``h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t``,
``y_t = C_t . h_t``, the f32 state carried along the whole sequence.
The kernel is ``csrc/ssm_scan.cu``; the plain version is
``ref.ssm_scan_ref``.

The kernel walks time inside each lane (d_state split across the lanes
of a warp, two states a lane), so the reference's ``chunk`` (its grid's
sequential axis) changes nothing in the result; it is accepted so the
two signatures match.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import ssm_scan_ref as ssm_scan_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["ssm_scan", "ssm_scan_plain", "STATE_DIMS"]

#: state widths the kernel is instantiated for (the reference's tests: 8;
#: Jamba: 16)
STATE_DIMS = (8, 16)


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """u/delta (b, l, di); a (di, ds); bmat/cmat (b, l, ds); h0
    (b, di, ds) -> (y (b, l, di) in u's dtype, h_last (b, di, ds) f32).

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    u and delta contiguous, float32 or bfloat16; ds in ``STATE_DIMS``;
    a, B, C and h0 are read in f32 (cast here if they are not);
    anything else raises.
    """
    del chunk   # the kernel's time loop has no chunks
    if u.device.type == "cpu":
        return ssm_scan_plain(u, delta, a, bmat, cmat, h0)
    if u.ndim != 3 or delta.shape != u.shape:
        raise ValueError(f"ssm_scan: u {tuple(u.shape)} and delta "
                         f"{tuple(delta.shape)} must both be (b, l, di)")
    b, l, di = u.shape
    if a.ndim != 2 or a.shape[0] != di:
        raise ValueError(f"ssm_scan: a {tuple(a.shape)} is not (di={di}, ds)")
    ds = a.shape[1]
    if ds not in STATE_DIMS:
        raise ValueError(f"ssm_scan: d_state {ds} has no kernel "
                         f"(instantiated for {STATE_DIMS})")
    for name, t, shape in (("bmat", bmat, (b, l, ds)),
                           ("cmat", cmat, (b, l, ds)),
                           ("h0", h0, (b, di, ds))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} {tuple(t.shape)} is not "
                             f"{shape}")
    a, bmat, cmat, h0 = (t.float().contiguous() for t in (a, bmat, cmat, h0))
    dev = cuda.require_cuda("ssm_scan", u, delta, a, bmat, cmat, h0)
    u_code = cuda.dtype_code(u, "ssm_scan")
    d_code = cuda.dtype_code(delta, "ssm_scan")
    if b > 65535:
        raise ValueError(f"ssm_scan: batch {b} > 65535 (grid y)")
    y = torch.empty_like(u)
    h_last = torch.empty((b, di, ds), dtype=torch.float32, device=dev)
    if b == 0 or di == 0:
        return y, h_last
    lib = cuda.library()
    cuda.check(lib.repro_ssm_scan(
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        b, l, di, ds, u_code, d_code, dev.index, cuda.stream(dev)),
        "ssm_scan")
    LAUNCHES.ssm_scan += 1
    return y, h_last
