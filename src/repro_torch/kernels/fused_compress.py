"""Fused wire compression with error feedback: the Hopper kernels and
their plain versions.

Counterpart of ``repro/kernels/fused_compress.py``.  Over a packed
``(rows, 512)`` gradient region ``g`` (rows a multiple of 8) and its f32
error-feedback state ``err``, one scale or threshold per ``(8, 512)``
tile:

* ``fused_int8_ef`` (body ``_int8_ef_kernel``): symmetric int8
  quantise, dequantise, and carry the remainder;
* ``fused_topk_ef`` (body ``_topk_ef_kernel``): keep the tile's largest
  magnitudes, found by 24 bisection steps on the count curve, and carry
  the rest.

Both return ``(decoded g in g's dtype, new f32 error)`` as NEW tensors.
The kernels are in ``csrc/fused_compress.cu``; the plain versions are
``ref.fused_int8_ef_ref`` / ``ref.fused_topk_ef_ref`` and agree with
them bit for bit.  A ``(0, 512)`` region passes through unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import fused_int8_ef_ref as fused_int8_ef_plain
from repro_torch.kernels.ref import fused_topk_ef_ref as fused_topk_ef_plain
from repro_torch.perfcount import LAUNCHES
from repro_torch.wireformat import WIRE_LANES, WIRE_ROWS

__all__ = ["fused_int8_ef", "fused_int8_ef_plain", "fused_topk_ef",
           "fused_topk_ef_plain", "topk_target"]

_TILE = WIRE_ROWS * WIRE_LANES


def _check_wire(buf: torch.Tensor, err: torch.Tensor) -> None:
    if buf.dim() != 2 or buf.shape[1] != WIRE_LANES \
            or buf.shape[0] % WIRE_ROWS:
        raise ValueError(
            f"expected an 8-row-aligned (rows, {WIRE_LANES}) wire buffer, "
            f"got {tuple(buf.shape)}")
    if err.shape != buf.shape:
        raise ValueError(f"error state {tuple(err.shape)} != buffer "
                         f"{tuple(buf.shape)}")


def topk_target(fraction: float) -> float:
    """Entries a tile keeps at least: ``float32(fraction * 4096)``,
    rounded as the reference rounds it."""
    return float(np.float32(fraction * _TILE))


def _launch(name: str, g: torch.Tensor, err: torch.Tensor, *extra):
    dev = cuda.require_cuda(name, g, err)
    if err.dtype != torch.float32:
        raise TypeError(f"{name}: the error state must be float32, got "
                        f"{err.dtype}")
    code = cuda.dtype_code(g, name)
    if g.data_ptr() % 16 or err.data_ptr() % 16:
        raise ValueError(f"{name}: buffers must be 16-byte aligned")
    dq = torch.empty_like(g)
    er = torch.empty_like(err)
    fn = getattr(cuda.library(), f"repro_{name}")
    cuda.check(fn(g.data_ptr(), err.data_ptr(), dq.data_ptr(),
                  er.data_ptr(), g.numel() // _TILE, *extra, code,
                  dev.index, cuda.stream(dev)), name)
    return dq, er


def fused_int8_ef(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 quantise + dequantise + error feedback, one pass.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_wire(g, err)
    if g.shape[0] == 0:
        return g, err
    if g.device.type == "cpu":
        return fused_int8_ef_plain(g, err)
    out = _launch("fused_int8_ef", g, err)
    LAUNCHES.fused_int8_ef += 1
    return out


def fused_topk_ef(g: torch.Tensor, err: torch.Tensor, *,
                  fraction: float = 0.05
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude top-k per tile (at least ``fraction`` of it, ties kept)
    + error feedback.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction in (0, 1]")
    _check_wire(g, err)
    if g.shape[0] == 0:
        return g, err
    if g.device.type == "cpu":
        return fused_topk_ef_plain(g, err, fraction=fraction)
    out = _launch("fused_topk_ef", g, err, topk_target(fraction))
    LAUNCHES.fused_topk_ef += 1
    return out
