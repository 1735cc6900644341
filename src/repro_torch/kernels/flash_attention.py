"""Flash attention forward: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``, body ``_flash_kernel``): online-softmax
attention with GQA, causal and sliding-window masks, queries aligned at
the end (query i at position lk - lq + i).  One C entry point
(``csrc/flash_attention.cu``) launches one of two kernels by dtype:
bfloat16 runs on the tensor cores (``csrc/flash_attention_sm90.cu``:
wgmma, K/V by TMA), float32 on the scalar f32 pipes, since its tolerance
needs f32 products.  The plain version is ``ref.flash_attention_ref``.

Unlike the Pallas kernel, the Hopper kernels mask a ragged last tile
themselves, so every sequence length takes a kernel: there is no block
size that must divide the lengths.  This wrapper raises for a call the
kernel cannot take (a view that is not 16-byte aligned, a head dim that
is not a multiple of 8 or is above 128, a failed tensor-map encode or
launch); ``kernel_operands`` makes the inputs of the first two kinds
into ones it takes, which is what the registry's ``attention`` does
before each launch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import \
    flash_attention_ref as flash_attention_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "kernel_operands"]

#: head dims the kernel takes: a multiple of 8 up to this
MAX_HEAD_DIM = 128


def _operand(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    if t.shape[-1] != d_pad:
        return F.pad(t, (0, d_pad - t.shape[-1]))
    if not t.is_contiguous() or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v as the kernel reads them: a head dim up to
    ``MAX_HEAD_DIM`` zero-padded to a multiple of 8, which leaves QK^T
    unchanged (call the kernel with the true ``head_dim`` and drop the
    padded output columns); each a contiguous tensor at a 16-byte-aligned
    address, as a fresh allocation is.  Inputs that are so already come
    back as they are, and so do inputs whose head dims differ, for
    ``flash_attention_fwd`` to refuse."""
    d = q.shape[-1]
    if not d == k.shape[-1] == v.shape[-1]:
        return q, k, v
    d_pad = -(-d // 8) * 8 if d <= MAX_HEAD_DIM else d
    return _operand(q, d_pad), _operand(k, d_pad), _operand(v, d_pad)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        head_dim: Optional[int] = None) -> torch.Tensor:
    """q (b, lq, hq, d); k/v (b, lk, hkv, d) -> (b, lq, hq, d); scores
    scaled by 1/sqrt(``head_dim``), d unless given.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    of their dtype: contiguous and 16-byte aligned, one dtype (float32
    or bfloat16), hq a multiple of hkv, d a multiple of 8 and at most
    128; anything else raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     head_dim=head_dim)
    dev = cuda.require_cuda("flash_attention_fwd", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(b, l, h, d) with matching k/v")
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention_fwd: batch or head dim of k/v "
                         "does not match q")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_fwd: hq={hq} is not a multiple "
                         f"of hkv={hkv}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head dim {d} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd: dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window {window} < 1")
    code = cuda.dtype_code(q, "flash_attention_fwd")
    out = torch.empty_like(q)
    if out.numel() == 0 or lk == 0:
        return out
    lib = cuda.library()
    cuda.check(lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk,
        hq, hkv, d, int(causal), 0 if window is None else int(window),
        1.0 / math.sqrt(head_dim or d), code, dev.index, cuda.stream(dev)),
        "flash_attention_fwd")
    LAUNCHES.flash_attention_fwd += 1
    return out
