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
size that must divide the lengths and no fallback.  A call the kernel
cannot take (a view that is not 16-byte aligned, a failed tensor-map
encode or launch) raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import \
    flash_attention_ref as flash_attention_plain
from repro_torch.perfcount import LAUNCHES

__all__ = ["flash_attention_fwd", "flash_attention_plain"]

#: head dims the kernel takes: a multiple of 8 up to this
MAX_HEAD_DIM = 128


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (b, lq, hq, d); k/v (b, lk, hkv, d) -> (b, lq, hq, d).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    of their dtype: contiguous and 16-byte aligned, one dtype (float32
    or bfloat16), hq a multiple of hkv, d a multiple of 8 and at most
    128; anything else raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
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
        1.0 / math.sqrt(d), code, dev.index, cuda.stream(dev)),
        "flash_attention_fwd")
    LAUNCHES.flash_attention_fwd += 1
    return out
