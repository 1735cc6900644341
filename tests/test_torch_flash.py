"""The bf16 attention kernel's rounding points, emulated on the CPU.

``csrc/flash_attention_sm90.cu`` runs bf16 attention on the tensor cores:
q, k and v enter as bf16; S = Q K^T accumulates in f32; the online
softmax keeps m, l and the accumulator in f32, tile by tile (64 query
rows per warpgroup, 64 keys per tile, the scalar kernel's tile range,
masks only where a tile needs them), in log2 units (P = 2^(s * scale *
log2(e) - m)); P is rounded to bf16 before P V, while l sums the
unrounded P.  The reference keeps P in f32.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  ``_emulate`` below repeats its arithmetic eagerly so
that these tests show, before the card sees it, that the card's bf16
tolerance (atol 2e-2 against the plain version) covers the kernel's
rounding: the emulation is held to that tolerance against the reference's
oracle and its Pallas kernel in interpret mode, from the same
numpy-seeded inputs.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash

torch.set_num_threads(2)

BQ = 64        # query rows per consumer warpgroup
BK = 64        # keys per tile
NEG_BIG = -1e30
ATOL = 2e-2    # the card's bf16 tolerance (chip_smoke.py, test_torch_cuda)


def _tile_range(r0, lq, lk, causal, window):
    """Key tiles [lo, hi] the 64 query rows from r0 walk (kernel's
    ``tile_range``)."""
    off = lk - lq
    qmin, qmax = r0 + off, min(r0 + BQ, lq) - 1 + off
    k_lo, k_hi = 0, lk - 1
    if causal:
        k_hi = min(k_hi, qmax)
    if window:
        k_lo = max(k_lo, qmin - window + 1)
    lo = k_lo // BK
    return lo, (k_hi // BK if k_hi >= k_lo else lo - 1)


def _emulate(q, k, v, *, causal, window, p_dtype=torch.bfloat16):
    """The bf16 kernel's arithmetic: q (b, lq, hq, d), k/v (b, lk, hkv, d)
    -> (b, lq, hq, d) in q's dtype, P rounded to ``p_dtype`` before P V."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    off = lk - lq
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)                       # (b, hq, lq, d)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    out = torch.empty((b, hq, lq, d), dtype=torch.float32)
    for r0 in range(0, lq, BQ):
        r1 = min(r0 + BQ, lq)
        qpos = torch.arange(r0, r1)[:, None] + off
        qmin, qmax = r0 + off, r1 - 1 + off
        m = torch.full((b, hq, r1 - r0, 1), NEG_BIG)
        l = torch.zeros((b, hq, r1 - r0, 1))
        acc = torch.zeros((b, hq, r1 - r0, d))
        lo, hi = _tile_range(r0, lq, lk, causal, window)
        for kt in range(lo, hi + 1):
            k0 = kt * BK
            k1 = min(k0 + BK, lk)
            s = qf[:, :, r0:r1] @ kf[:, :, k0:k1].transpose(-1, -2)
            need_mask = (k0 + BK > lk or (causal and k0 + BK - 1 > qmin)
                         or (window is not None and k0 <= qmax - window))
            mul = scale_log2        # what s still needs
            if need_mask:
                kpos = torch.arange(k0, k1)[None, :]
                allowed = torch.ones_like(s[0, 0], dtype=torch.bool)
                if causal:
                    allowed &= kpos <= qpos
                if window is not None:
                    allowed &= kpos > qpos - window
                s = torch.where(allowed, s * scale_log2,
                                torch.tensor(NEG_BIG))
                mul = 1.0
                # keys at or past lk are -inf: they are not in s at all
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * mul)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * mul - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(p_dtype).float() @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


# (b, lq, lk, hq, hkv, d, causal, window, pallas block)
CASES = {
    "d80 gqa4 causal": (2, 192, 192, 8, 2, 80, True, None, 64),
    "d80 gqa4 causal window 4096": (1, 256, 256, 4, 1, 80, True, 4096, 64),
    "window cuts a tile": (1, 192, 192, 4, 2, 64, True, 40, 64),
    "window cuts a tile, non-causal": (1, 128, 192, 4, 1, 32, False, 40,
                                       64),
    "ragged lq < lk": (2, 72, 136, 4, 1, 80, True, None, 8),
    "ragged lq < lk, window": (1, 72, 136, 4, 2, 48, True, 50, 8),
    "d8 pads the contraction": (1, 128, 128, 4, 1, 8, True, None, 64),
    "d24 non-causal": (1, 64, 128, 2, 2, 24, False, None, 64),
    "d128 mqa non-causal": (1, 64, 192, 4, 1, 128, False, None, 64),
}


def _inputs(case, seed):
    b, lq, lk, hq, hkv, d = CASES[case][:6]
    rng = np.random.RandomState(seed)
    # bf16-exact values, so both packages see the same inputs
    arrs = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(torch.bfloat16).float().numpy()
            for shape in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d))]
    return arrs


@pytest.mark.parametrize("reference", ["oracle", "pallas interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_bf16_kernel_within_card_tolerance(case, reference):
    causal, window, block = CASES[case][6:]
    qn, kn, vn = _inputs(case, seed=sorted(CASES).index(case))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn))
    out = _emulate(tq, tk, tv, causal=causal, window=window)
    if reference == "oracle":
        expected = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                            window=window)
    else:
        expected = jax_flash(jq, jk, jv, causal=causal, window=window,
                             block_q=block, block_k=block, interpret=True)
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    assert out.shape == tq.shape and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), expected, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_tile_walk_with_f32_p_matches_oracle(case):
    """With f32 inputs and P kept in f32, the emulated walk (tile ranges,
    skipped tiles, masks only where a tile needs them) equals the oracle
    up to f32 summation order: the bf16 rounding is all that the kernel
    adds."""
    causal, window = CASES[case][6:8]
    qn, kn, vn = _inputs(case, seed=sorted(CASES).index(case))
    out = _emulate(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                   causal=causal, window=window, p_dtype=torch.float32)
    expected = jref.flash_attention_ref(
        *(jnp.asarray(a, jnp.float32) for a in (qn, kn, vn)), causal=causal,
        window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=0,
                               atol=2e-5)
