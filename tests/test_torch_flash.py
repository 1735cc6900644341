"""The bf16 attention kernel's rounding points, emulated on the CPU.

``csrc/flash_attention_sm90.cu`` runs bf16 attention on the tensor cores:
q, k and v enter as bf16; S = Q K^T accumulates in f32; the online
softmax keeps m, l and the accumulator in f32, tile by tile (64 query
rows per warpgroup, 64 keys per tile, the scalar kernel's tile range,
masks only where a tile needs them), in log2 units (P = 2^(s * scale *
log2(e) - m)); P enters P V as two bf16 operands, P_hi = bf16(P) and P_lo
= bf16(P - P_hi), accumulated into the same f32 O, while l sums the
unrounded P.  The reference keeps P in f32.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  ``_emulate`` below repeats its arithmetic eagerly so
that these tests show, before the card sees it, that the card's bf16
tolerance covers the kernel's rounding: the emulation is held, element by
element, to one bf16 ulp of the reference's oracle and of its Pallas
kernel in interpret mode, from the same numpy-seeded inputs.  The ulp is
that of the larger of the two values, counted at no less than that of
2^-8: below it the f32 sums' own error (about 1e-6; 8e-7 with P kept in
f32) can exceed a bf16 ulp, so no f32 arithmetic holds one ulp there.
The kernel's earlier arithmetic, P rounded to bf16 alone, is kept as a
case that misses this tolerance (it met only atol 2e-2).
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
#: values below this count at its bf16 ulp (2^-15) in the 1-ulp tolerance
ULP_FLOOR = 2.0 ** -8
OLD_ATOL = 2e-2    # the tolerance P rounded to bf16 alone was held to


def _bf16_ulp(x):
    """One bf16 ulp at each value of ``x`` (f32), counted at no less than
    that of ``ULP_FLOOR``."""
    mag = x.abs().clamp(min=ULP_FLOOR)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _beyond_one_ulp(out, expected):
    """Elements of ``out`` (bf16) more than one bf16 ulp from ``expected``
    (f32, rounded to bf16 as the kernel's output is)."""
    a = out.float()
    b = torch.from_numpy(np.array(expected, np.float32)).to(
        torch.bfloat16).float()
    return (a - b).abs() > torch.maximum(_bf16_ulp(a), _bf16_ulp(b))


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


def _emulate(q, k, v, *, causal, window, p_mode="split"):
    """The bf16 kernel's arithmetic: q (b, lq, hq, d), k/v (b, lk, hkv, d)
    -> (b, lq, hq, d) in q's dtype.  ``p_mode`` is how P enters P V:
    "split"
    (the kernel's P_hi V + P_lo V), "bf16" (P rounded to bf16, the
    kernel's earlier arithmetic) or "f32"."""
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
            vt = vf[:, :, k0:k1]
            if p_mode == "split":
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                pv = p_hi @ vt + p_lo @ vt
            elif p_mode == "bf16":
                pv = p.to(torch.bfloat16).float() @ vt
            else:
                pv = p @ vt
            acc = acc * alpha + pv
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


def _expected(reference, case, qn, kn, vn):
    """The reference package's bf16 attention, as f32 numpy."""
    causal, window, block = CASES[case][6:]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn))
    if reference == "oracle":
        out = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    else:
        out = jax_flash(jq, jk, jv, causal=causal, window=window,
                        block_q=block, block_k=block, interpret=True)
    return np.array(jnp.asarray(out, jnp.float32))


@pytest.mark.parametrize("reference", ["oracle", "pallas interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_bf16_kernel_within_card_tolerance(case, reference):
    """P_hi V + P_lo V: every element within one bf16 ulp (counted at no
    less than 2^-8's) of the reference."""
    causal, window = CASES[case][6:8]
    qn, kn, vn = _inputs(case, seed=sorted(CASES).index(case))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    out = _emulate(tq, tk, tv, causal=causal, window=window)
    expected = _expected(reference, case, qn, kn, vn)
    assert out.shape == tq.shape and out.dtype == torch.bfloat16
    beyond = _beyond_one_ulp(out, expected)
    assert not bool(beyond.any()), (
        f"{int(beyond.sum())} elements beyond one bf16 ulp")


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_p_shows_the_old_error(case):
    """The kernel's earlier arithmetic, P rounded to bf16 alone, misses
    the one-ulp tolerance (it met only atol 2e-2), and differs from the
    reference at ten times as many elements or more as the split does."""
    causal, window = CASES[case][6:8]
    qn, kn, vn = _inputs(case, seed=sorted(CASES).index(case))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    expected = _expected("oracle", case, qn, kn, vn)
    old = _emulate(tq, tk, tv, causal=causal, window=window, p_mode="bf16")
    new = _emulate(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(old.float().numpy(), expected, rtol=0,
                               atol=OLD_ATOL)
    assert bool(_beyond_one_ulp(old, expected).any())
    rounded = torch.from_numpy(expected).to(torch.bfloat16)
    share_old = (old != rounded).float().mean().item()
    share_new = (new != rounded).float().mean().item()
    assert share_new <= share_old / 10, (share_new, share_old)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_tile_walk_with_f32_p_matches_oracle(case):
    """With f32 inputs and P kept in f32, the emulated walk (tile ranges,
    skipped tiles, masks only where a tile needs them) equals the oracle
    up to f32 summation order: the rounding of P is all that the kernel
    adds."""
    causal, window = CASES[case][6:8]
    qn, kn, vn = _inputs(case, seed=sorted(CASES).index(case))
    out = _emulate(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                   causal=causal, window=window, p_mode="f32")
    expected = jref.flash_attention_ref(
        *(jnp.asarray(a, jnp.float32) for a in (qn, kn, vn)), causal=causal,
        window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=0,
                               atol=2e-5)
