"""The port's Hopper kernels on the card, against their plain versions.

Marked ``cuda``: they skip where there is no CUDA device (the kernels
have no CPU mode).  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels at the main path's full shapes;
these sweep small and ragged ones.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import registry
from repro_torch.kernels import residual_rmsnorm as rrn
from repro_torch.kernels import rmsnorm as rn
from repro_torch.perfcount import LAUNCHES

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 4096, 8 * 512 + 3, 1 << 20])
def test_fused_update_bitwise(gen, dtype, n):
    p, m, g = (_rand(gen, (n,), dtype) for _ in range(3))
    before = LAUNCHES.fused_update
    po, mo = fu.fused_update(p, m, g, lr=0.01, beta=0.9, scale=0.25)
    assert LAUNCHES.fused_update == before + 1
    pr, mr = fu.fused_update_plain(p, m, g, lr=0.01, beta=0.9, scale=0.25)
    assert torch.equal(po, pr) and torch.equal(mo, mr)
    # unaligned views take the scalar path, same bits
    po2, mo2 = fu.fused_update(p[1:], m[1:], g[1:], lr=0.01, beta=0.9,
                               scale=0.25)
    pr2, mr2 = fu.fused_update_plain(p[1:], m[1:], g[1:], lr=0.01, beta=0.9,
                                     scale=0.25)
    assert torch.equal(po2, pr2) and torch.equal(mo2, mr2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8), (3, 5, 2560), (7, 33), (2, 4096)])
def test_norms_match_plain(gen, dtype, shape):
    x, r = _rand(gen, shape, dtype), _rand(gen, shape, dtype)
    w = _rand(gen, shape[-1:], dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(rn.rmsnorm(x, w).float(),
                               rn.rmsnorm_plain(x, w).float(), **tol)
    s, o = rrn.residual_rmsnorm(x, r, w)
    sp, op = rrn.residual_rmsnorm_plain(x, r, w)
    assert torch.equal(s, sp)
    torch.testing.assert_close(o.float(), op.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,window", [
    (1, 1, 1, 1, 1, 8, True, None),
    (2, 65, 65, 4, 2, 80, True, None),
    (1, 100, 257, 8, 1, 64, True, 50),
    (2, 63, 130, 6, 3, 128, False, None),
    (1, 200, 200, 4, 4, 32, False, 17),
])
def test_flash_matches_plain(gen, dtype, b, lq, lk, hq, hkv, d, causal,
                             window):
    q = _rand(gen, (b, lq, hq, d), dtype)
    k = _rand(gen, (b, lk, hkv, d), dtype)
    v = _rand(gen, (b, lk, hkv, d), dtype)
    out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


def test_registry_backward_on_cuda_matches_plain(gen):
    q = _rand(gen, (2, 96, 4, 16), torch.float32).requires_grad_()
    k = _rand(gen, (2, 96, 2, 16), torch.float32).requires_grad_()
    v = _rand(gen, (2, 96, 2, 16), torch.float32).requires_grad_()
    grads = []
    for kernels in ("pallas", "xla"):
        out = registry.attention(q, k, v, causal=True, window=40,
                                 kernels=kernels)
        grads.append(torch.autograd.grad(out.square().sum(), (q, k, v)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(gen):
    x = _rand(gen, (4, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm(x.t(), torch.ones(4, device="cuda"))
    with pytest.raises(TypeError, match="dtype"):
        rn.rmsnorm(x, torch.ones(64, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        rn.rmsnorm(x.half(), torch.ones(64, device="cuda").half())
    q = _rand(gen, (1, 8, 2, 12), torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        fu.fused_update(x, x.cpu(), x, lr=0.1)
