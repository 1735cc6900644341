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
from repro_torch.kernels import fused_compress as fc
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
@pytest.mark.parametrize("k", [1, 2, 3, 5, 40])
@pytest.mark.parametrize("n", [7, 4096, 8 * 512 + 3, 1 << 20])
def test_fused_update_batched_bitwise(gen, dtype, k, n):
    p, m = _rand(gen, (n,), dtype), _rand(gen, (n,), dtype)
    gs = [_rand(gen, (n,), dtype) for _ in range(k)]
    scales = [1.0 / (1 + j) for j in range(k)]
    before = LAUNCHES.snapshot()
    po, mo = fu.fused_update_batched(p, m, gs, lr=0.01, beta=0.9,
                                     scales=scales)
    after = LAUNCHES.snapshot()
    if k == 1:
        assert after["fused_update"] == before["fused_update"] + 1
    else:   # one launch per MAX_BATCH contributions
        assert after["fused_update_batched"] == \
            before["fused_update_batched"] + -(-k // fu.MAX_BATCH)
    pr, mr = fu.fused_update_batched_plain(p, m, gs, lr=0.01, beta=0.9,
                                           scales=scales)
    assert torch.equal(po, pr) and torch.equal(mo, mr)
    # K sequential launches of the single kernel give the same bits
    ps_, ms_ = p, m
    for g, sc in zip(gs, scales):
        ps_, ms_ = fu.fused_update(ps_, ms_, g, lr=0.01, beta=0.9, scale=sc)
    assert torch.equal(po, ps_) and torch.equal(mo, ms_)
    # a stacked tensor and unaligned views fold the same
    po2, mo2 = fu.fused_update_batched(p, m, torch.stack(gs), lr=0.01,
                                       beta=0.9, scales=scales)
    assert torch.equal(po2, po) and torch.equal(mo2, mo)
    po3, mo3 = fu.fused_update_batched(p[1:], m[1:], [g[1:] for g in gs],
                                       lr=0.01, beta=0.9, scales=scales)
    pr3, mr3 = fu.fused_update_batched_plain(
        p[1:], m[1:], [g[1:] for g in gs], lr=0.01, beta=0.9, scales=scales)
    assert torch.equal(po3, pr3) and torch.equal(mo3, mr3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 64, 1000])
@pytest.mark.parametrize("kind", ["int8", "topk-0.01", "topk-0.05",
                                  "topk-0.25", "topk-1.0"])
def test_fused_compress_bitwise(gen, dtype, rows, kind):
    rows = rows - rows % 8
    g = _rand(gen, (rows, 512), dtype)
    e = 0.01 * _rand(gen, (rows, 512), torch.float32)
    if kind == "int8":
        fn, plain = fc.fused_int8_ef, fc.fused_int8_ef_plain
    else:
        frac = float(kind.split("-")[1])
        fn = lambda a, b: fc.fused_topk_ef(a, b, fraction=frac)
        plain = lambda a, b: fc.fused_topk_ef_plain(a, b, fraction=frac)
    name = "fused_int8_ef" if kind == "int8" else "fused_topk_ef"
    before = getattr(LAUNCHES, name)
    dq, er = fn(g, e)
    assert getattr(LAUNCHES, name) == before + 1
    dr, err = plain(g, e)
    assert dq.dtype == g.dtype and er.dtype == torch.float32
    assert torch.equal(dq, dr) and torch.equal(er, err)
    # ties and exact zeros: a tile of repeated values and a zero tile
    g2 = torch.zeros((16, 512), device="cuda", dtype=dtype)
    g2[:8] = torch.arange(4096, device="cuda").reshape(8, 512).remainder(7)
    e2 = torch.zeros((16, 512), device="cuda")
    a, b = fn(g2, e2)
    c, d = plain(g2, e2)
    assert torch.equal(a, c) and torch.equal(b, d)


def test_fused_compress_refuses_what_it_cannot_launch_on(gen):
    g = _rand(gen, (8, 512), torch.float32)
    with pytest.raises(TypeError, match="float32"):
        fc.fused_int8_ef(g, g.half())
    with pytest.raises(ValueError, match="one CUDA device"):
        fc.fused_topk_ef(g, g.cpu())
    z = torch.zeros((0, 512), device="cuda")
    assert fc.fused_int8_ef(z, z)[0] is z


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
