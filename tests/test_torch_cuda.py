"""The port's Hopper kernels on the card, against their plain versions.

Marked ``cuda``: they skip where there is no CUDA device (the kernels
have no CPU mode).  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels at the main path's full shapes;
these sweep small and ragged ones.
"""

from __future__ import annotations

import math
import threading

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_compress as fc
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import ref
from repro_torch.kernels import registry
from repro_torch.kernels import residual_rmsnorm as rrn
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssm_scan as ss
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


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_tree_compressors_keep_the_host_out(gen, name):
    """The per-leaf compressors (top-k's radix select, ``kth_largest``,
    and int8's max) run with no host sync on the card, and top-k's
    threshold is ``torch.topk``'s k-th value."""
    from repro_torch.optim import compression as comp
    g = {"a": _rand(gen, (96, 512), torch.float32).round(),
         "b": _rand(gen, (4099,), torch.bfloat16)}
    c = comp.make_compressor(name)
    err = c.init_error(g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, err = c.apply(g, err)
        thresh = comp.kth_largest(g["a"].abs(), 1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(thresh,
                       torch.topk(g["a"].abs().reshape(-1), 1000).values[-1])
    assert out["a"].shape == g["a"].shape and err["b"].dtype == torch.float32


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
    (4, 1024, 1024, 32, 8, 80, True, None),     # the train step's shape
    (2, 1000, 1500, 32, 8, 80, True, 256),
    (2, 1024, 1024, 32, 8, 128, True, None),    # the hybrid step's shape
    # one head dim per layout of the last TMA box, each with more work
    # items than the card has SMs
    (4, 600, 600, 16, 4, 40, True, None),
    (2, 700, 1100, 32, 8, 96, True, 300),
    (2, 1024, 1024, 24, 8, 112, False, None),
    # the transformer families' head layouts at head dim 128: GQA 8:1
    # (qwen1.5-110b, chameleon-34b), MHA 40/40 (qwen1.5-32b), 12:1
    # (mistral-large-123b), 16:1 (qwen3-moe), MHA 16/16 (deepseek-moe)
    (2, 1024, 1024, 64, 8, 128, True, None),
    (2, 1024, 1024, 40, 40, 128, True, None),
    (2, 1024, 1024, 96, 8, 128, True, None),
    (2, 1024, 1024, 64, 4, 128, True, None),
    (2, 1024, 1024, 16, 16, 128, True, None),
    (2, 300, 300, 5, 5, 16, True, None),     # qwen1.5-32b smoke, padded
])
def test_flash_matches_plain(gen, dtype, b, lq, lk, hq, hkv, d, causal,
                             window):
    """f32: atol 2e-5.  bf16 (P_hi V + P_lo V on the tensor cores): every
    element within one bf16 ulp of the plain version, the ulp of the
    larger of the two values counted at no less than that of 2^-8 (below
    it the f32 sums' own error can exceed a bf16 ulp;
    tests/test_torch_flash.py)."""
    q = _rand(gen, (b, lq, hq, d), dtype)
    k = _rand(gen, (b, lk, hkv, d), dtype)
    v = _rand(gen, (b, lk, hkv, d), dtype)
    out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
        return
    a, b_ = out.float(), want.float()
    ulp = torch.maximum(_bf16_ulp(a.abs().clamp(min=2.0 ** -8)),
                        _bf16_ulp(b_.abs().clamp(min=2.0 ** -8)))
    beyond = (a - b_).abs() > ulp
    assert not bool(beyond.any()), (
        f"{int(beyond.sum())} elements beyond one bf16 ulp, max |err| "
        f"{float((a - b_).abs().max())}")


def test_flash_bf16_counts_one_launch_per_call(gen):
    q = _rand(gen, (2, 130, 8, 80), torch.bfloat16)
    k = _rand(gen, (2, 130, 2, 80), torch.bfloat16)
    for i in range(3):
        before = LAUNCHES.flash_attention_fwd
        fa.flash_attention_fwd(q, k, k, causal=bool(i % 2), window=None)
        assert LAUNCHES.flash_attention_fwd == before + 1


def test_flash_bf16_raises_on_a_misaligned_view(gen):
    """The tensor-core kernel takes 16-byte aligned tensors; a view that
    is not raises instead of computing on another path."""
    shape = (1, 64, 4, 80)
    n = math.prod(shape)
    buf = _rand(gen, (n + 1,), torch.bfloat16)
    q = buf[1:].view(shape)             # contiguous, 2 bytes off
    k = _rand(gen, shape, torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = LAUNCHES.flash_attention_fwd
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa.flash_attention_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa.flash_attention_fwd(k, q, k)
    assert LAUNCHES.flash_attention_fwd == before


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


def _ssm_inputs(gen, b, l, di, ds, udtype, h0_nonzero):
    sp = torch.nn.functional.softplus
    u = _rand(gen, (b, l, di), torch.float32).to(udtype)
    delta = sp(_rand(gen, (b, l, di), torch.float32))
    a = -sp(_rand(gen, (di, ds), torch.float32))
    bmat = _rand(gen, (b, l, ds), torch.float32)
    cmat = _rand(gen, (b, l, ds), torch.float32)
    h0 = _rand(gen, (b, di, ds), torch.float32) if h0_nonzero \
        else torch.zeros((b, di, ds), device="cuda")
    return u, delta, a, bmat, cmat, h0


@pytest.mark.parametrize("h0_nonzero", [False, True])
@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("b,l,di", [(1, 1, 1), (3, 100, 1000),
                                    (1, 257, 128), (3, 64, 200)])
def test_ssm_scan_matches_plain(gen, b, l, di, ds, udtype, h0_nonzero):
    """Ragged di (not a multiple of the 32-channel block), l not a
    multiple of the 32-step run, b in {1, 3}.  Tolerance: expf against
    torch's exp and the order of the C . h sum differ by ulps, damped by
    exp(delta A) < 1: 1e-5 of the largest f32 output (h_last and y in
    f32); for y stored in bf16, that plus one bf16 ulp (rtol 2**-7)."""
    xs = _ssm_inputs(gen, b, l, di, ds, udtype, h0_nonzero)
    before = LAUNCHES.ssm_scan
    y, h = ss.ssm_scan(*xs, chunk=7)
    assert LAUNCHES.ssm_scan == before + 1
    yr, hr = ss.ssm_scan_plain(*xs)
    assert y.dtype == udtype and h.dtype == torch.float32
    scale = max(1.0, float(hr.abs().max()))
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5 * scale)
    if udtype == torch.float32:
        scale = max(1.0, float(yr.abs().max()))
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5 * scale)
    else:
        scale = max(1.0, float(yr.float().abs().max()))
        torch.testing.assert_close(y.float(), yr.float(), rtol=2.0 ** -7,
                                   atol=1e-5 * scale)


def test_ssm_scan_registry_backward_on_cuda_matches_plain(gen):
    xs = [t.requires_grad_() for t in
          _ssm_inputs(gen, 2, 40, 70, 16, torch.float32, True)]
    grads = []
    for kernels in ("pallas", "xla"):
        before = LAUNCHES.ssm_scan
        out = registry.ssm_scan(*xs, chunk=8, kernels=f"ssm_scan={kernels}")
        assert LAUNCHES.ssm_scan == before + (kernels == "pallas")
        loss = sum(o.square().sum() for o in out)
        grads.append(torch.autograd.grad(loss, xs))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


SCAN_NEEDS = (True,) * 5 + (False,)    # h0 is zeros in the model


def _scan_backward_inputs(gen, b, l, di, ds):
    """The six saved inputs of the scan (f32, h0 zeros), dy, dh_last."""
    xs = _ssm_inputs(gen, b, l, di, ds, torch.float32, False)
    return (*xs, _rand(gen, (b, l, di), torch.float32),
            _rand(gen, (b, di, ds), torch.float32))


def _eager_scan_backward(ts):
    return registry._vjp_through(ref.ssm_scan_ref, ts[:6], ts[6:],
                                 SCAN_NEEDS)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("b,l,di,ds", [(2, 40, 70, 16),
                                       (2, 1024, 8192, 16)])  # hybrid's
def test_graphed_scan_backward_is_bitwise_the_eager_one(gen, b, l, di, ds):
    """One capture, then replays: two successive calls with different
    inputs (the static buffers refilled) each give the eager
    ``_vjp_through``'s gradients bit for bit."""
    graphs = registry.ScanBackwardGraphs()
    for _ in range(2):
        ts = _scan_backward_inputs(gen, b, l, di, ds)
        got = graphs(ts, SCAN_NEEDS)
        _assert_bitwise(got, _eager_scan_backward(ts))
    assert len(graphs) == 1 and graphs.pool_bytes() > 0
    graphs.clear()


def test_graphed_scan_backward_two_threads_at_once(gen):
    """Two threads running the backward at once get a graph each (no
    shared static buffers) and their own gradients, bit for bit."""
    graphs = registry.ScanBackwardGraphs()
    cases = [_scan_backward_inputs(gen, 2, 96, 160, 16) for _ in range(2)]
    wants = [_eager_scan_backward(ts) for ts in cases]
    results, errors = [None, None], []
    start = threading.Barrier(2, timeout=120)

    def run(i):
        try:
            start.wait()
            for _ in range(3):
                got = graphs(cases[i], SCAN_NEEDS)
            torch.cuda.current_stream().synchronize()
            results[i] = got
        except BaseException as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(graphs) == 2
    for got, want in zip(results, wants):
        _assert_bitwise(got, want)
    graphs.clear()


def test_registry_scan_backward_replays_a_graph(gen):
    """``_SSMScan.backward`` on the card goes through the process's
    graphs: the same gradients as the eager body, bit for bit."""
    ts = _scan_backward_inputs(gen, 2, 64, 96, 16)
    xs = [t.clone().requires_grad_(n) for t, n in zip(ts[:6], SCAN_NEEDS)]
    registry.SCAN_BACKWARD_GRAPHS.clear()
    y, h = registry.ssm_scan(*xs, chunk=16, kernels="ssm_scan=pallas")
    got = torch.autograd.grad((y, h), xs[:5], ts[6:])
    assert len(registry.SCAN_BACKWARD_GRAPHS) == 1
    _assert_bitwise(got, _eager_scan_backward(ts)[:5])
    registry.SCAN_BACKWARD_GRAPHS.clear()


def test_ssm_scan_refuses_what_it_cannot_launch_on(gen):
    u, delta, a, bmat, cmat, h0 = _ssm_inputs(gen, 1, 8, 16, 16,
                                              torch.float32, False)
    with pytest.raises(ValueError, match="d_state 4"):
        ss.ssm_scan(u, delta, a[:, :4], bmat[..., :4], cmat[..., :4],
                    h0[..., :4])
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(u.transpose(1, 2).contiguous().transpose(1, 2), delta,
                    a, bmat, cmat, h0)
    with pytest.raises(TypeError, match="not supported"):
        ss.ssm_scan(u.half(), delta, a, bmat, cmat, h0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.ssm_scan(u, delta.cpu(), a, bmat, cmat, h0)


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``ref`` (f32)."""
    mag = ref.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _assert_norm_close(got, want, dtype):
    """f32: rtol = atol = 1e-5; bf16: within one bf16 ulp of either."""
    a, b = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.maximum(_bf16_ulp(a), _bf16_ulp(b))
        assert bool(((a - b).abs() <= ulp).all()), (a - b).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("d", [64, 128, 2048, 2560, 2561, 4096, 5120, 8192,
                               12288, 24576])
def test_rmsnorm_every_path(gen, dtype, rows, d):
    """Every path of csrc/rmsnorm.cu: the register path at the widths the
    models use (64, 128 for q/k norms, 2048, 2560, 4096, 5120, 8192,
    12288), d = 2561 (not whole 16-byte vectors: the loop path, one
    element a lane), d = 24576 (wider than the register path holds: the
    loop path on vectors), and an aligned buffer viewed one element off
    (the loop path's scalar form).  One launch a call."""
    if rows * d > (1 << 26):   # keep each tensor within 256 MB of f32
        rows = (1 << 26) // d
    x = _rand(gen, (rows, d), dtype)
    w = (1.0 + 0.1 * _rand(gen, (d,), torch.float32)).to(dtype)
    before = LAUNCHES.rmsnorm
    _assert_norm_close(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)
    assert LAUNCHES.rmsnorm == before + 1
    n = rows * d
    bx = _rand(gen, (n + 1,), dtype)
    bw = (1.0 + 0.1 * _rand(gen, (d + 1,), torch.float32)).to(dtype)
    xv, wv = bx[1:].view(rows, d), bw[1:]
    assert xv.data_ptr() % 16 and xv.is_contiguous()
    _assert_norm_close(rn.rmsnorm(xv, wv), rn.rmsnorm_plain(xv, wv), dtype)
    assert LAUNCHES.rmsnorm == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("d", [64, 1000, 2048, 2560, 2561, 4096, 5120,
                               8192, 12288, 24576])
def test_residual_rmsnorm_every_path(gen, dtype, rows, d):
    """Every path of csrc/residual_rmsnorm.cu: the register path at the
    widths the models use (64, 2048, 2560, 4096, 5120, 8192, 12288) and
    others it takes (1000), d = 2561 (not whole 16-byte vectors: the loop
    path, one element a lane), d = 24576 (wider than the register path
    holds: the loop path on vectors), and an aligned buffer viewed one
    element off (the loop path's scalar form).  One launch a call."""
    if rows * d > (1 << 26):   # keep each tensor within 256 MB of f32
        rows = (1 << 26) // d
    x, r = _rand(gen, (rows, d), dtype), _rand(gen, (rows, d), dtype)
    w = (1.0 + 0.1 * _rand(gen, (d,), torch.float32)).to(dtype)
    before = LAUNCHES.residual_rmsnorm
    s, o = rrn.residual_rmsnorm(x, r, w)
    assert LAUNCHES.residual_rmsnorm == before + 1
    sp, op = rrn.residual_rmsnorm_plain(x, r, w)
    assert torch.equal(s, sp)
    _assert_norm_close(o, op, dtype)
    # one element off: contiguous views whose data is not 16-byte aligned
    n = rows * d
    bx, br = _rand(gen, (n + 1,), dtype), _rand(gen, (n + 1,), dtype)
    bw = (1.0 + 0.1 * _rand(gen, (d + 1,), torch.float32)).to(dtype)
    xv, rv, wv = bx[1:].view(rows, d), br[1:].view(rows, d), bw[1:]
    assert xv.data_ptr() % 16 and xv.is_contiguous()
    s, o = rrn.residual_rmsnorm(xv, rv, wv)
    sp, op = rrn.residual_rmsnorm_plain(xv, rv, wv)
    assert torch.equal(s, sp)
    _assert_norm_close(o, op, dtype)
    assert LAUNCHES.residual_rmsnorm == before + 2


def _assert_scan_close(y, h, yr, hr, udtype):
    """1e-5 of the largest plain output (h_last and an f32 y); a bf16 y
    within that plus one bf16 ulp."""
    assert y.dtype == udtype and h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    tol_h = 1e-5 * max(1.0, float(hr.abs().max()))
    assert float((h - hr).abs().max()) <= tol_h
    yf, yrf = y.float(), yr.float()
    tol_y = 1e-5 * max(1.0, float(yrf.abs().max()))
    err = (yf - yrf).abs()
    if udtype == torch.float32:
        assert float(err.max()) <= tol_y
    else:
        ulp = torch.maximum(_bf16_ulp(yf), _bf16_ulp(yrf))
        assert bool((err <= ulp + tol_y).all()), float(err.max())


@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("l", [1, 15, 17, 33, 1000])
@pytest.mark.parametrize("di", [1000, 999])
def test_ssm_scan_lanes_runs_and_ragged_channels(gen, di, l, b, ds, udtype):
    """The lane-split scan: di not a multiple of the block's 32 channels,
    with di = 1000 on the 16-byte load path and di = 999 on the
    one-element path; l within, across and past the 32-step run; a
    non-zero h0; one launch a call."""
    xs = _ssm_inputs(gen, b, l, di, ds, udtype, True)
    before = LAUNCHES.ssm_scan
    y, h = ss.ssm_scan(*xs)
    assert LAUNCHES.ssm_scan == before + 1
    _assert_scan_close(y, h, *ss.ssm_scan_plain(*xs), udtype)


@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_long_sequence(gen, udtype):
    """l = 4096 at di 512, where a drift of the new order of the sum over
    the states would show first; delta in bf16 as well."""
    xs = list(_ssm_inputs(gen, 2, 4096, 512, 16, udtype, True))
    _assert_scan_close(*ss.ssm_scan(*xs), *ss.ssm_scan_plain(*xs), udtype)
    xs[1] = xs[1].to(torch.bfloat16)
    _assert_scan_close(*ss.ssm_scan(*xs), *ss.ssm_scan_plain(*xs), udtype)


def test_ssm_scan_misaligned_views(gen):
    """u and delta viewed one element off an aligned buffer take the
    one-element load path and agree all the same."""
    b, l, di, ds = 2, 33, 64, 16
    xs = list(_ssm_inputs(gen, b, l, di, ds, torch.float32, True))
    n = b * l * di
    for i in (0, 1):
        buf = torch.empty(n + 1, device="cuda")
        buf[1:] = xs[i].reshape(-1)
        xs[i] = buf[1:].view(b, l, di)
        assert xs[i].data_ptr() % 16
    _assert_scan_close(*ss.ssm_scan(*xs), *ss.ssm_scan_plain(*xs),
                       torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["head_dim_12", "misaligned_q",
                                  "misaligned_v", "strided_k"])
def test_registry_attention_launches_the_kernel_on_padded_and_copied_inputs(
        gen, dtype, case):
    """Inputs the kernel reads only padded (head dim 12) or copied (a
    view 2 or 4 bytes off a 16-byte boundary, a strided view) launch it
    through the registry, once, and match the plain version within the
    kernel's tolerance."""
    d = 12 if case == "head_dim_12" else 80
    shape_q, shape_kv = (2, 70, 4, d), (2, 70, 2, d)
    q = _rand(gen, shape_q, dtype)
    k = _rand(gen, shape_kv, dtype)
    v = _rand(gen, shape_kv, dtype)
    if case.startswith("misaligned"):
        shape = shape_q if case == "misaligned_q" else shape_kv
        buf = _rand(gen, (math.prod(shape) + 1,), dtype)
        view = buf[1:].view(shape)       # contiguous, not 16-byte aligned
        assert view.data_ptr() % 16
        if case == "misaligned_q":
            q = view
        else:
            v = view
    elif case == "strided_k":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        assert not k.is_contiguous()
    before = LAUNCHES.flash_attention_fwd
    out = registry.attention(q, k, v, causal=True, window=33)
    assert LAUNCHES.flash_attention_fwd == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = fa.flash_attention_plain(q, k, v, causal=True, window=33)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["head_dim_136", "float16"])
def test_registry_attention_raises_where_no_kernel_takes(gen, case):
    """A head dim above 128 or float16 has no kernel: the registry
    raises on the card, and nothing launches."""
    d, dtype = (136, torch.float32) if case == "head_dim_136" \
        else (80, torch.float16)
    q = _rand(gen, (1, 32, 4, d), dtype)
    k = _rand(gen, (1, 32, 2, d), dtype)
    before = LAUNCHES.flash_attention_fwd
    with pytest.raises((ValueError, TypeError), match="flash_attention_fwd"):
        registry.attention(q, k, k)
    assert LAUNCHES.flash_attention_fwd == before


@pytest.mark.parametrize("shape", [(2, 64, 256, 1000), (4, 1024, 2560,
                                                        32000)])
def test_bf16_unembed_matches_the_f32_product(gen, shape):
    """The bf16 unembed on the tensor cores (``aten::mm.dtype``, f32
    accumulation and output) sums the same exact products as the f32
    product in another order: each logit within 1e-5 of the sum of its
    products' magnitudes.  Its backward is the f32 product's, bit for
    bit."""
    from repro_torch.models import layers
    b, l, d, v = shape
    x = _rand(gen, (b, l, d), torch.bfloat16).requires_grad_()
    table = (_rand(gen, (v, d), torch.bfloat16) * 0.05).requires_grad_()
    logits = layers.unembed(x, table, vocab_size=v - 7)
    with torch.no_grad():
        ref = x.float() @ table.float().t()
        mags = x.float().abs() @ table.float().abs().t()
    assert logits.dtype == torch.float32
    live = slice(0, v - 7)
    err = (logits[..., live] - ref[..., live]).abs()
    assert bool((err <= 1e-5 * mags[..., live]).all()), float(err.max())
    assert bool((logits[..., v - 7:] == layers.NEG_INF).all())
    g = _rand(gen, logits.shape, torch.float32)
    gx, gt = torch.autograd.grad(logits, (x, table), g)
    ref_logits = x.float() @ table.float().t()
    ref_logits = ref_logits.masked_fill(
        torch.arange(v, device="cuda") >= v - 7, layers.NEG_INF)
    rx, rt = torch.autograd.grad(ref_logits, (x, table), g)
    assert torch.equal(gx, rx) and torch.equal(gt, rt)


# ------------------------------------------------------- ft (item 8)
def _bf16_server(device, n_shards=4):
    from repro_torch.core.policies import make_policy_factory
    from repro_torch.ps.server import ServerOptimizer
    from repro_torch.ps.sharded.server import ShardedParameterServer
    g = torch.Generator().manual_seed(3)
    params = {"w0": torch.randn(24, 512, generator=g),
              "w1": torch.randn(16, 128, generator=g),
              "b": torch.randn(300, generator=g)}
    return ShardedParameterServer(
        {k: v.to(device=device, dtype=torch.bfloat16)
         for k, v in params.items()},
        make_policy_factory("asp", n_workers=1),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9,
                                staleness_damping=True),
        1, n_shards, apply_mode="fused")


def _bits(t):
    return t.detach().cpu().view(torch.int16)


def test_bf16_snapshot_restores_bitwise_on_the_card(gen, tmp_path):
    """bf16 shard buffers on cuda:0 through a snapshot on disk and back
    into a fresh server on the card, bit for bit; its next apply (the
    fused_update kernel) matches the original's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft.snapshot import ServerSnapshotter, restore_latest
    a = _bf16_server("cuda")
    rows = a.plan.wire_layout().total_rows
    for _ in range(3):
        a.push_packed(0, _rand(gen, (rows, 512), torch.bfloat16))
    mgr = CheckpointManager(str(tmp_path))
    ServerSnapshotter(a, mgr, every_s=60.0).save_now()
    mgr.wait()
    b = _bf16_server("cuda")
    assert restore_latest(b, CheckpointManager(str(tmp_path))) == a.version
    for sa, sb in zip(a.shards, b.shards):
        assert sb._packed_p.is_cuda and sb._packed_p.dtype == torch.bfloat16
        assert torch.equal(_bits(sa._packed_p), _bits(sb._packed_p))
        assert torch.equal(_bits(sa._packed_m), _bits(sb._packed_m))
    g = _rand(gen, (rows, 512), torch.bfloat16)
    a.push_packed(0, g)
    b.push_packed(0, g)
    for sa, sb in zip(a.shards, b.shards):
        assert torch.equal(_bits(sa._packed_p), _bits(sb._packed_p))
    a.stop(), b.stop()


def test_migrate_on_the_card_is_bitwise_the_cpu_result(gen):
    from repro_torch.ft.reshard import build_migration
    srv = _bf16_server("cpu")
    old, new = srv.plan, srv.plan.rebuild(6)
    mig = build_migration(old, new)
    bufs = [_rand(gen, (r, 512), torch.bfloat16)
            for r in old.wire_layout().shard_rows]
    on_card = mig.migrate(bufs)
    on_cpu = mig.migrate([b.cpu() for b in bufs])
    assert all(t.is_cuda for t in on_card)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(_bits(a), _bits(b))
    srv.stop()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_fold_on_the_card_is_bitwise_the_cpu_fold(gen, dtype):
    from repro_torch.ft.reshard import replay_fold
    p, m, g = (_rand(gen, (1 << 16,), dtype) for _ in range(3))
    for scale in (1.0, 1 / 3):
        got = replay_fold(p, m, g, 0.05, 0.9, scale)
        want = replay_fold(p.cpu(), m.cpu(), g.cpu(), 0.05, 0.9, scale)
        for a, b in zip(got, want):
            assert a.is_cuda and a.dtype == dtype
            assert torch.equal(a.cpu().view(torch.int16 if dtype ==
                                            torch.bfloat16 else torch.int32),
                               b.view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32))


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_the_card_is_bitwise_the_cpu(gen, dtype):
    """The int8 KV codes and scales divide tensor by tensor, so the card
    computes the CPU's bits (a Python-scalar divisor would multiply by
    its reciprocal there)."""
    from repro_torch.models.layers import quantize_kv
    x = (_rand(gen, (8, 544, 8, 80), torch.float32) * 3.0).to(dtype)
    q, s = quantize_kv(x)
    qc, sc = quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 2560])
def test_rmsnorm_on_decode_rows(gen, dtype, d):
    """The decode step's norms: (b, 1, d) rows, one launch a call."""
    x = _rand(gen, (8, 1, d), dtype)
    w = (1.0 + 0.1 * _rand(gen, (d,), torch.float32)).to(dtype)
    before = LAUNCHES.rmsnorm
    got = registry.rmsnorm(x, w, kernels="auto")
    assert LAUNCHES.rmsnorm == before + 1
    _assert_norm_close(got, rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 64, 128), (2, 1024, 40, 128),
                                   (3, 7, 5, 128), (8, 1, 64, 128)])
def test_rmsnorm_on_qk_norm_rows(gen, dtype, shape):
    """The q/k norms (chameleon-34b, qwen3-moe): (b, l, heads, 128) rows
    normed over the head dim through the registry, in training and on a
    decode step's one position; one launch a call."""
    x = _rand(gen, shape, dtype)
    w = (1.0 + 0.1 * _rand(gen, (shape[-1],), torch.float32)).to(dtype)
    before = LAUNCHES.rmsnorm
    got = registry.rmsnorm(x, w, kernels="auto")
    assert LAUNCHES.rmsnorm == before + 1
    _assert_norm_close(got, rn.rmsnorm_plain(x, w), dtype)


def test_registry_attention_at_the_prefill_shape_is_one_launch(gen):
    """Serving's prefill attention (8 prompts of 512, 32/8 heads of 80,
    causal, window 4096, bf16) through the registry: one kernel launch,
    every element within one bf16 ulp of the plain version (values
    below 2^-8 at its ulp)."""
    q = _rand(gen, (8, 512, 32, 80), torch.bfloat16)
    k = _rand(gen, (8, 512, 8, 80), torch.bfloat16)
    v = _rand(gen, (8, 512, 8, 80), torch.bfloat16)
    before = LAUNCHES.flash_attention_fwd
    with torch.inference_mode():
        out = registry.attention(q, k, v, causal=True, window=4096,
                                 kernels="auto")
    assert LAUNCHES.flash_attention_fwd == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=4096)
    a, b = out.float(), want.float()
    ulp = torch.maximum(_bf16_ulp(a.abs().clamp(min=2.0 ** -8)),
                        _bf16_ulp(b.abs().clamp(min=2.0 ** -8)))
    assert not bool(((a - b).abs() > ulp).any())


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "qwen1.5-32b", "chameleon-34b",
                                  "qwen3-moe-235b-a22b", "deepseek-moe-16b",
                                  "xlstm-125m"])
def test_decoder_with_kernels_matches_plain_formulations(gen, arch):
    """The smoke configs (f32) decoded on the card from one wire, with
    ``kernels='auto'`` (the Hopper kernels) and ``'xla'`` (the plain
    formulations): teacher-forced logits along the plain decoder's
    greedy tokens within 2e-4, and the kernels launched on a KV-cache
    family's prefill and steps (two more norms a layer with q/k
    norms), and on xLSTM's token-by-token steps (its layers' norms and
    the final one, no other kernel).  With an int8 KV cache
    (qwen1.5-32b) a key whose f32 value differs by ulps between the two
    formulations can round to the next code, so the bound there is the
    larger of 2e-4 and how far the int8 cache moves the plain logits
    from an f32 cache's."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry as models
    from repro_torch.ps.sharded.plan import build_shard_plan
    from repro_torch.serve import Decoder
    cfg = get_smoke_config(arch)
    params = models.init_params(cfg, seed=0, device="cuda")
    plan = build_shard_plan(params, 2)
    wire = plan.pack(params)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 12))

    def teacher_forced(cfg, tokens):
        dec = Decoder(cfg, plan, prompt_len=12, max_new=6, max_batch=4,
                      device="cuda")
        p = dec.params(wire.clone())
        last, state = dec.prefill(p, torch.from_numpy(prompts).cuda())
        out = [last]
        for j in range(tokens.shape[1] - 1):
            tok = torch.from_numpy(tokens[:, j:j + 1]).long().cuda()
            last, state = dec.step(p, tok, state, 12 + j)
            out.append(last)
        return torch.stack(out, dim=1)

    plain = dataclasses.replace(cfg, kernels="xla")
    tokens = Decoder(plain, plan, prompt_len=12, max_new=6, max_batch=4,
                     device="cuda").decode(wire.clone(), prompts)
    logits = {}
    for kernels in ("xla", "auto"):
        before = LAUNCHES.snapshot()
        logits[kernels] = teacher_forced(
            dataclasses.replace(cfg, kernels=kernels), tokens)
        launched = LAUNCHES.delta(before)
        if kernels == "xla":
            assert not any(launched.values()), launched
        elif cfg.family == "ssm":
            assert launched == dict(launched, rmsnorm=(cfg.n_layers + 1)
                                    * (12 + 5))
            assert sum(launched.values()) == launched["rmsnorm"]
        elif cfg.family != "hybrid":
            qk = 2 * cfg.n_layers if cfg.qk_norm else 0
            assert launched["flash_attention_fwd"] == cfg.n_layers
            assert launched["residual_rmsnorm"] == cfg.n_layers
            assert launched["rmsnorm"] == \
                cfg.n_layers + 1 + qk + (2 * cfg.n_layers + 1 + qk) * 5
    bound = 2e-4
    if cfg.kv_cache_dtype == "int8":
        f32 = teacher_forced(dataclasses.replace(plain, kv_cache_dtype=""),
                             tokens)
        bound = max(bound, float((logits["xla"] - f32).abs().max()))
    torch.testing.assert_close(logits["auto"], logits["xla"], rtol=bound,
                               atol=bound)


# -------------------------------------------------------------------- xLSTM
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 768), (8, 1, 768),
                                   (3, 5, 768)])
def test_rmsnorm_at_the_xlstm_width(gen, dtype, shape):
    """xlstm-125m's norms, width 768 (96 16-byte bf16 vectors: one warp,
    three a lane): the train step's rows, a decode step's, a ragged
    count; one launch a call through the registry."""
    x = _rand(gen, shape, dtype)
    w = (1.0 + 0.1 * _rand(gen, (shape[-1],), torch.float32)).to(dtype)
    before = LAUNCHES.rmsnorm
    got = registry.rmsnorm(x, w, kernels="auto")
    assert LAUNCHES.rmsnorm == before + 1
    _assert_norm_close(got, rn.rmsnorm_plain(x, w), dtype)


def _slstm_inputs(gen, b, l, heads, hd):
    """The sLSTM loop's inputs (f32 gates with bias, recurrent weights
    scaled as the init scales them) and a cotangent of its output."""
    return (_rand(gen, (b, l, heads, 4 * hd), torch.float32),
            _rand(gen, (heads, hd, 4 * hd), torch.float32) / math.sqrt(hd),
            _rand(gen, (b, l, heads, hd), torch.float32))


@pytest.mark.parametrize("b,l,heads,hd", [(2, 40, 2, 8),
                                          (2, 1024, 4, 192)])  # xlstm-125m
def test_graphed_slstm_loop_is_bitwise_the_eager_loop(gen, b, l, heads, hd):
    """The sLSTM's forward and backward graphs, two calls each with new
    inputs (the first captures), bit for bit the eager loop and autograd
    through it; one graph each."""
    from repro_torch.models import ssm
    fwd = registry.CudaGraphs(ssm.slstm_forward_body)
    bwd = registry.CudaGraphs(ssm.slstm_backward_body)
    for _ in range(2):
        gx, wh, dh = _slstm_inputs(gen, b, l, heads, hd)
        _assert_bitwise(fwd((gx, wh)), (ssm.slstm_loop(gx, wh),))
        _assert_bitwise(bwd((gx, wh, dh), (True, True)),
                        registry._vjp_through(ssm.slstm_loop, (gx, wh),
                                              (dh,), (True, True)))
    assert len(fwd) == len(bwd) == 1
    assert fwd.pool_bytes() > 0 and bwd.pool_bytes() > 0
    fwd.clear()
    bwd.clear()


def test_slstm_function_replays_graphs_and_adds_none_after_the_first(gen):
    """``slstm_time_loop`` on the card: its output and gradients bit for
    bit the eager loop's, one forward and one backward graph, and no
    new graph on later calls of the same signature."""
    from repro_torch.models import ssm
    ssm.SLSTM_FORWARD_GRAPHS.clear()
    ssm.SLSTM_BACKWARD_GRAPHS.clear()
    for _ in range(3):
        gx, wh, dh = _slstm_inputs(gen, 2, 64, 2, 16)
        a = [gx.clone().requires_grad_(), wh.clone().requires_grad_()]
        out = ssm.slstm_time_loop(*a)
        got = torch.autograd.grad(out, a, dh)
        _assert_bitwise((out.detach(),), (ssm.slstm_loop(gx, wh),))
        _assert_bitwise(got, registry._vjp_through(
            ssm.slstm_loop, (gx, wh), (dh,), (True, True)))
        # the backward runs on the autograd engine's device thread
        assert len(ssm.SLSTM_FORWARD_GRAPHS) == 1
        assert len(ssm.SLSTM_BACKWARD_GRAPHS) == 1
    ssm.SLSTM_FORWARD_GRAPHS.clear()
    ssm.SLSTM_BACKWARD_GRAPHS.clear()


def test_graphed_slstm_loop_two_threads_at_once(gen):
    """Two threads running the loop's forward at once get a graph each
    and their own outputs, bit for bit."""
    from repro_torch.models import ssm
    graphs = registry.CudaGraphs(ssm.slstm_forward_body)
    cases = [_slstm_inputs(gen, 2, 96, 2, 16)[:2] for _ in range(2)]
    wants = [(ssm.slstm_loop(*ts),) for ts in cases]
    results, errors = [None, None], []
    start = threading.Barrier(2, timeout=120)

    def run(i):
        try:
            start.wait()
            for _ in range(3):
                got = graphs(cases[i])
            torch.cuda.current_stream().synchronize()
            results[i] = got
        except BaseException as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(graphs) == 2
    for got, want in zip(results, wants):
        _assert_bitwise(got, want)
    graphs.clear()


# ------------------------------------------------------------ SPMD engine
def test_spmd_session_with_kernels_matches_plain_formulations(gen):
    """One SPMD session at smoke size (h2o-danube-1.8b, DSSP, adamw) on
    the card, kernels vs plain formulations: losses within 1e-4, and
    the kernels launched on the kernels' run."""
    from repro_torch import api

    losses = {}
    for kernels in ("auto", "xla"):
        spec = api.RunSpec(
            model=api.ModelSpec(arch="h2o-danube-1.8b", kernels=kernels),
            data=api.DataSpec(seq_len=64, global_batch=4),
            optimizer=api.OptimizerSpec(name="adamw", lr=1e-3),
            sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=4))
        LAUNCHES.reset()
        with api.build_session(spec) as session:
            session.run(6)
            losses[kernels] = session.trainer.log.losses
        launched = LAUNCHES.snapshot()
        if kernels == "auto":
            assert launched["rmsnorm"] > 0
            assert launched["flash_attention_fwd"] > 0
    assert len(losses["auto"]) == 6
    assert max(abs(a - b) for a, b in zip(losses["auto"],
                                          losses["xla"])) <= 1e-4


def test_adamw_update_of_a_bf16_tree_on_the_card_matches_the_cpu(gen):
    """Three adamw updates (staleness 2, damping, weight decay) of a bf16
    tree on the card against the same updates on the CPU: every
    parameter within one bf16 ulp, every moment within 1e-6 of its
    magnitude."""
    from repro_torch import tree as tree_util
    from repro_torch.optim.optimizers import adamw

    shapes = {"v": (4099,), "m": (3, 257, 130), "e": (6000, 64)}
    params = {k: _rand(gen, s, torch.bfloat16) for k, s in shapes.items()}
    grads = [{k: _rand(gen, s, torch.bfloat16) for k, s in shapes.items()}
             for _ in range(3)]
    opt = adamw(1e-2, weight_decay=0.1, staleness_damping=True)
    dev = {k: v.clone() for k, v in params.items()}
    cpu = {k: v.cpu() for k, v in params.items()}
    ds, cs = opt.init(dev), opt.init(cpu)
    for g in grads:
        dev, ds = opt.update(g, ds, dev, staleness=2,
                             lr_scale=torch.tensor(1.0))
        cpu, cs = opt.update({k: v.cpu() for k, v in g.items()}, cs, cpu,
                             staleness=2, lr_scale=torch.tensor(1.0))
    for k in shapes:
        a, b = dev[k].float().cpu(), cpu[k].float()
        assert torch.all((a - b).abs() <= b.abs() * 2.0 ** -7 + 1e-30), k
    assert int(ds.count) == int(cs.count) == 3
    for a, b in zip(tree_util.leaves(ds.mu) + tree_util.leaves(ds.nu),
                    tree_util.leaves(cs.mu) + tree_util.leaves(cs.nu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------ device mesh
def test_one_rank_nccl_mesh_step_matches_the_rules_free_step(gen):
    """The ``spmd`` session with mesh rules on a one-rank NCCL mesh
    (1, 1) at smoke size (h2o-danube-1.8b, f32, momentum, DSSP): losses
    within 1e-5 of the rules-free session, the same norm launches, no
    flash attention (the mesh formulation), no collective and no block
    copy."""
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.launch.mesh import make_mesh, start_group
    from repro_torch.models.sharding import rules_for_mesh
    from repro_torch.perfcount import MESH

    spec = api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b"),
        data=api.DataSpec(seq_len=64, global_batch=4),
        optimizer=api.OptimizerSpec(name="momentum", lr=1e-3),
        sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=3))
    start_group(backend="nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs = {}
        for name, rules in (("plain", None),
                            ("mesh", rules_for_mesh(mesh, sp=True,
                                                    role="tp"))):
            LAUNCHES.reset()
            MESH.reset()
            with api.build_session(spec, rules=rules) as session:
                session.run(4)
                runs[name] = (session.trainer.log.losses,
                              LAUNCHES.snapshot(), MESH.snapshot())
    finally:
        dist.destroy_process_group()
    (lp, kp, _), (lm, km, traffic) = runs["plain"], runs["mesh"]
    assert max(abs(a - b) for a, b in zip(lp, lm)) <= 1e-5
    assert kp["flash_attention_fwd"] > 0 and km["flash_attention_fwd"] == 0
    for op in ("rmsnorm", "residual_rmsnorm"):
        assert km[op] == kp[op] > 0
    assert not any(traffic.values()), traffic


def test_cross_pod_sync_of_cuda_tensors_is_the_mean_bit_for_bit(gen,
                                                               tmp_path):
    """``cross_pod_sync`` over two ranks sharing the card (gloo, CUDA
    tensors, a (2, 1, 1) pod mesh): each pod's block becomes
    (a + b) / 2 bit for bit."""
    import numpy as np

    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import run_ranks

    x = np.random.RandomState(5).randn(2, 64, 33).astype(np.float32)
    outs = run_ranks(ranks.cross_pod_cuda_ranks, 2, str(tmp_path),
                     args=(x,), timeout=120.0)
    want = (x[0] + x[1]) / np.float32(2)
    for out in outs:
        assert out["device"] == "cuda"
        assert out["synced"].tobytes() == want.tobytes()
