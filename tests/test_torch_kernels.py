"""repro_torch kernels on the CPU: each plain version against the
reference package's oracle (``repro.kernels.ref``) AND its Pallas kernel
run in interpret mode, the backward of each kernel op against
``jax.vjp`` of the oracle, and the dispatch rules.

The Hopper kernels themselves run only on the card (tests marked
``cuda`` and ``chip_smoke.py``); here every wrapper takes its plain
version because its tensors lie on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.kernels.fused_update import fused_update as jax_fused_update
from repro.kernels.residual_rmsnorm import residual_rmsnorm as jax_rrn
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import interface, registry
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_rmsnorm as rrn
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.interface import KernelType
from repro_torch.perfcount import LAUNCHES

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jax array and a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype: str) -> float:
    # f32: summation order only.  bf16: one rounding of the output
    # (bf16 eps is 7.8e-3; compared in f32 like the reference's tests).
    return 1e-5 if dtype == "float32" else 2e-2


# ----------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 256), (2, 16, 512), (8, 3, 128)])
def test_rmsnorm_plain_matches_oracle_and_interpret_kernel(dtype, shape):
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng.randn(*shape).astype(np.float32), dtype)
    jw, tw = _pair(rng.randn(shape[-1]).astype(np.float32), dtype)
    out = rn.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = _tol(dtype)
    for expected in (jref.rmsnorm_ref(jx, jw),
                     jax_rmsnorm(jx, jw, interpret=True)):
        np.testing.assert_allclose(_np(out), _np(expected), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 256), (2, 16, 512)])
def test_residual_rmsnorm_plain_matches_oracle_and_interpret_kernel(
        dtype, shape):
    rng = np.random.RandomState(1)
    jx, tx = _pair(rng.randn(*shape).astype(np.float32), dtype)
    jr, tr = _pair(rng.randn(*shape).astype(np.float32), dtype)
    jw, tw = _pair(rng.randn(shape[-1]).astype(np.float32), dtype)
    s, normed = rrn.residual_rmsnorm(tx, tr, tw)
    tol = _tol(dtype)
    for es, en in (jref.residual_rmsnorm_ref(jx, jr, jw),
                   jax_rrn(jx, jr, jw, interpret=True)):
        np.testing.assert_array_equal(_np(s), _np(es))   # one rounding
        np.testing.assert_allclose(_np(normed), _np(en), rtol=tol, atol=tol)


def _register_path_layout(d: int, itemsize: int):
    """(W warps a row, NV 16-byte vectors a lane) that
    csrc/residual_rmsnorm.cu's register path takes for a row of d."""
    n_vec = d // (16 // itemsize)
    w = 1
    while -(-n_vec // (32 * w)) > 10:
        w *= 2
    need = -(-n_vec // (32 * w))
    return w, next(nv for nv in (1, 2, 4, 8, 10) if nv >= need)


def _register_path_residual_rmsnorm(x, res, weight, eps=1e-6):
    """residual_rmsnorm in the register path's order: s = x + res in f32;
    each lane's sum of squares over its vectors i (v = 32 W i + 32 w + l)
    and their elements in order, by FMA; a butterfly over the 32 lanes;
    the W warp sums in order; 1 / sqrt(sum / d + eps); (s * inv) * w."""
    rows, d = x.shape
    n = 16 // x.element_size()
    w_, nv = _register_path_layout(d, x.element_size())
    s = x.float() + res.float()
    pad = torch.zeros(rows, nv * 32 * w_ * n)
    pad[:, :d] = s
    lanes = pad.view(rows, nv, w_, 32, n).permute(0, 2, 3, 1, 4).reshape(
        rows, w_, 32, nv * n)
    ss = torch.zeros(rows, w_, 32)
    for c in range(nv * n):
        v = lanes[..., c]
        ss = (v.double() * v.double() + ss.double()).float()
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[..., idx ^ o]
    tot = torch.zeros(rows)
    for j in range(w_):
        tot = tot + ss[:, j, 0]
    inv = 1.0 / torch.sqrt(tot / d + eps)
    out = (s * inv[:, None]) * weight.float()
    return s.to(x.dtype), out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2560, 4096])
def test_residual_rmsnorm_register_path_order_matches_oracle(dtype, d):
    """The register path's reduction order (lane partials by FMA, the
    warp butterfly, the warps in order), emulated here, holds to the
    reference's oracle run through JAX at the kernel's card tolerance:
    rtol = atol = 1e-5 in f32, one bf16 ulp in bf16; s bit for bit."""
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng.randn(6, d).astype(np.float32), dtype)
    jr, tr = _pair(rng.randn(6, d).astype(np.float32), dtype)
    jw, tw = _pair((1.0 + 0.1 * rng.randn(d)).astype(np.float32), dtype)
    es, en = (_np(v) for v in jref.residual_rmsnorm_ref(jx, jr, jw))
    s, out = (_np(v) for v in _register_path_residual_rmsnorm(tx, tr, tw))
    np.testing.assert_array_equal(s, es)
    if dtype == "float32":
        np.testing.assert_allclose(out, en, rtol=1e-5, atol=1e-5)
    else:
        mag = np.maximum(np.abs(en), 2.0 ** -126)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert (np.abs(out - en) <= ulp).all()


# ----------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d", [
    (2, 128, 128, 4, 2, 32),      # GQA, square
    (1, 64, 192, 4, 1, 80),       # MQA, lq < lk, head dim 80
])
def test_flash_plain_matches_oracle_and_interpret_kernel(
        dtype, causal, window, b, lq, lk, hq, hkv, d):
    rng = np.random.RandomState(2)
    jq, tq = _pair(rng.randn(b, lq, hq, d).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(b, lk, hkv, d).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(b, lk, hkv, d).astype(np.float32), dtype)
    out = fa.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for expected in (
            jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window),
            jax_flash(jq, jk, jv, causal=causal, window=window,
                      block_q=64, block_k=64, interpret=True)):
        np.testing.assert_allclose(_np(out), _np(expected), rtol=tol,
                                   atol=tol)


def test_flash_plain_ragged_length_matches_oracle():
    """Lengths no Pallas block divides: the reference falls back to its
    oracle; the port's kernel (and so its plain version) takes them."""
    rng = np.random.RandomState(3)
    jq, tq = _pair(rng.randn(2, 37, 4, 16).astype(np.float32), "float32")
    jk, tk = _pair(rng.randn(2, 53, 2, 16).astype(np.float32), "float32")
    jv, tv = _pair(rng.randn(2, 53, 2, 16).astype(np.float32), "float32")
    out = fa.flash_attention_fwd(tq, tk, tv, causal=True, window=9)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=9)),
        rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- fused update
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4096,), (17, 129), (16, 512)])
def test_fused_update_plain_bitwise_oracle_and_1ulp_interpret(dtype, shape):
    """Bitwise against the (eager, uncontracted) oracle.  The reference's
    Pallas kernel in interpret mode runs through XLA on the CPU, which
    contracts m' = fma(beta, m, scale*g) and p' = fma(-lr, m', p): the
    two roundings differ by at most 1 ulp (of the storage dtype) of the
    operands' magnitude — not of the result's, which can be far smaller
    after cancellation."""
    rng = np.random.RandomState(4)
    jp, tp = _pair(rng.randn(*shape).astype(np.float32), dtype)
    jm, tm = _pair(rng.randn(*shape).astype(np.float32), dtype)
    jg, tg = _pair(rng.randn(*shape).astype(np.float32), dtype)
    kw = dict(lr=0.1, beta=0.9, scale=0.5)
    po, mo = fu.fused_update(tp, tm, tg, **kw)
    assert po.data_ptr() != tp.data_ptr() and mo.data_ptr() != tm.data_ptr()
    pe, me = jref.fused_update_ref(jp, jm, jg, **kw)
    np.testing.assert_array_equal(_np(po), _np(pe))
    np.testing.assert_array_equal(_np(mo), _np(me))
    pk, mk = jax_fused_update(jp, jm, jg, interpret=True, **kw)
    operands = np.maximum.reduce([np.abs(_np(t)) for t in (tp, tm, tg, po, mo)])
    if dtype == "float32":
        ulp = np.spacing(operands)
    else:   # one bf16 ulp: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(operands, 2.0 ** -126)))
                      - 7)
    for ours, theirs in ((po, pk), (mo, mk)):
        assert np.all(np.abs(_np(ours) - _np(theirs)) <= ulp)


def test_plain_versions_are_the_oracles():
    assert fu.fused_update_plain is tref.fused_update_ref
    assert rn.rmsnorm_plain is tref.rmsnorm_ref
    assert rrn.residual_rmsnorm_plain is tref.residual_rmsnorm_ref
    assert fa.flash_attention_plain is tref.flash_attention_ref


# ----------------------------------------------------------------- backward
def _jax_vjp(fn, inputs, cot):
    _, vjp = jax.vjp(fn, *inputs)
    return vjp(cot)


def _torch_grads(fn, inputs, cot):
    xs = [x.clone().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    return torch.autograd.grad(outs, xs, cots)


@pytest.mark.parametrize("kernels", ["pallas", "xla"])
def test_backward_matches_jax_vjp_of_oracle(kernels):
    """The kernel ops' autograd.Function backward (``pallas``) and native
    autograd through the plain formulation (``xla``) both match
    ``jax.vjp`` of the reference oracle."""
    rng = np.random.RandomState(5)

    def arr(*shape):
        a = rng.randn(*shape).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    (jq, tq), (jk, tk), (jv, tv) = arr(1, 64, 4, 16), arr(1, 64, 2, 16), \
        arr(1, 64, 2, 16)
    (jd, td) = arr(1, 64, 4, 16)
    g_j = _jax_vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=24), (jq, jk, jv), jd)
    g_t = _torch_grads(lambda q, k, v: registry.attention(
        q, k, v, causal=True, window=24, kernels=kernels), (tq, tk, tv), td)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)

    (jx, tx), (jr, tr), (jw, tw) = arr(3, 5, 32), arr(3, 5, 32), arr(32)
    (jdo, tdo), (jds, tds) = arr(3, 5, 32), arr(3, 5, 32)
    g_j = _jax_vjp(lambda x, w: jref.rmsnorm_ref(x, w), (jx, jw), jdo)
    g_t = _torch_grads(lambda x, w: registry.rmsnorm(x, w, kernels=kernels),
                       (tx, tw), tdo)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)

    g_j = _jax_vjp(lambda x, r, w: jref.residual_rmsnorm_ref(x, r, w),
                   (jx, jr, jw), (jds, jdo))
    g_t = _torch_grads(lambda x, r, w: registry.residual_rmsnorm(
        x, r, w, kernels=kernels), (tx, tr, tw), (tds, tdo))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- dispatch
def test_auto_resolves_by_device():
    cpu = torch.zeros(2, 4)
    for op in ("attention", "rmsnorm", "residual_rmsnorm"):
        assert registry.resolved(op, "auto", cpu) is KernelType.PLAIN
        assert registry.resolved(op, "pallas", cpu) is KernelType.KERNEL
        assert interface.resolve("auto", op, cuda=True) is KernelType.KERNEL
        assert interface.resolve("xla", op, cuda=True) is KernelType.PLAIN
    assert interface.resolve("auto", "ssm_scan", cuda=False) \
        is KernelType.PLAIN_ASSOCIATIVE
    assert interface.resolve("attention=xla", "attention", cuda=True) \
        is KernelType.PLAIN


def test_grammar_matches_reference():
    from repro.kernels import interface as jinterface
    for spec in ("auto", "pallas", "xla", "xla,ssm_scan=pallas",
                 "attention=pallas,ssm_scan=xla_associative"):
        assert interface.parse_kernels(spec) == jinterface.parse_kernels(spec)
    for bad in ("", "cuda", "xla_associative", "attention=xla_associative",
                "nope=xla", "xla,,"):
        with pytest.raises(ValueError):
            interface.parse_kernels(bad)
        with pytest.raises(ValueError):
            jinterface.parse_kernels(bad)


def test_cpu_wrappers_take_plain_and_launch_nothing():
    LAUNCHES.reset()
    x = torch.randn(2, 8, 16)
    w = torch.ones(16)
    rn.rmsnorm(x, w)
    rrn.residual_rmsnorm(x, x, w)
    fa.flash_attention_fwd(x.view(2, 8, 2, 8), x.view(2, 8, 2, 8),
                           x.view(2, 8, 2, 8))
    fu.fused_update(x, x, x, lr=0.1)
    assert all(v == 0 for v in LAUNCHES.snapshot().values())


def test_wrappers_raise_on_a_tensor_they_cannot_launch_on():
    """Off the CPU a wrapper launches its kernel or raises — a tensor on
    a device that is not CUDA (here ``meta``) never falls back."""
    x = torch.empty(2, 8, 16, device="meta")
    w = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        rrn.residual_rmsnorm(x, x, w)
    with pytest.raises(ValueError, match="CUDA"):
        fu.fused_update(x, x, x, lr=0.1)
    q = torch.empty(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q)
