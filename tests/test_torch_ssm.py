"""repro_torch's selective scan and Mamba block against the reference's.

Inputs are made with numpy from a seed and handed to both packages.  The
reference's Pallas ``ssm_scan`` does not run on the installed jax
(``pallas.load`` is gone), so the port is held against the reference's
sequential oracle ``ref.ssm_scan_ref`` and its chunked associative
formulation, as the reference's own parity test would hold its kernel.

Tolerances, and why:
  f32     |port - reference| <= 1e-6 * max(1, max|reference|) + 1e-5 *
          |reference|: the two ``exp`` implementations (torch's on the
          CPU, XLA's) may differ by an ulp and the ``C . h`` sums run in
          another order; exp(delta * A) < 1 damps what has accumulated,
          so the error stays at a few ulps of the largest output.
  bf16    y is stored in bf16 from f32 values that differ by an ulp of
          f32, which can round to the neighbouring bf16 value: one bf16
          ulp, rtol 2**-7.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.kernels import registry as jreg
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry as treg
from repro_torch.models import ssm
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(2)

SHAPES = [(2, 64, 4, 8), (2, 96, 48, 16)]      # (b, l, di, ds)


def _inputs(b, l, di, ds, *, h0_nonzero: bool, seed: int = 0):
    r = np.random.RandomState(seed)
    softplus = lambda x: np.log1p(np.exp(x))
    u = r.randn(b, l, di)
    delta = softplus(r.randn(b, l, di))
    a = -softplus(r.randn(di, ds))
    bmat, cmat = r.randn(b, l, ds), r.randn(b, l, ds)
    h0 = r.randn(b, di, ds) if h0_nonzero else np.zeros((b, di, ds))
    return [x.astype(np.float32) for x in (u, delta, a, bmat, cmat, h0)]


def _both(xs, dtype: str):
    """The same inputs for both packages: u, delta, B, C in ``dtype``
    (rounded once, by JAX), a and h0 in f32."""
    jx = [jnp.asarray(x).astype(dtype) if i in (0, 1, 3, 4)
          else jnp.asarray(x) for i, x in enumerate(xs)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype) if i in (0, 1, 3, 4) else torch.float32)
        for i, x in enumerate(jx)]
    return jx, tx


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    if dtype == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6)
    else:
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("h0_nonzero", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sequential_oracle_matches_reference(shape, dtype, h0_nonzero):
    jx, tx = _both(_inputs(*shape, h0_nonzero=h0_nonzero), dtype)
    yj, hj = jref.ssm_scan_ref(*jx)
    yt, ht = tref.ssm_scan_ref(*tx)
    assert yt.dtype == getattr(torch, dtype) and ht.dtype == torch.float32
    _close(yt, yj, dtype)
    _close(ht, hj)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once (through f64: the product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _tree_sum_states(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (ds) in the Hopper kernel's order: states
    s and s ^ (ds/2) first (one lane's pair), then those pairs' sums by s
    ^ (ds/4) (the first shuffle round), and so on down to s ^ 1."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def _kernel_order_scan(u, delta, a, bmat, cmat, h0):
    """The selective scan in csrc/ssm_scan.cu's arithmetic: expf of the
    rounded delta * A, (delta * B) * u with each product rounded, h by
    one FMA, h * C rounded, and the sum over the states in the kernel's
    tree.  All f32 tensors; returns (y, h_last)."""
    h = h0.clone()
    ys = []
    for ut, dt, bt, ct in zip(u.unbind(1), delta.unbind(1), bmat.unbind(1),
                              cmat.unbind(1)):
        da = torch.exp(dt[..., None] * a[None])             # (b, di, ds)
        bb = (dt[..., None] * bt[:, None, :]) * ut[..., None]
        h = _fma(da, h, bb)
        ys.append(_tree_sum_states(h * ct[:, None, :]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("shape", [(2, 512, 64, 16), (1, 4096, 32, 8)])
def test_kernel_arithmetic_order_matches_reference(shape):
    """The Hopper kernel's order of operations (contracted h update, the
    tree sum over the states), emulated here, holds to the reference's
    sequential oracle run through JAX, at the kernel's tolerance on the
    card: 1e-5 of the largest output for y and h_last."""
    xs = _inputs(*shape, h0_nonzero=True)
    yj, hj = (np.asarray(x) for x in jref.ssm_scan_ref(
        *(jnp.asarray(x) for x in xs)))
    yt, ht = _kernel_order_scan(*(torch.from_numpy(x) for x in xs))
    for got, want in ((yt.numpy(), yj), (ht.numpy(), hj)):
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("chunk", [16, 64, 7])    # 7: forced to l
@pytest.mark.parametrize("shape", SHAPES)
def test_associative_variant_matches_reference(shape, chunk):
    jx, tx = _both(_inputs(*shape, h0_nonzero=True, seed=1), "float32")
    spec = "ssm_scan=xla_associative"
    yj, hj = jreg.ssm_scan(*jx, chunk=chunk, kernels=spec)
    yt, ht = treg.ssm_scan(*tx, chunk=chunk, kernels=spec)
    _close(yt, yj)
    _close(ht, hj)
    # and the port's two plain formulations agree with each other
    ys, hs = tref.ssm_scan_ref(*tx)
    np.testing.assert_allclose(yt.numpy(), ys.numpy(), rtol=1e-5,
                               atol=1e-6 * max(1.0, float(ys.abs().max())))
    np.testing.assert_allclose(ht.numpy(), hs.numpy(), rtol=1e-5, atol=1e-6)


def _sq(out):
    return sum((o.float() ** 2).sum() for o in out)


@pytest.mark.parametrize("variant", ["pallas", "xla", "xla_associative"])
def test_gradients_match_jax_grad_of_the_oracle(variant):
    """``pallas`` on the CPU runs ``_SSMScan`` (its forward takes the plain
    version; its backward recomputes through the oracle), the others
    native autograd; all against ``jax.grad`` of the reference oracle."""
    xs = _inputs(2, 48, 8, 16, h0_nonzero=True, seed=2)
    jx, tx = _both(xs, "float32")
    gj = jax.grad(lambda *a: sum(jnp.sum(jnp.square(o)) for o in
                                 jref.ssm_scan_ref(*a)),
                  argnums=(0, 1, 2, 3, 4, 5))(*jx)
    tx = [t.requires_grad_() for t in tx]
    out = treg.ssm_scan(*tx, chunk=16, kernels=f"ssm_scan={variant}")
    gt = torch.autograd.grad(_sq(out), tx)
    for g, w in zip(gt, gj):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-6 * scale)


@pytest.mark.parametrize("needs", [
    (True,) * 6,
    (True, True, True, True, True, False),     # h0 zeros, as in the model
    (False, True, False, False, True, False),
])
def test_scan_backward_body_is_the_eager_vjp(needs):
    """``registry.scan_backward_body`` (what the card captures as a CUDA
    graph) run eagerly: bitwise ``_vjp_through`` of the oracle, and the
    reference's ``jax.vjp`` of its oracle within the gradient tolerance
    above (rtol 1e-4, atol 2e-6 of the largest gradient)."""
    xs = _inputs(2, 48, 8, 16, h0_nonzero=True, seed=4)
    jx, tx = _both(xs, "float32")
    r = np.random.RandomState(5)
    dy = r.randn(2, 48, 8).astype(np.float32)
    dh = r.randn(2, 8, 16).astype(np.float32)
    douts = (torch.from_numpy(dy), torch.from_numpy(dh))
    got = treg.scan_backward_body((*tx, *douts), needs)
    want = treg._vjp_through(tref.ssm_scan_ref, tx, douts, needs)
    _, vjp = jax.vjp(jref.ssm_scan_ref, *jx)
    gj = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    assert len(got) == 6
    for g, w, j, n in zip(got, want, gj, needs):
        assert (g is None) == (not n) and (w is None) == (not n)
        if not n:
            continue
        assert torch.equal(g, w)
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=2e-6 * scale)


def test_cpu_backward_runs_eagerly_without_a_graph():
    """On the CPU ``_SSMScan.backward`` is the eager body: the same
    gradients bit for bit, and no graph is captured."""
    xs = _inputs(2, 40, 8, 16, h0_nonzero=False, seed=6)
    _, tx = _both(xs, "float32")
    tx = [t.requires_grad_(i != 5) for i, t in enumerate(tx)]
    before = len(treg.SCAN_BACKWARD_GRAPHS)
    y, h = treg.ssm_scan(*tx, chunk=8, kernels="ssm_scan=pallas")
    dy, dh = torch.ones_like(y), torch.full_like(h, 0.5)
    got = torch.autograd.grad((y, h), tx[:5], (dy, dh))
    want = treg.scan_backward_body(
        (*(t.detach() for t in tx), dy, dh), (True,) * 5 + (False,))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(treg.SCAN_BACKWARD_GRAPHS) == before


def test_chunk_is_clamped_as_the_reference_clamps_it():
    xs = _inputs(1, 12, 4, 8, h0_nonzero=True, seed=3)
    _, tx = _both(xs, "float32")
    want = tref.ssm_scan_ref(*tx)
    for chunk in (0, 5, 12, 100):       # <= 0 and non-divisors -> l
        got = treg.ssm_scan(*tx, chunk=chunk,
                            kernels="ssm_scan=xla_associative")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("kernels", ["xla", "auto", "pallas"])
def test_mamba_block_matches_reference(kernels):
    """The Jamba smoke config's first slot (a Mamba mixer) on the
    reference's initial weights; the reference with its sequential
    oracle.  The block's projections and conv add f32 roundings on both
    sides in the same order: 1e-5."""
    jcfg = dataclasses.replace(jax_smoke("jamba-v0.1-52b"), kernels="xla")
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    jw = jax.tree_util.tree_map(lambda x: x[0], params["slots"][0]["mamba"])
    x = np.random.RandomState(4).randn(2, 24, jcfg.d_model) \
        .astype(np.float32)
    want = np.asarray(jssm.mamba_block(jcfg, jnp.asarray(x), jw))
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              kernels=kernels, mamba_chunk=8)
    got = ssm.mamba_block(cfg, torch.from_numpy(x), from_numpy_tree(jw, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
