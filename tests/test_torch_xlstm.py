"""repro_torch's xLSTM blocks and decode steps against the reference's,
on the CPU: ``mlstm_block`` and ``slstm_block`` (outputs and every
gradient, f32 and bf16), ``mlstm_decode``, ``slstm_decode`` and
``xlstm_decode`` over several steps, the decode state's layout, and the
sLSTM time loop's autograd ``Function`` against autograd through the
eager loop.

Weights are the reference's ``registry.init_params`` of the xlstm-125m
smoke config (d_model 64, 2 heads of 32), one layer sliced out, with the
zero-initialised biases replaced by random ones so the bias path is
exercised; inputs come from ``np.random.RandomState`` with the seed each
test states.  The reference runs as its own tests run it (jitted, on the
CPU).

Tolerances: f32 outputs and gradients 1e-5 of the largest magnitude
(measured: below 2e-6); bf16 block outputs 2 bf16 ulps of the largest
magnitude, since one ulp of a projection's rounding propagates; decode
logits and states 2e-4 / 1e-5 as ``tests/test_torch_serve.py``'s.  The
``Function``'s backward recomputes through the same eager loop, so it
is held bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import registry as kreg
from repro_torch.models import ssm
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(2)

ARCH = "xlstm-125m"
TOL = 1e-5
LOGIT_TOL = 2e-4
STATE_TOL = 1e-5


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


def _layer(kind, dtype="float32", seed=0):
    """One layer's weights of ``kind`` (JAX tree, torch tree), biases
    random."""
    jcfg, _ = _cfgs(dtype)
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    jw = {}
    for name, leaf in params[kind].items():
        x = np.asarray(leaf[0], np.float32)
        if name in ("b_if", "bias"):
            x = rng.randn(*x.shape).astype(np.float32) * 0.5
        jw[name] = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tw = from_numpy_tree(jw, "cpu", dtype=getattr(torch, dtype))
    return jw, tw


def _x(seed, shape, dtype="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, dtype=jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _assert_scaled(got, want, tol, what):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max |err| {err} (scale {scale})"


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_output_and_gradients_match_reference(kind):
    jcfg, cfg = _cfgs()
    jw, tw = _layer(kind)
    jx, tx = _x(1, (2, 24, cfg.d_model))
    cot = np.random.RandomState(2).randn(2, 24, cfg.d_model).astype(
        np.float32)
    jblk = jssm.mlstm_block if kind == "mlstm" else jssm.slstm_block
    blk = ssm.mlstm_block if kind == "mlstm" else ssm.slstm_block

    jout, vjp = jax.vjp(lambda x, w: jblk(jcfg, x, w), jx, jw)
    jgx, jgw = vjp(jnp.asarray(cot))
    tx.requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tw.items()}
    out = blk(cfg, tx, leaves)
    grads = torch.autograd.grad(out, [tx, *leaves.values()],
                                torch.from_numpy(cot))
    _assert_scaled(out, jout, TOL, f"{kind} output")
    _assert_scaled(grads[0], jgx, TOL, f"{kind} d x")
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _assert_scaled(g, jgw[name], TOL, f"{kind} d {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_block_keeps_the_reference_casts(kind):
    """bf16 storage: the sLSTM adds its bias in bf16 before the f32 cast,
    the mLSTM divides k by sqrt(hd) in bf16 and rounds the scores to
    bf16 before ``P·V``."""
    jcfg, cfg = _cfgs("bfloat16")
    jw, tw = _layer(kind, "bfloat16")
    jx, tx = _x(3, (2, 24, cfg.d_model), "bfloat16")
    jblk = jssm.mlstm_block if kind == "mlstm" else jssm.slstm_block
    blk = ssm.mlstm_block if kind == "mlstm" else ssm.slstm_block
    want = jblk(jcfg, jx, jw)
    got = blk(cfg, tx, tw)
    assert got.dtype == torch.bfloat16
    _assert_scaled(got, want.astype(jnp.float32), 2 * 2.0 ** -8,
                   f"bf16 {kind} output")


def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches_reference_over_steps(kind):
    jcfg, cfg = _cfgs()
    jw, tw = _layer(kind)
    full = jssm.xlstm_init_state(jcfg, 3)
    jstate = jax.tree_util.tree_map(lambda v: v[0], full[kind])
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in
              jstate.items()}
    jstep = jssm.mlstm_decode if kind == "mlstm" else jssm.slstm_decode
    step = ssm.mlstm_decode if kind == "mlstm" else ssm.slstm_decode
    for t in range(6):
        jx, tx = _x(10 + t, (3, 1, cfg.d_model))
        jout, jstate = jstep(jcfg, jx, jw, jstate)
        out, tstate = step(cfg, tx, tw, tstate)
        _assert_scaled(out, jout, TOL, f"{kind} step {t} output")
        assert sorted(tstate) == sorted(jstate)
        for name, v in _state_np(jstate).items():
            _assert_scaled(tstate[name], v, STATE_TOL,
                           f"{kind} step {t} state {name}")


def test_init_state_is_the_reference_state():
    jcfg, cfg = _cfgs()
    want = jssm.xlstm_init_state(jcfg, 2)
    got = ssm.xlstm_init_state(cfg, 2, 99)
    assert sorted(got) == sorted(want) == ["mlstm", "slstm"]
    for kind in want:
        assert sorted(got[kind]) == sorted(want[kind])
        for name, v in want[kind].items():
            assert got[kind][name].dtype == torch.float32
            np.testing.assert_array_equal(got[kind][name].numpy(),
                                          np.asarray(v))


def test_xlstm_decode_matches_reference_and_updates_state_in_place():
    jcfg, cfg = _cfgs()
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_numpy_tree(jparams, "cpu")
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 8))
    jstate = jssm.xlstm_init_state(jcfg, 2)
    state = ssm.xlstm_init_state(cfg, 2, 8)
    c_mem = state["mlstm"]["C"]
    for i in range(toks.shape[1]):
        jlogits, jstate = jssm.xlstm_decode(
            jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jstate,
            jnp.int32(i))
        with torch.inference_mode():
            logits, state = ssm.xlstm_decode(
                cfg, params, torch.from_numpy(toks[:, i:i + 1]).long(),
                state, i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert state["mlstm"]["C"] is c_mem
    for kind in jstate:
        for name, v in jstate[kind].items():
            _assert_scaled(state[kind][name], np.asarray(v), STATE_TOL,
                           f"{kind} {name}")


def _decode_gaps(pkg_forward, pkg_decode, pkg_init, cfg, params, toks):
    """Per position, max |decode logits - forward logits|."""
    full = np.asarray(pkg_forward(cfg, params, toks)[0])
    state = pkg_init(cfg, toks.shape[0])
    gaps = []
    for i in range(toks.shape[1]):
        logits, state = pkg_decode(cfg, params, toks[:, i:i + 1], state, i)
        gaps.append(float(np.max(np.abs(np.asarray(logits)[:, 0]
                                        - full[:, i]))))
    return np.array(gaps)


@pytest.mark.parametrize("layer", ["slstm", "mlstm"])
def test_recurrent_decode_against_the_parallel_forward(layer):
    """One layer, token by token through ``xlstm_decode`` against the
    training forward at every position.  The sLSTM's cell and loop agree.
    The reference's mLSTM does not: its parallel form divides the scores
    by sqrt(hd) a second time (``ssm.py:79``), its recurrence does not,
    so the two normalisers differ wherever ``|q·k|/sqrt(hd)`` is below
    ``exp(-m)``.  The port keeps that quirk: its gaps are the
    reference's."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=1, slstm_layers=(
        (0,) if layer == "slstm" else ())) for c in _cfgs())
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_numpy_tree(jparams, "cpu")
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
    want = _decode_gaps(
        jssm.xlstm_forward,
        lambda c, p, t, s, i: jssm.xlstm_decode(c, p, t, s, jnp.int32(i)),
        jssm.xlstm_init_state, jcfg, jparams, jnp.asarray(toks))
    with torch.inference_mode():
        got = _decode_gaps(ssm.xlstm_forward, ssm.xlstm_decode,
                           ssm.xlstm_init_state, cfg, params,
                           torch.from_numpy(toks).long())
    if layer == "slstm":
        assert got.max() <= LOGIT_TOL and want.max() <= LOGIT_TOL
    else:
        assert want.max() > 0.5          # the reference's own gap
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _loop_inputs(seed, b=2, l=20, heads=2, hd=8):
    rng = np.random.RandomState(seed)
    gx = torch.from_numpy(rng.randn(b, l, heads, 4 * hd).astype(np.float32))
    wh = torch.from_numpy((rng.randn(heads, hd, 4 * hd)
                           / np.sqrt(hd)).astype(np.float32))
    dh = torch.from_numpy(rng.randn(b, l, heads, hd).astype(np.float32))
    return gx, wh, dh


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_slstm_function_backward_is_autograd_through_the_eager_loop(needs):
    gx, wh, dh = _loop_inputs(6)
    a = [t.clone().requires_grad_(n) for t, n in zip((gx, wh), needs)]
    out = ssm.slstm_time_loop(*a)
    got = torch.autograd.grad(out, [t for t in a if t.requires_grad], dh)
    b = [t.clone().requires_grad_(n) for t, n in zip((gx, wh), needs)]
    ref = ssm.slstm_loop(*b)
    want = torch.autograd.grad(ref, [t for t in b if t.requires_grad], dh)
    assert torch.equal(out.detach(), ref.detach())
    assert len(got) == len(want) == sum(needs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    body = ssm.slstm_backward_body((gx, wh, dh), needs)
    assert [g is None for g in body] == [not n for n in needs]
    for g, w in zip([g for g in body if g is not None], want):
        assert torch.equal(g, w)


def test_slstm_loop_ties_split_the_gradient_as_the_reference():
    """At t = 0 the argmax input gate gives n = 1 exactly, a tie with the
    normaliser's floor of 1; the reference's ``maximum`` splits the
    gradient there, and so does the port's."""
    gx, wh, dh = _loop_inputs(7, l=3)
    jgx, jwh = jnp.asarray(gx.numpy()), jnp.asarray(wh.numpy())

    def jloop(g, w):
        b, _, heads, g4 = g.shape
        zeros = jnp.zeros((b, heads, g4 // 4), jnp.float32)
        m0 = jnp.full((b, heads), -1e30, jnp.float32)

        def step(carry, gx_t):
            rec = jnp.einsum("bhk,hkg->bhg", carry[2], w)
            new = jssm._slstm_cell(carry, gx_t + rec, g4 // 4)
            return new, new[2]

        _, hs = jax.lax.scan(step, (zeros, zeros, zeros, m0),
                             g.transpose(1, 0, 2, 3))
        return hs.transpose(1, 0, 2, 3)

    _, vjp = jax.vjp(jloop, jgx, jwh)
    jg = vjp(jnp.asarray(dh.numpy()))
    a = [gx.clone().requires_grad_(), wh.clone().requires_grad_()]
    got = torch.autograd.grad(ssm.slstm_time_loop(*a), a, dh)
    for g, w in zip(got, jg):
        _assert_scaled(g, np.asarray(w), TOL, "loop gradient")


def test_graph_cache_keeps_a_graph_a_live_thread_and_hands_on_finished_ones(
        monkeypatch):
    """``CudaGraphs``' bookkeeping (the capture itself needs the card, so
    a stand-in records it): one graph per signature and live thread; a
    thread that has finished leaves its graph to the next thread of that
    signature, so new worker threads of later sessions capture nothing;
    two threads alive at once never share one."""
    captures = []

    class Recorded:
        def __init__(self, body, tensors, needs):
            captures.append((threading.current_thread().name,
                             tuple(t.shape for t in tensors)))

        def __call__(self, tensors):
            return (tensors[0],)

    monkeypatch.setattr(kreg, "_GraphedCall", Recorded)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    graphs = kreg.CudaGraphs(lambda ts, needs: ts)
    a, b = torch.zeros(3), torch.zeros(4)

    def in_thread(name, *calls, barrier=None):
        def run():
            if barrier is not None:
                barrier.wait(timeout=60)
            for t in calls:
                graphs((t,))
            if barrier is not None:        # both alive through both calls
                barrier.wait(timeout=60)
        th = threading.Thread(target=run, name=name)
        th.start()
        return th

    graphs((a,))
    graphs((a,))
    assert captures == [("MainThread", ((3,),))]
    in_thread("w1", a, a).join()          # the main thread is alive
    assert len(captures) == 2 and len(graphs) == 2
    in_thread("w2", a).join()             # takes w1's graph
    in_thread("w3", a, b).join()          # w2's, and a new signature
    assert [c[0] for c in captures] == ["MainThread", "w1", "w3"]
    assert len(graphs) == 3
    start = threading.Barrier(2)
    pair = [in_thread(n, a, barrier=start) for n in ("w4", "w5")]
    for th in pair:
        th.join()
    # one of them took w3's finished graph, the other captured
    assert len(captures) == 4 and len(graphs) == 4

    # a new thread may carry a finished thread's ident: it takes the
    # graph filed under that ident, and no other graph is lost
    class Owner:
        def __init__(self, ident):
            self.ident, self.alive = ident, True

        def is_alive(self):
            return self.alive

    fresh = kreg.CudaGraphs(lambda ts, needs: ts)
    sig = ("sig",)
    one, two = Owner(1), Owner(2)
    first = fresh._claim(sig, (a,), (), one)
    second = fresh._claim(sig, (a,), (), two)
    one.alive = two.alive = False
    assert fresh._claim(sig, (a,), (), Owner(2)) is second
    assert fresh._claim(sig, (a,), (), Owner(3)) is first
    assert len(fresh) == 2 and len(captures) == 6
