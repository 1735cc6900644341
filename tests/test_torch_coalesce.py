"""repro_torch's coalesced applies, mono server, global gate and tree wire
against the reference's, on the CPU.

* ``fused_update_batched`` (its plain version here) is bit for bit K
  sequential ``fused_update`` calls, in f32 and bf16, and bit for bit the
  reference's oracle ``fused_update_batched_ref``; the reference's Pallas
  kernel in interpret mode sits within 1 ulp of the operands per step
  (XLA contracts it into FMAs on the CPU, ROADMAP queue 3);
* the coalesced servers keep the properties of the reference's
  ``tests/test_coalesced_delta.py``: a window of one is the uncoalesced
  path bit for bit, concurrent identical pushes fold through one flush
  per shard per round, the mono server coalesces the same way, gating
  still blocks, and the tree apply refuses coalescing;
* the mono server (tree and packed), the global gate and the tree wire
  agree with the reference servers fed the same pushes.

Threaded tests join with deadlines, so a deadlock fails instead of
hanging the suite.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_update import \
    fused_update_batched as jax_batched
from repro_torch.core.policies import make_policy_factory
from repro_torch.kernels import fused_update as fu
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs.trace import TRACE
from repro_torch.perfcount import LAUNCHES, WIRE
from repro_torch.ps.server import ParameterServer, ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(2)

DEADLINE_S = 60.0
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(k, shape, dtype, seed):
    rng = np.random.RandomState(seed)
    p, m = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    gs = rng.randn(k, *shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(p, jdt), jnp.asarray(m, jdt), jnp.asarray(gs, jdt)),
            tuple(torch.from_numpy(a).to(tdt) for a in (p, m, gs)))


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """One ulp of the storage dtype at each value of ``x``."""
    mant = 23 if dtype == "float32" else 7
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - mant)


# ================================================================ kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 512), (40, 512), (7, 13)])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_batched_plain_is_k_sequential_launches_and_the_oracle(k, shape,
                                                               dtype):
    (jp, jm, jgs), (p, m, gs) = _batch(k, shape, dtype, seed=k)
    scales = [1.0 / (1 + j) for j in range(k)]
    kw = dict(lr=0.01, beta=0.9)
    po, mo = fu.fused_update_batched(p, m, gs, scales=scales, **kw)
    assert po.dtype == p.dtype and mo.shape == m.shape
    ps_, ms_ = p, m
    steps = []
    for j in range(k):
        ps_, ms_ = fu.fused_update(ps_, ms_, gs[j], scale=scales[j], **kw)
        steps += [ps_, ms_]
    assert torch.equal(po, ps_) and torch.equal(mo, ms_)
    # a list of regions (what the server passes) folds the same
    pl, ml = fu.fused_update_batched(p, m, list(gs), scales=scales, **kw)
    assert torch.equal(pl, po) and torch.equal(ml, mo)
    # the reference's oracle, bit for bit
    pr, mr = jref.fused_update_batched_ref(jp, jm, jgs, scales=scales, **kw)
    np.testing.assert_array_equal(_np(po), _np(pr))
    np.testing.assert_array_equal(_np(mo), _np(mr))
    # the reference's Pallas kernel in interpret mode: 1 ulp of the
    # operands (every step's p, m and g) per step
    pk, mk = jax_batched(jp, jm, jgs, scales=scales, interpret=True, **kw)
    mag = np.maximum.reduce([np.abs(_np(a)) for a in
                             [p, m, pk, mk] + steps + list(gs)])
    bound = k * _ulp(mag, dtype)
    assert np.all(np.abs(_np(po) - _np(pk)) <= bound)
    assert np.all(np.abs(_np(mo) - _np(mk)) <= bound)


def test_batched_rejects_bad_shapes_and_launches_nothing_on_the_cpu():
    p = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="do not match"):
        fu.fused_update_batched(p, p, torch.zeros((2, 8, 256)), lr=0.1)
    with pytest.raises(ValueError, match="scales"):
        fu.fused_update_batched(p, p, torch.zeros((2, 8, 512)), lr=0.1,
                                scales=[1.0])
    with pytest.raises(ValueError, match="no gradients"):
        fu.fused_update_batched(p, p, [], lr=0.1)
    before = LAUNCHES.snapshot()
    fu.fused_update_batched(p, p, torch.ones((3, 8, 512)), lr=0.1)
    assert LAUNCHES.snapshot() == before
    assert fu.fused_update_batched_plain is not None


# ================================================================ servers
def make_params():
    rng = np.random.RandomState(0)
    return {"w0": rng.randn(24, 512).astype(np.float32),
            "w1": rng.randn(16, 128).astype(np.float32),
            "b": rng.randn(300).astype(np.float32),
            "s": np.float32(rng.randn())}


def grads_like(params, seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*np.shape(v)), np.float32)
            for k, v in params.items()}


def make_sharded(params, *, n_workers=4, n_shards=2, policy="asp",
                 coalesce=1, coalesce_wait=None, **kw):
    return ShardedParameterServer(
        from_numpy_tree(params, "cpu"),
        make_policy_factory(policy, n_workers=n_workers),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9),
        n_workers=n_workers, n_shards=n_shards, apply_mode="fused",
        coalesce=coalesce, coalesce_wait=coalesce_wait, **kw)


def make_mono(params, *, n_workers=2, policy="asp", **kw):
    return ParameterServer(
        from_numpy_tree(params, "cpu"),
        make_policy_factory(policy, n_workers=n_workers)(),
        ServerOptimizer(lr=0.05, momentum=0.9), n_workers, **kw)


def _run_threads(targets):
    threads = [threading.Thread(target=f, args=a, daemon=True)
               for f, a in targets]
    for t in threads:
        t.start()
    deadline = time.monotonic() + DEADLINE_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "deadlocked"


def test_window_of_one_is_bitwise_the_uncoalesced_path():
    params = make_params()
    base = make_sharded(params, coalesce=1)
    co = make_sharded(params, coalesce=4, coalesce_wait=0.0)
    wires = [base.plan.pack(from_numpy_tree(grads_like(params, s), "cpu"))
             for s in range(3)]
    for i, w in enumerate(wires):
        base.push_packed(i % 4, w)
        co.push_packed(i % 4, w)   # sequential: every flush has K=1
    assert co.shard_versions() == base.shard_versions() == [3, 3]
    assert torch.equal(co.pull_packed(), base.pull_packed())
    base.stop(), co.stop()


def test_concurrent_window_one_flush_per_shard_per_round():
    """W concurrent pushes of the same gradient into windows of W: one
    flush of n=W per shard, bit for bit W sequential pushes (identical
    gradients make the fold independent of the enqueue order)."""
    params = make_params()
    W, S = 4, 2
    base = make_sharded(params, n_workers=W, n_shards=S)
    co = make_sharded(params, n_workers=W, n_shards=S, coalesce=W,
                      coalesce_wait=30.0)
    wire = base.plan.pack(from_numpy_tree(grads_like(params, 7), "cpu"))
    for w in range(W):
        base.push_packed(w, wire)
    WIRE.reset()
    TRACE.enable(source="server")
    try:
        _run_threads([(co.push_packed, (w, wire)) for w in range(W)])
        events = TRACE.drain()
    finally:
        TRACE.disable()
    flushes = [e for e in events if e["name"] == "coalesce_flush"]
    assert sorted((e["shard"], e["args"]["n"]) for e in flushes) == \
        [(j, W) for j in range(S)]
    assert WIRE.apply_launches_saved == S * (W - 1)
    assert co.shard_versions() == [W] * S
    assert torch.equal(co.pull_packed(), base.pull_packed())
    base.stop(), co.stop()


def test_departing_worker_shrinks_an_inflight_linger():
    """A flusher lingering for a window of 2 is released by the other
    worker leaving, long before its linger would end."""
    params = make_params()
    srv = make_sharded(params, n_workers=2, n_shards=1, coalesce=2,
                       coalesce_wait=30.0)
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 1), "cpu"))
    t0 = time.monotonic()
    t = threading.Thread(target=srv.push_packed, args=(0, wire),
                         daemon=True)
    t.start()
    time.sleep(0.2)
    assert srv.shard_versions() == [0]        # still lingering
    srv.remove_worker(1)
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive()
    assert srv.shard_versions() == [1]
    assert time.monotonic() - t0 < 20.0
    srv.stop()


def test_coalesced_gating_still_blocks_per_worker():
    params = make_params()
    W = 3
    srv = make_sharded(params, n_workers=W, n_shards=2, policy="bsp",
                       coalesce=W, coalesce_wait=1.0)
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 3), "cpu"))
    _run_threads([(srv.push_packed, (w, wire)) for w in range(W)])
    assert srv.shard_versions() == [W, W]
    assert srv.metrics.max_staleness <= 1
    srv.stop()


def test_mono_coalesced_matches_uncoalesced():
    params = make_params()
    base = make_mono(params, apply_mode="packed")
    co = make_mono(params, apply_mode="packed", coalesce=4,
                   coalesce_wait=0.0)
    for i in range(3):
        w = base.plan.pack(from_numpy_tree(grads_like(params, i), "cpu"))
        base.push_packed(i % 2, w)
        co.push_packed(i % 2, w)
    assert co.version == base.version == 3
    assert torch.equal(co.pull_packed(), base.pull_packed())
    # two concurrent pushes meet in one flush
    both = make_mono(params, apply_mode="packed", coalesce=2,
                     coalesce_wait=30.0)
    wire = both.plan.pack(from_numpy_tree(grads_like(params, 5), "cpu"))
    WIRE.reset()
    _run_threads([(both.push_packed, (w, wire)) for w in range(2)])
    assert both.version == 2 and WIRE.apply_launches_saved == 1
    for srv in (base, co, both):
        srv.stop()


def test_coalesce_rejects_tree_apply():
    params = make_params()
    with pytest.raises(ValueError, match="coalesce"):
        make_mono(params, coalesce=2)
    with pytest.raises(ValueError, match="coalesce"):
        ShardedParameterServer(
            from_numpy_tree(params, "cpu"), make_policy_factory("asp"),
            lambda: ServerOptimizer(lr=0.1), 1, 2, apply_mode="tree",
            coalesce=2)
    with pytest.raises(ValueError, match="apply mode"):
        make_mono(params, apply_mode="fused")


# ========================================== against the reference servers
def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_close_per_apply(ours, theirs, magnitude, k):
    """Within k ulps of the operands' magnitude: the reference's applies
    are contracted into FMAs (1 ulp each), the port's are not."""
    a, b = np.asarray(ours), np.asarray(theirs)
    assert np.all(np.abs(a - b) <= k * np.spacing(magnitude) + 1e-30)


def test_coalesced_sharded_server_agrees_with_the_reference():
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    params = make_params()
    port = make_sharded(params, n_shards=3, coalesce=2, coalesce_wait=0.0)
    ref = JServer(_jtree(params), jfactory("asp", n_workers=4),
                  lambda: JOpt(lr=0.05, momentum=0.9), n_workers=4,
                  n_shards=3, apply_mode="fused", coalesce=2,
                  coalesce_wait=0.0)
    magnitude = np.abs(port.pull_packed().numpy())
    for k in range(1, 4):
        g = grads_like(params, k)
        tw = port.plan.pack(from_numpy_tree(g, "cpu"))
        port.push_packed(k % 4, tw)
        ref.push_packed(k % 4, ref.plan.pack(_jtree(g)))
        a, b = port.pull_packed().numpy(), np.asarray(ref.pull_packed())
        magnitude = np.maximum.reduce([magnitude, np.abs(a), np.abs(b),
                                       np.abs(tw.numpy())])
        _assert_close_per_apply(a, b, magnitude, k)
    assert port.shard_versions() == ref.shard_versions()
    port.stop(), ref.stop()


@pytest.mark.parametrize("apply_mode", ["tree", "packed"])
def test_mono_server_agrees_with_the_reference(apply_mode):
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ParameterServer as JServer
    from repro.ps.server import ServerOptimizer as JOpt
    params = make_params()
    port = make_mono(params, apply_mode=apply_mode)
    ref = JServer(_jtree(params), jfactory("asp", n_workers=2)(),
                  JOpt(lr=0.05, momentum=0.9), 2, apply_mode=apply_mode)
    magnitude = {k: np.abs(v) for k, v in params.items()}
    for k in range(1, 4):
        g = grads_like(params, k)
        port.push(k % 2, from_numpy_tree(g, "cpu"))    # tree wire
        ref.push(k % 2, _jtree(g))
        ours, theirs = port.pull(0), ref.pull(0)
        for name in params:
            a, b = ours[name].numpy(), np.asarray(theirs[name])
            magnitude[name] = np.maximum.reduce(
                [magnitude[name], np.abs(a), np.abs(b), np.abs(g[name])])
            _assert_close_per_apply(a, b, magnitude[name], k)
    assert port.version == ref.version == 3
    if apply_mode == "packed":
        d = port.pull_delta(0, None)
        assert d.full and d.shards == (0,) and d.versions == (3,)
        assert torch.equal(d.regions[0], port.pull_packed())
        assert port.pull_delta(0, d.versions).empty
    port.stop(), ref.stop()


@pytest.mark.parametrize("apply_mode", ["tree", "fused"])
def test_global_gate_and_tree_wire_agree_with_the_reference(apply_mode):
    """Tree pushes through a globally gated sharded server, both
    packages: the same parameters (within the per-apply ulp bound), the
    same versions, and the same gate bookkeeping."""
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    params = make_params()
    port = ShardedParameterServer(
        from_numpy_tree(params, "cpu"), make_policy_factory("ssp", n_workers=2),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9), 2, 3,
        gating="global", apply_mode=apply_mode)
    ref = JServer(_jtree(params), jfactory("ssp", n_workers=2),
                  lambda: JOpt(lr=0.05, momentum=0.9), 2, 3,
                  gating="global", apply_mode=apply_mode)
    magnitude = {k: np.abs(v) for k, v in params.items()}
    for k in range(1, 4):
        g = grads_like(params, k)
        port.push(0, from_numpy_tree(g, "cpu"))   # one worker, within SSP
        ref.push(0, _jtree(g))
        ours, theirs = port.pull(0), ref.pull(0)
        for name in params:
            a, b = ours[name].numpy(), np.asarray(theirs[name])
            magnitude[name] = np.maximum.reduce(
                [magnitude[name], np.abs(a), np.abs(b), np.abs(g[name])])
            _assert_close_per_apply(a, b, magnitude[name], k)
    assert port.shard_versions() == ref.shard_versions() == [3, 3, 3]
    assert port._gate_tracker.counts == ref._gate_tracker.counts
    assert port.metrics.summary()["pushes"] == 3
    refusal = ("gating='sharded'" if apply_mode == "fused"
               else "apply_mode='fused'")
    with pytest.raises(ValueError, match=refusal):
        port.push_packed_shard(0, 0, torch.zeros(8, 512))
    port.stop(), ref.stop()


def test_global_gate_blocks_the_runner_ahead_until_the_peer_pushes():
    """BSP under the global gate: worker 0's second push waits for worker
    1's first (one gate for all shards), then both finish."""
    params = make_params()
    srv = ShardedParameterServer(
        from_numpy_tree(params, "cpu"), make_policy_factory("bsp", n_workers=2),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9), 2, 2,
        gating="global", apply_mode="fused")
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 2), "cpu"))
    done = threading.Event()

    def worker0():
        srv.push_packed(0, wire)
        done.set()

    t = threading.Thread(target=worker0, daemon=True)
    t.start()
    time.sleep(0.3)
    assert not done.is_set()                  # gated at the barrier
    assert srv.shard_versions() == [1, 1]     # but applied
    srv.push_packed(1, wire)
    t.join(timeout=DEADLINE_S)
    assert done.is_set() and srv.shard_versions() == [2, 2]
    srv.stop()
