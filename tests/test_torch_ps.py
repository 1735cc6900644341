"""repro_torch's sharded parameter server against the reference's.

Push, apply and pull of the same packed gradients agree with
``repro``'s ``ShardedParameterServer`` within 1 ulp per apply: the
reference folds through its Pallas kernel in interpret mode, which XLA
contracts into FMAs, while the port (its kernel and its plain version
alike) rounds every product and sum.  Delta pulls ship only the regions
that advanced, and per-shard gating blocks and releases as in the
reference's ``tests/test_coalesced_delta.py``.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.policies import make_policy_factory
from repro_torch.models.params import from_numpy_tree
from repro_torch.perfcount import WIRE
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer

# constructing the reference server directly is its legacy (warned) path
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(2)


def make_params():
    rng = np.random.RandomState(0)
    return {
        "w0": rng.randn(24, 512).astype(np.float32),
        "w1": rng.randn(16, 128).astype(np.float32),
        "b": rng.randn(300).astype(np.float32),
        "s": np.float32(rng.randn()),
    }


def grads_like(params, seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*np.shape(v)), np.float32)
            for k, v in params.items()}


def make_port(params, *, n_workers=4, n_shards=2, policy="asp",
              momentum=0.9, lr=0.05, damping=False):
    return ShardedParameterServer(
        from_numpy_tree(params, "cpu"),
        make_policy_factory(policy, n_workers=n_workers),
        lambda: ServerOptimizer(lr=lr, momentum=momentum,
                                staleness_damping=damping),
        n_workers=n_workers, n_shards=n_shards)


def make_reference(params, *, n_workers=4, n_shards=2, momentum=0.9,
                   lr=0.05, damping=False):
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    return JServer(jax.tree_util.tree_map(jnp.asarray, params),
                   jfactory("asp", n_workers=n_workers),
                   lambda: JOpt(lr=lr, momentum=momentum,
                                staleness_damping=damping),
                   n_workers=n_workers, n_shards=n_shards,
                   apply_mode="fused")


@pytest.mark.parametrize("n_shards,damping", [(2, False), (4, True)])
def test_push_apply_pull_agrees_with_reference_within_1ulp_per_apply(
        n_shards, damping):
    params = make_params()
    port = make_port(params, n_shards=n_shards, damping=damping)
    ref = make_reference(params, n_shards=n_shards, damping=damping)
    assert port.plan.wire_layout().total_rows == \
        ref.plan.wire_layout().total_rows
    np.testing.assert_array_equal(port.pull_packed().numpy(),
                                  np.asarray(ref.pull_packed()))
    magnitude = np.abs(port.pull_packed().numpy())
    for k in range(1, 4):
        g = grads_like(params, k)
        jwire = ref.plan.pack(jax.tree_util.tree_map(jnp.asarray, g))
        twire = port.plan.pack(from_numpy_tree(g, "cpu"))
        np.testing.assert_array_equal(twire.numpy(), np.asarray(jwire))
        ref.push_packed(k % 4, jwire)
        port.push_packed(k % 4, twire)
        a, b = port.pull_packed().numpy(), np.asarray(ref.pull_packed())
        # 1 ulp of the operands' magnitude (params, momentum, gradient)
        # per apply so far — not of the result, which cancellation can
        # make arbitrarily small.
        magnitude = np.maximum.reduce([magnitude, np.abs(a), np.abs(b),
                                       np.abs(twire.numpy())])
        assert np.all(np.abs(a - b) <= k * np.spacing(magnitude)), k
    assert port.shard_versions() == ref.shard_versions() == [3] * n_shards
    assert port.metrics.summary()["pushes"] == 3
    port.stop(), ref.stop()


def test_apply_writes_new_buffers_and_snapshots_stay_immutable():
    params = make_params()
    srv = make_port(params, n_shards=2)
    before = srv.pull_packed()
    kept = before.clone()
    d0 = srv.pull_delta(0, (-1, -1))
    regions = [r.clone() for r in d0.regions]
    srv.push_packed(0, srv.plan.pack(from_numpy_tree(grads_like(params, 1),
                                                     "cpu")))
    assert torch.equal(before, kept)           # the old snapshot is intact
    for r, c in zip(d0.regions, regions):
        assert torch.equal(r, c)
    assert not torch.equal(srv.pull_packed(), kept)
    srv.stop()


def test_pull_packed_snapshot_cache_is_version_keyed():
    params = make_params()
    srv = make_port(params, n_shards=3)
    a = srv.pull_packed()
    assert srv.pull_packed() is a
    srv.push_packed(0, srv.plan.pack(from_numpy_tree(grads_like(params, 2),
                                                     "cpu")))
    b = srv.pull_packed()
    assert b is not a and srv.pull_packed() is b
    tree = srv.pull(0)
    assert torch.equal(srv.plan.pack(tree), b)
    srv.stop()


def test_delta_pull_after_partial_advance_ships_only_advanced_regions():
    """BSP, 2 workers: worker 0's push applies shard 0, then blocks in
    shard 0's gate, so shards 1 and 2 have not moved.  A delta pull then
    ships shard 0's region alone; worker 1's push releases the round."""
    params = make_params()
    srv = make_port(params, n_workers=2, n_shards=3, policy="bsp")
    layout = srv.plan.wire_layout()
    d0 = srv.pull_delta(1, (-1,) * 3)
    assert set(d0.shards) == {0, 1, 2} and not d0.full
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 3), "cpu"))
    t = threading.Thread(target=srv.push_packed, args=(0, wire))
    t.start()
    deadline = time.monotonic() + 30.0
    while srv.shard_versions()[0] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.shard_versions() == [1, 0, 0]
    WIRE.reset()
    d = srv.pull_delta(1, d0.versions)
    assert d.shards == (0,) and not d.full
    itemsize = 4
    shipped = layout.shard_rows[0] * 512 * itemsize
    assert WIRE.delta_bytes_tx == shipped
    assert WIRE.full_pull_bytes_avoided == \
        layout.total_rows * 512 * itemsize - shipped
    start = layout.shard_row_start[0]
    assert torch.equal(d.regions[0],
                       srv.pull_packed()[start:start + layout.shard_rows[0]])
    srv.push_packed(1, wire)
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert srv.shard_versions() == [2, 2, 2]
    d2 = srv.pull_delta(1, srv.shard_versions())
    assert d2.empty and not d2.full
    for bad in (None, (0,), (9, 9, 9)):
        assert srv.pull_delta(1, bad).full
    srv.stop()


def test_gating_still_blocks_per_worker():
    """BSP across 3 concurrent pushers: the barrier releases per worker,
    the round completes and every push applies on every shard."""
    params = make_params()
    W = 3
    srv = make_port(params, n_workers=W, n_shards=2, policy="bsp")
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 3), "cpu"))
    threads = [threading.Thread(target=srv.push_packed, args=(w, wire))
               for w in range(W)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads), "BSP round deadlocked"
    assert srv.shard_versions() == [W, W]
    assert srv.metrics.max_staleness <= 1
    srv.stop()


def test_push_packed_rejects_mismatched_wire_and_unported_modes():
    """Wrong-shaped wires raise, a push stamped with a reshard epoch the
    server never issued bounces with "resync" (live resharding itself
    runs since item 8 was ported), and the modes this server once
    refused — coalescing, wire compression, the global gate and the
    tree apply — now build and fold a push."""
    params = make_params()
    srv = make_port(params, n_shards=2)
    with pytest.raises(ValueError, match="does not match layout"):
        srv.push_packed(0, torch.zeros(8, 512))
    with pytest.raises(ValueError, match="shard buffers"):
        srv.push_packed(0, [torch.zeros(8, 512)])
    with pytest.raises(ValueError, match="resync"):
        srv.push_packed(0, srv.pull_packed(), epoch=1)
    assert srv.reshard(3) is True and srv.reshard_epoch == 1
    srv.stop()
    tree = from_numpy_tree(params, "cpu")
    grads = from_numpy_tree(grads_like(params, 1), "cpu")
    for kw in (dict(coalesce=2, coalesce_wait=0.0),
               dict(wire_compression="int8"),
               dict(gating="global"),
               dict(apply_mode="tree")):
        other = ShardedParameterServer(
            tree, make_policy_factory("asp"),
            lambda: ServerOptimizer(lr=0.1), 1, 2, **kw)
        before = other.plan.pack(other.pull(0)).clone()
        if kw.get("apply_mode") == "tree":
            other.push(0, grads)
        else:
            other.push_packed(0, other.plan.pack(grads))
        assert other.shard_versions() == [1, 1], kw
        after = other.plan.pack(other.pull(0))
        assert not torch.equal(after, before), kw
        other.stop()
    with pytest.raises(ValueError, match="coalesce"):
        ShardedParameterServer(tree, make_policy_factory("asp"),
                               lambda: ServerOptimizer(lr=0.1), 1, 2,
                               apply_mode="tree", coalesce=2)


def test_membership_departure_releases_and_join_starts_at_slowest():
    """A blocked BSP worker is released when its peer leaves; a joining
    worker starts at the slowest count on every shard."""
    params = make_params()
    srv = make_port(params, n_workers=2, n_shards=2, policy="bsp")
    wire = srv.plan.pack(from_numpy_tree(grads_like(params, 5), "cpu"))
    t = threading.Thread(target=srv.push_packed, args=(0, wire))
    t.start()
    deadline = time.monotonic() + 30.0
    while srv.shard_versions()[0] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.remove_worker(1)
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert srv.shard_versions() == [1, 1]
    srv.add_worker(7)
    assert all(st.tracker.counts[7] == st.tracker.counts[0] == 1
               for st in srv.shards)
    assert srv.metrics.n_workers == 2
    srv.record_loss(0, 1.5)
    assert srv.metrics.loss_trajectory[-1][2] == 1.5
    srv.shutdown()
    assert srv.stopped
