"""Live resharding in the port against the reference.

``build_migration`` gives the reference's moves for the same pair of
plans (S = 4->6, 6->4, 1->3, and with an oversized leaf split),
``migrate`` is bitwise the reference's and invertible, ``migrate_grads``
equals a repack under the new plan; the in-heap port server resharded
at the same point as the JAX server stays within 1 ulp of the operands
per apply; a push racing the migration parks and replays exactly once
(parked == replayed); a stale-epoch push is translated and an unknown
epoch bounces with "resync" (in-heap and over tcp); the replay fold in
bf16 is bit for bit the reference's numpy fold; a tcp client observes
the new epoch; and a ``ps-threads`` session with the reshard trigger
keeps training through the migration.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.core.policies import make_policy_factory
from repro_torch.ft.reshard import (build_migration, equalized_counts,
                                    live_reshard, replay_fold,
                                    spread_versions)
from repro_torch.models.params import from_numpy_tree
from repro_torch.perfcount import WIRE
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.plan import build_shard_plan
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.wireformat import WIRE_LANES, FrameError

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


def port_tree(tree, dtype=torch.float32):
    return {k: v.to(dtype) for k, v in from_numpy_tree(tree, "cpu").items()}


def jax_tree(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


def make_port(params, *, n_workers=2, n_shards=4, policy="asp",
              momentum=0.9, lr=0.05, damping=False, dtype=torch.float32):
    return ShardedParameterServer(
        port_tree(params, dtype),
        make_policy_factory(policy, n_workers=n_workers, s_lower=0,
                            s_upper=3),
        lambda: ServerOptimizer(lr=lr, momentum=momentum,
                                staleness_damping=damping),
        n_workers, n_shards, apply_mode="fused")


def make_reference(params, *, n_workers=2, n_shards=4, momentum=0.9,
                   lr=0.05, damping=False, dtype=jnp.float32):
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    return JServer(jax_tree(params, dtype),
                   jfactory("asp", n_workers=n_workers),
                   lambda: JOpt(lr=lr, momentum=momentum,
                                staleness_damping=damping),
                   n_workers, n_shards, apply_mode="fused")


def within_ulps(a, b, magnitude, k):
    return bool(np.all(np.abs(a - b) <= k * np.spacing(magnitude)))


# ============================================================ the map
def _plans(s_old, s_new, params, bf16=False):
    from repro.ps.sharded.plan import build_shard_plan as jbuild
    jp = jax_tree(params, jnp.bfloat16 if bf16 else jnp.float32)
    tp = port_tree(params, torch.bfloat16 if bf16 else torch.float32)
    return ((jbuild(jp, s_old), jbuild(jp, s_new)),
            (build_shard_plan(tp, s_old), build_shard_plan(tp, s_new)))


@pytest.mark.parametrize("s_old,s_new", [(4, 6), (6, 4), (1, 3), (3, 1)])
def test_build_migration_moves_are_the_references(s_old, s_new):
    from repro.ft.reshard import build_migration as jbuild_migration
    params = make_params()
    (jo, jn), (to, tn) = _plans(s_old, s_new, params)
    jmig, tmig = jbuild_migration(jo, jn), build_migration(to, tn)
    # w0 (24 x 512) is above the per-shard target at S >= 2: split
    assert any(not sl.whole for p in (to, tn) if p.n_shards > 1
               for sh in p.shards for sl in sh.slices)
    assert [tuple(vars(m).values()) for m in tmig.moves] == \
        [tuple(vars(m).values()) for m in jmig.moves]
    assert tmig.old_shard_rows == jmig.old_shard_rows
    assert tmig.new_shard_rows == jmig.new_shard_rows
    for j in range(s_old):
        assert [vars(m) for m in tmig.moves_from(j)] == \
            [vars(m) for m in jmig.moves_from(j)]
    # the port's rebuild is its fresh plan, and the reference's
    assert to.rebuild(s_new).shards == tn.shards
    assert [[vars(sl) for sl in s.slices] for s in tn.shards] == \
        [[vars(sl) for sl in s.slices] for s in jo.rebuild(s_new).shards]


def test_build_migration_rejects_mismatched_trees():
    a = build_shard_plan({"w": torch.zeros(8, 4)}, 2)
    b = build_shard_plan({"w": torch.zeros(8, 5)}, 2)
    with pytest.raises(ValueError, match="same tree"):
        build_migration(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_migrate_is_the_references_bitwise_and_invertible(dtype):
    from repro.ft.reshard import build_migration as jbuild_migration
    params = make_params()
    (jo, jn), (to, tn) = _plans(4, 6, params, dtype == torch.bfloat16)
    jmig, tmig = jbuild_migration(jo, jn), build_migration(to, tn)
    assert to.wire_layout().dtype == dtype
    g = torch.Generator().manual_seed(1)
    layout = to.wire_layout()
    bufs = [torch.randn(r, WIRE_LANES, generator=g).to(dtype)
            for r in layout.shard_rows]
    for buf, sh in zip(bufs, to.shards):     # padding is zero on the wire
        buf.view(-1)[sh.size:] = 0
    new = tmig.migrate(bufs)
    assert [b.dtype for b in new] == [dtype] * 6
    npdt = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32

    def to_np(b):
        if dtype == torch.bfloat16:
            return b.view(torch.int16).numpy().view(npdt)
        return b.numpy()

    jnew = jmig.migrate([to_np(b) for b in bufs])
    for a, b in zip(new, jnew):
        assert to_np(a).tobytes() == np.asarray(b).tobytes()
    back = build_migration(tn, to).migrate(new)
    for a, b in zip(back, bufs):
        assert torch.equal(a.view(torch.int16) if dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if dtype == torch.bfloat16 else b)


def test_migrate_grads_equals_a_repack_under_the_new_plan():
    params = make_params()
    _, (to, tn) = _plans(4, 6, params)
    g = port_tree(grads_like(params, 3))
    moved = build_migration(to, tn).migrate_grads(to.shard_wires(to.pack(g)))
    for a, b in zip(moved, tn.shard_wires(tn.pack(g))):
        assert torch.equal(a, b)


def test_spread_versions_and_equalized_counts_are_the_references():
    from repro.ft import reshard as jr
    for total, n in ((17, 6), (0, 3), (5, 5), (100, 7)):
        assert spread_versions(total, n) == jr.spread_versions(total, n)
        assert sum(spread_versions(total, n)) == total
    per = [{0: 5, 1: 3}, {0: 4, 1: 6}, {0: 7}]
    assert equalized_counts(per) == jr.equalized_counts(per) == \
        {0: 4, 1: 3}


# ===================================================== the live server
def test_in_heap_reshard_agrees_with_the_reference_server():
    """The same f32 pushes into the port's server and the JAX server,
    both resharded 4 -> 6 after the second and 6 -> 3 after the third:
    params bitwise across each migration, within 1 ulp of the operands
    per apply against the reference, versions and epochs equal."""
    params = make_params()
    port, ref = make_port(params), make_reference(params)

    def canon(srv):     # every element in canonical (tree) order
        return np.concatenate([np.asarray(x).reshape(-1) for x in
                               jax.tree_util.tree_leaves(srv.params)])

    magnitude = np.abs(canon(port))
    k = 0
    for step in range(5):
        g = grads_like(params, step + 1)
        port.push_packed(step % 2, port.plan.pack(port_tree(g)))
        ref.push_packed(step % 2, ref.plan.pack(jax_tree(g)))
        k += 1
        target = {1: 6, 2: 3}.get(step)
        if target is not None:
            before = port.pull_packed().clone()
            v_before = port.version
            assert live_reshard(port, target) is True
            assert ref.reshard(target) is True
            assert port.version == v_before == ref.version
            assert port.reshard(target) is False         # a no-op
            # the values moved bitwise (unpacked: the layouts differ)
            old = build_shard_plan(port_tree(params), {1: 4, 2: 6}[step])
            for a, b in zip(jax.tree_util.tree_leaves(
                    old.unpack(before)), jax.tree_util.tree_leaves(
                    port.params)):
                assert torch.equal(a, b)
        a, b = canon(port), canon(ref)
        magnitude = np.maximum.reduce([magnitude, np.abs(a), np.abs(b),
                                       np.abs(np.concatenate(
                                           [x.reshape(-1) for x in
                                            jax.tree_util.tree_leaves(g)]))])
        assert within_ulps(a, b, magnitude, k), step
    assert port.reshard_epoch == ref.reshard_epoch == 2
    assert port.n_shards == ref.n_shards == 3
    assert port.shard_versions() == ref.shard_versions()
    port.stop(), ref.stop()


def test_push_racing_the_migration_parks_and_replays_exactly_once():
    """After shard 1 of 4 is copied out, shards 0-1 are retired (their
    applies park) while 2-3 are live: a push there straddles the
    migration.  Parked == replayed, and the result agrees with the JAX
    server put through the same race."""
    params = make_params()
    port, ref = make_port(params), make_reference(params)
    pre, mid, post = (grads_like(params, s) for s in (1, 2, 3))
    port.push_packed(0, port.plan.pack(port_tree(pre)))
    ref.push_packed(0, ref.plan.pack(jax_tree(pre)))
    WIRE.reset()
    tmid, jmid = port.plan.pack(port_tree(mid)), ref.plan.pack(
        jax_tree(mid))
    fired = []

    def hook_for(srv, wire):
        def hook(shard_index):
            if shard_index == 1 and srv not in fired:
                fired.append(srv)
                srv.push_packed(1, wire)
        return hook

    assert port.reshard(6, _mid_hook=hook_for(port, tmid))
    ev = WIRE.snapshot()
    assert ev["reshard_parked"] == 2 == ev["reshard_replayed"]
    assert ref.reshard(6, _mid_hook=hook_for(ref, jmid))
    port.push_packed(0, port.plan.pack(port_tree(post)))
    ref.push_packed(0, ref.plan.pack(jax_tree(post)))
    a, b = port.pull_packed().numpy(), np.asarray(ref.pull_packed())
    # 1 ulp of the operands (params, momentum, gradients) per apply
    operands = [np.abs(a), np.abs(b),
                np.abs(torch.cat([st._packed_m for st in port.shards])
                       .numpy())]
    operands += [np.abs(port.plan.pack(port_tree(g)).numpy())
                 for g in (pre, mid, post)]
    assert within_ulps(a, b, np.maximum.reduce(operands), 3)
    assert port.shard_versions() == ref.shard_versions()
    port.stop(), ref.stop()


def test_stale_epoch_push_is_translated_and_unknown_epoch_bounces():
    params = make_params()
    srv, ref = make_port(params), make_port(params)
    old_plan = srv.plan
    srv.reshard(6)
    WIRE.reset()
    g = port_tree(grads_like(params, 5))
    srv.push_packed(0, old_plan.pack(g), epoch=0)        # stale: translated
    ref.push_packed(0, ref.plan.pack(g))
    assert WIRE.snapshot()["reshard_translated"] == 1
    assert torch.equal(torch.cat([t.reshape(-1) for t in
                                  jax.tree_util.tree_leaves(srv.params)]),
                       torch.cat([t.reshape(-1) for t in
                                  jax.tree_util.tree_leaves(ref.params)]))
    g2 = port_tree(grads_like(params, 6))
    srv.push_packed(1, old_plan.pack(g2))                 # epoch inferred
    ref.push_packed(1, ref.plan.pack(g2))
    for a, b in zip(jax.tree_util.tree_leaves(srv.params),
                    jax.tree_util.tree_leaves(ref.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="resync"):
        srv.push_packed(0, srv.plan.pack(g2), epoch=7)
    srv.stop(), ref.stop()


def test_gate_waiter_on_an_abandoned_shard_is_released():
    params = make_params()
    srv = make_port(params, policy="bsp")
    wire = srv.plan.pack(port_tree(grads_like(params, 0)))
    done = threading.Event()

    def blocked_push():
        srv.push_packed(0, wire)        # BSP: blocks until worker 1 pushes
        done.set()

    t = threading.Thread(target=blocked_push, daemon=True)
    t.start()
    assert not done.wait(0.3), "the BSP barrier did not block"
    srv.reshard(6)
    assert done.wait(30.0), "waiter stranded on an abandoned shard"
    threads = [threading.Thread(target=srv.push_packed, args=(
        w, srv.plan.pack(port_tree(grads_like(params, w))))) for w in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    srv.stop()


def test_delta_pull_carries_the_epoch_and_falls_back_to_full():
    params = make_params()
    srv = make_port(params)
    d0 = srv.pull_delta(0, (-1,) * 4)
    assert d0.epoch == 0
    srv.push_packed(0, srv.plan.pack(port_tree(grads_like(params, 1))))
    srv.reshard(6)
    d = srv.pull_delta(0, d0.versions)
    assert d.full and d.epoch == 1 and len(d.versions) == 6
    layout = srv.plan.wire_layout()
    buf = torch.zeros(layout.total_rows, WIRE_LANES)
    for j, r in zip(d.shards, d.regions):
        s = layout.shard_row_start[j]
        buf[s:s + r.shape[0]] = r
    assert torch.equal(buf, srv.pull_packed())
    tree = ShardedParameterServer(
        port_tree(params), make_policy_factory("asp", n_workers=1),
        lambda: ServerOptimizer(lr=0.1), 1, 2, apply_mode="tree")
    with pytest.raises(ValueError, match="fused"):
        tree.reshard(3)
    with pytest.raises(ValueError, match="n_shards"):
        srv.reshard(0)
    srv.stop(), tree.stop()


# ====================================================== the replay fold
def test_bf16_replay_fold_is_the_references_numpy_fold_bit_for_bit():
    """A bf16 store resharded 4 -> 6 in both packages, then the same
    parked bf16 regions replayed twice (the second sees momentum):
    every new shard's p and m bit for bit.  lr 0.05, beta 0.9 and the
    damped scale 1/3 are not bf16 numbers, so an unrounded scalar would
    show."""
    params = make_params()
    port = make_port(params, damping=True, dtype=torch.bfloat16)
    ref = make_reference(params, damping=True, dtype=jnp.bfloat16)
    port.reshard(6)
    ref.reshard(6)
    g = torch.Generator().manual_seed(4)
    old_rows = build_migration(port._retired_plans[0],
                               port.plan).old_shard_rows
    for rnd in range(2):
        for j in (1, 3):
            region = torch.randn(old_rows[j], WIRE_LANES,
                                 generator=g).to(torch.bfloat16)
            jregion = region.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
            port._replay_region(port._migrations[0], j, region, 2)
            ref._replay_region(ref._migrations[0], j, jnp.asarray(jregion),
                               2)
    for st, jst in zip(port.shards, ref.shards):
        for t, j in ((st._packed_p, jst._packed_p),
                     (st._packed_m, jst._packed_m)):
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == \
                np.asarray(j).view(np.int16).tobytes()
    assert port.shard_versions() == ref.shard_versions()
    # the check above is sensitive to the trap: with the scalars left
    # as Python floats, bf16 tensor ops would differ from it
    p, m, gg = (torch.randn(4096, generator=g).to(torch.bfloat16)
                for _ in range(3))
    folded, seg = replay_fold(p, m, gg, 0.05, 0.9, 1 / 3)
    unrounded = m * 0.9 + gg * (1 / 3)
    assert folded.dtype == seg.dtype == torch.bfloat16
    assert not torch.equal(seg, unrounded)
    port.stop(), ref.stop()


# ================================================================= tcp
def test_tcp_client_observes_the_epoch_and_its_stale_push_lands():
    from repro_torch.transport import PSServerEndpoint, make_transport
    params = make_params()
    srv = make_port(params, n_workers=1, n_shards=2)
    ref = make_port(params, n_workers=1, n_shards=2)
    old_plan = srv.plan
    tp = make_transport("tcp", n_workers=1)
    tp.serve(PSServerEndpoint(srv))
    try:
        c = tp.connect(0)
        c.hello()
        assert c.reshard_epoch == 0
        d0 = c.pull_delta((-1, -1))
        assert d0.epoch == 0
        srv.reshard(3)
        d = c.pull_delta(d0.versions)
        assert d.full and d.epoch == 1 and len(d.versions) == 3
        # a push still packed under the OLD layout (epoch 0 on the frame)
        g = port_tree(grads_like(params, 9))
        assert c.push_packed(old_plan.pack(g)) is True
        ref.push_packed(0, ref.plan.pack(g))
        for a, b in zip(jax.tree_util.tree_leaves(srv.params),
                        jax.tree_util.tree_leaves(ref.params)):
            assert torch.equal(a, b)
        c.reshard_epoch = 1
        assert c.push_packed(srv.plan.pack(
            port_tree(grads_like(params, 10)))) is True
        c.reshard_epoch = 9            # an epoch the server never issued
        with pytest.raises(FrameError, match="resync"):
            c.push_packed(srv.plan.pack(port_tree(grads_like(params, 11))))
        c.reshard_epoch = 1
        c.bye()
        c.close()
    finally:
        srv.stop(), ref.stop()
        tp.shutdown()


# ===================================================== in-heap workers
def test_threaded_workers_resync_through_a_live_reshard():
    """Two in-heap ``PSWorker`` threads (delta pulls into a resident
    buffer, the packed step) train while another thread reshards the
    server 4 -> 6: each worker rebuilds its buffer and step against the
    new plan, every iteration completes, nothing parked is lost."""
    from repro_torch.api.session import packed_step, worker_batches
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.models import registry
    from repro_torch.ps.worker import PSWorker, run_cluster
    cfg = get_smoke_config("h2o-danube-1.8b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    srv = ShardedParameterServer(
        registry.init_params(cfg, seed=0, device="cpu"),
        make_policy_factory("dssp", n_workers=2, s_lower=0, s_upper=3),
        lambda: ServerOptimizer(lr=0.01, momentum=0.9), 2, 4,
        apply_mode="fused")
    workers = [PSWorker(w, srv, packed_step(cfg, srv.plan, torch.device(
        "cpu"), current_plan=lambda: srv.plan), worker_batches(
        cfg, data, w, torch.device("cpu")), 6, delta_pull=True,
        loss_from_aux=lambda aux: float(aux["loss"])) for w in (0, 1)]
    WIRE.reset()

    def trigger():
        while srv.metrics.total_pushes < 3 and not srv.stopped:
            threading.Event().wait(0.005)
        srv.reshard(6)

    t = threading.Thread(target=trigger, daemon=True)
    t.start()
    run_cluster(srv, workers, timeout=120.0)
    t.join(timeout=30.0)
    assert srv.n_shards == 6 and srv.reshard_epoch == 1
    assert [w.iterations_done for w in workers] == [6, 6]
    ev = WIRE.snapshot()
    assert ev["reshard_parked"] == ev["reshard_replayed"]
    assert srv.metrics.total_pushes == 12
    losses = [x for _, _, x in srv.metrics.loss_trajectory]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
