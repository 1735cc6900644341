"""The port's fault tolerance against the reference.

Unit layer: the same numpy pushes into the JAX server and the port's
(f32, CPU), a snapshot of each, and a cross restore — versions, tracker
counts, credits, estimator history and metrics equal, p and m bit for
bit across the restore and within 1 ulp of the operands per apply
between the two servers; the cross-shard count equalization; a
snapshot whose arity differs restoring through a reshard; the
snapshotter's skip and keep-K; ``FaultPlan`` dicts equal to the
reference's, and ``FaultyChannel``'s drop decisions equal for the same
seed.

Process layer (spawned children on the CPU, every one under a
deadline): DSSP over tcp with a ``ServerProcess`` SIGKILLed by its
watchdog, restarted on the same port, both workers reconnecting and
finishing; and a worker SIGKILLed while gated, its seat freed and the
respawn taking it back exactly once.
"""

from __future__ import annotations

import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.policies import make_policy_factory
from repro_torch.ft import FaultPlan, FaultyChannel, ServerProcess
from repro_torch.ft.snapshot import (ServerSnapshotter, restore_latest,
                                     restore_server, snapshot_server)
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.transport import TransportClosed
from repro_torch.wireformat import MSG_PULL, MSG_PUSH, WIRE_LANES

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(2)

#: every spawned child's deadline, seconds
CHILD_S = 180.0
ARCH = "h2o-danube-1.8b"   # registry arch the spawned children rebuild


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def tiny_params():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(48, 32).astype(np.float32),
            "b": rng.randn(17).astype(np.float32)}


def make_port(n_workers=2, n_shards=2, policy="dssp", s_lower=8,
              s_upper=16):
    return ShardedParameterServer(
        {k: torch.tensor(v) for k, v in tiny_params().items()},
        make_policy_factory(policy, n_workers=n_workers, staleness=2,
                            s_lower=s_lower, s_upper=s_upper),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9),
        n_workers, n_shards, apply_mode="fused")


def make_reference(n_workers=2, n_shards=2, policy="dssp", s_lower=8,
                   s_upper=16):
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    return JServer(
        {k: jnp.asarray(v) for k, v in tiny_params().items()},
        jfactory(policy, n_workers=n_workers, staleness=2,
                 s_lower=s_lower, s_upper=s_upper),
        lambda: JOpt(lr=0.05, momentum=0.9), n_workers, n_shards,
        apply_mode="fused")


def grad_wires(rows, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, WIRE_LANES).astype(np.float32)
            for _ in range(n)]


def packed_state(server):
    return [(np.asarray(st._packed_p).tobytes(),
             np.asarray(st._packed_m).tobytes()) for st in server.shards]


def _comparable(extras):
    """The extras that must survive a restore exactly: versions, the
    trackers' workers, counts and credits, the policies, and the
    metrics (table A is reset to NaN on restore by design)."""
    out = dict(extras)
    out["shards"] = [{"tracker": {k: v for k, v in s["tracker"].items()
                                  if k != "table"},
                      "policy": s["policy"]} for s in extras["shards"]]
    return out


# ============================================================ snapshots
def test_cross_package_snapshots_restore_exactly():
    """The same pushes into both servers; each one's snapshot restores
    into a fresh server of the OTHER package with versions, trackers,
    credits, estimator history and metrics equal and the packed store
    bit for bit; the two servers' stores agree within 1 ulp of the
    operands per apply."""
    port, ref = make_port(), make_reference()
    rows = port.plan.wire_layout().total_rows
    wires = grad_wires(rows, 6, seed=1)
    for i, g in enumerate(wires):
        port.push_packed(i % 2, torch.tensor(g))
        ref.push_packed(i % 2, jnp.asarray(g))
    p_tree, p_extras = snapshot_server(port)
    j_tree, j_extras = snapshot_server(ref)
    assert p_extras["versions"] == j_extras["versions"] == [6, 6]
    for key in ("n_shards", "kind", "gating", "optimizer",
                "snapshot_version", "reshard_epoch"):
        assert p_extras[key] == j_extras[key]
    a = np.concatenate([np.asarray(st._packed_p).reshape(-1)
                        for st in port.shards])
    b = np.concatenate([np.asarray(st._packed_p).reshape(-1)
                        for st in ref.shards])
    m = np.concatenate([np.asarray(st._packed_m).reshape(-1)
                        for st in port.shards])
    mag = np.maximum.reduce([np.abs(a), np.abs(b), np.abs(m)]
                            + [np.abs(g).reshape(-1) for g in wires])
    assert np.all(np.abs(a - b) <= 6 * np.spacing(mag))

    # reference snapshot -> fresh port server
    into_port = make_port()
    restore_server(into_port, jax.tree_util.tree_map(
        lambda x: torch.tensor(np.asarray(x)), j_tree), j_extras)
    assert packed_state(into_port) == packed_state(ref)
    _, back = snapshot_server(into_port)
    assert _comparable(back) == _comparable(j_extras)
    # port snapshot -> fresh reference server
    into_ref = make_reference()
    restore_server_ref = __import__("repro.ft.snapshot",
                                    fromlist=["x"]).restore_server
    restore_server_ref(into_ref, jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), p_tree), p_extras)
    assert packed_state(into_ref) == packed_state(port)
    _, jback = __import__("repro.ft.snapshot",
                          fromlist=["x"]).snapshot_server(into_ref)
    assert _comparable(jback) == _comparable(p_extras)
    hist = p_extras["shards"][0]["policy"]["estimator"]["hist"]
    assert hist and all(len(v) for v in hist.values())
    for s in (port, ref, into_port, into_ref):
        s.stop()


def test_restore_resumes_bitwise_and_equalizes_crossshard_counts():
    a = make_port()
    rows = a.plan.wire_layout().total_rows
    for i, g in enumerate(grad_wires(rows, 4, seed=2)):
        a.push_packed(i % 2, torch.tensor(g))
    tree, extras = snapshot_server(a)
    b = make_port()
    restore_server(b, tree, extras)
    assert packed_state(a) == packed_state(b)
    for g in grad_wires(rows, 2, seed=9):
        a.push_packed(0, torch.tensor(g))
        b.push_packed(0, torch.tensor(g))
    assert packed_state(a) == packed_state(b)
    # a push caught on shard 0's tracker only: clamped back on restore
    extras["shards"][0]["tracker"]["counts"]["0"] += 1
    c = make_port()
    restore_server(c, tree, extras)
    for st in c.shards:
        assert st.tracker.counts == {0: 2, 1: 2}
        assert all(math.isnan(x) for ts in st.tracker.table.values()
                   for x in ts)
    for s in (a, b, c):
        s.stop()


def test_cross_arity_restore_reshards_first_then_installs():
    a = make_port(n_shards=2)
    rows = a.plan.wire_layout().total_rows
    a.push_packed(0, torch.tensor(grad_wires(rows, 1)[0]))
    tree, extras = snapshot_server(a)
    b = make_port(n_shards=3)
    restore_server(b, tree, extras)
    assert len(b.shards) == 2 and b.reshard_epoch == 1
    assert packed_state(a) == packed_state(b)
    assert a.shard_versions() == b.shard_versions()
    a.stop(), b.stop()


def test_snapshotter_skips_unchanged_keeps_k_and_restores_from_disk(
        tmp_path):
    server = make_port()
    rows = server.plan.wire_layout().total_rows
    mgr = CheckpointManager(str(tmp_path), keep=2)
    snap = ServerSnapshotter(server, mgr, every_s=60.0)
    server.push_packed(0, torch.tensor(grad_wires(rows, 1)[0]))
    assert snap.save_now() is True
    assert snap.save_now() is False          # nothing moved
    for seed in (1, 2, 3):
        server.push_packed(1, torch.tensor(grad_wires(rows, 1, seed)[0]))
        assert snap.save_now() is True
    mgr.wait()
    assert len(mgr.steps()) == 2
    assert [n for _, n in snap.writes] == [2 * rows * WIRE_LANES * 4] * 4
    b = make_port()
    assert restore_latest(b, CheckpointManager(str(tmp_path))) == \
        server.version
    assert packed_state(b) == packed_state(server)
    assert restore_latest(make_port(), CheckpointManager(
        str(tmp_path / "empty"))) is None
    tree_mode = ShardedParameterServer(
        {"w": torch.zeros(4, 4)}, make_policy_factory("asp"),
        lambda: ServerOptimizer(lr=0.05), 1, 2, apply_mode="tree")
    with pytest.raises(ValueError, match="packed"):
        snapshot_server(tree_mode)
    server.stop(), b.stop(), tree_mode.stop()


# ========================================================== fault plans
def test_fault_plan_dicts_are_the_references():
    from repro.api import RunSpec as JRunSpec
    from repro.ft import FaultPlan as JFaultPlan
    from repro_torch.api import RunSpec
    for kw in ({}, {"kill_server_round": 10, "seed": 7},
               {"kill_worker": 1, "kill_worker_round": 3},
               {"drop_kind": MSG_PUSH, "drop_prob": 0.25, "delay_ms": 2.0},
               {"kill_mid_reshard": True}):
        plan, jplan = FaultPlan(**kw), JFaultPlan(**kw)
        assert plan.to_dict() == jplan.to_dict()
        assert json.dumps(plan.to_dict()) == json.dumps(jplan.to_dict())
        assert FaultPlan.from_dict(jplan.to_dict()) == plan
        assert plan.active == jplan.active
        assert plan.wants_channel == jplan.wants_channel
    d = FaultPlan(seed=3).to_dict()
    d["someday_field"] = 1
    assert FaultPlan.from_dict(d) == FaultPlan(seed=3)
    with pytest.raises(ValueError):
        FaultPlan(drop_prob=1.5)
    spec = {"model": {"arch": ARCH, "smoke": True},
            "ps": {"kind": "sharded", "shards": 2, "workers": 2,
                   "apply": "fused"},
            "wire": {"format": "packed"}, "transport": {"kind": "tcp"},
            "ft": {"fault_kill_worker": 1, "fault_kill_worker_round": 2,
                   "fault_drop_prob": 0.1, "fault_seed": 5}}
    assert RunSpec.from_dict(spec).ft.fault_plan().to_dict() == \
        JRunSpec.from_dict(spec).ft.fault_plan().to_dict()


class _CountingChannel:
    def __init__(self):
        self.requests = 0

    def request(self, data):
        self.requests += 1
        return b"ok"

    def close(self):
        pass


def test_faulty_channel_drops_the_same_frames_as_the_references():
    from repro.ft.faults import FaultyChannel as JFaultyChannel
    from repro.transport import TransportClosed as JClosed
    from repro.wireformat import Frame as JFrame
    from repro.wireformat import encode_frame as jencode
    push = jencode(JFrame(kind=MSG_PUSH,
                          payload=np.zeros((8, WIRE_LANES), np.float32)))
    pull = jencode(JFrame(kind=MSG_PULL))
    for kw in ({"drop_kind": MSG_PUSH, "drop_prob": 0.5, "seed": 11},
               {"drop_prob": 0.2, "seed": 3}):
        plan = FaultPlan(**kw)
        for worker in (0, 4):
            ours = FaultyChannel(_CountingChannel(), plan, worker)
            theirs = JFaultyChannel(_CountingChannel(), plan, worker)
            got, want = [], []
            for i in range(48):
                frame = push if i % 3 else pull
                for ch, out, closed in ((ours, got, TransportClosed),
                                        (theirs, want, JClosed)):
                    try:
                        ch.request(frame)
                        out.append("ok")
                    except closed:
                        out.append("drop")
            assert got == want and "drop" in got and "ok" in got
            assert ours.inner.requests == theirs.inner.requests


# ============================================================ processes
def _spec_dict(tmp_path, **ft):
    return {
        "model": {"arch": ARCH, "smoke": True},
        "data": {"seq_len": 16, "global_batch": 2},
        "ps": {"kind": "sharded", "shards": 2, "workers": 2,
               "apply": "fused"},
        "wire": {"format": "packed", "delta_pull": True},
        "sync": {"mode": "dssp", "s_lower": 1, "s_upper": 4},
        "transport": {"kind": "tcp", "host": "127.0.0.1"},
        "obs": {"trace": True},
        "ft": dict({"dir": str(tmp_path / "ckpt"), "keep": 3,
                    "reconnect_tries": 12, "reconnect_base_s": 0.1,
                    "reconnect_max_s": 1.0}, **ft),
    }


def test_dssp_over_tcp_survives_a_server_sigkill_and_restart(tmp_path):
    """The server's own watchdog SIGKILLs it at push round 10; it is
    restarted on the same port, resumes from its latest snapshot, and
    both workers reconnect and finish every iteration.  The spilled
    trace holds the snapshot pauses and one failover span."""
    from repro_torch.api import RunSpec
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    # pushes delayed 40 ms each (the plan's delay fault): the snapshots,
    # every 50 ms, land between the first push and the kill even on a
    # loaded machine
    spec = RunSpec.from_dict(_spec_dict(
        tmp_path, snapshot_every_s=0.05, fault_kill_server_round=10,
        fault_delay_kind=MSG_PUSH, fault_delay_ms=40.0, fault_seed=7))
    spill = str(tmp_path / "spill")
    sp = ServerProcess(spec, trace_spill=spill, device="cpu",
                       start_timeout=CHILD_S)
    addr = sp.start()
    assert sp.resumed_step is None
    pool = ProcessWorkerPool(addr, WorkerTask.from_spec(
        spec, 12, device="cpu", trace_spill=spill), 2)
    pool.start()
    try:
        assert sp.wait_dead(CHILD_S), "the watchdog never fired"
        assert sp.restart() == addr
        assert sp.resumed_step is not None and sp.resumed_step > 0
        results = pool.join(timeout=CHILD_S)
        raise_on_failure(results)
        assert [r.iterations_done for r in results] == [12, 12]
        assert sum(r.reconnects for r in results) >= 2
    finally:
        pool.terminate()
        sp.stop()
        sp.kill()
    mgr = CheckpointManager(spec.ft.dir, keep=spec.ft.keep)
    with open(os.path.join(mgr._step_dir(mgr.latest_step()),
                           "manifest.json")) as f:
        extras = json.load(f)["extras"]
    for shard in extras["shards"]:
        assert shard["tracker"]["workers"] == []      # clean BYEs
    pushes = {int(w): c for w, c in extras["metrics"]["pushes"].items()}
    lost = max(0, 10 - sp.resumed_step) + 2
    assert set(pushes) == {0, 1}
    assert all(12 - lost <= pushes[w] <= 13 for w in (0, 1))
    losses = [p[2] for p in extras["metrics"]["loss_trajectory"]]
    assert len(losses) >= 12 and all(map(math.isfinite, losses))
    events = []
    for p in glob.glob(os.path.join(spill, "*.jsonl")):
        with open(p) as f:
            events.extend(json.loads(line) for line in f if line.strip())
    names = {e["name"] for e in events}
    assert {"snapshot", "snapshot_shard", "snapshot_write", "failover",
            "reconnect", "compute_step", "fault"} <= names
    failover = [e for e in events if e["name"] == "failover"]
    assert len(failover) == 1
    assert failover[0]["args"]["step"] == sp.resumed_step
    # the workers' MSG_TRACE batches reached the server process too
    framed = {e["src"] for p in glob.glob(os.path.join(
        spill, "frames-server*.jsonl")) for e in map(json.loads, open(p))
        if e["name"] == "compute_step"}
    assert framed == {"w0", "w1"}


def test_worker_killed_while_gated_frees_its_seat_and_is_respawned():
    """BSP over tcp: worker 1 SIGKILLs itself at iteration 2 while
    worker 0 waits on it.  The corpse's seat is freed, the replacement
    takes it back exactly once (a duplicate seat would hang the BSP
    barrier), and both finish."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    from repro_torch.models import registry
    from repro_torch.transport import PSServerEndpoint, make_transport
    cfg = get_smoke_config(ARCH)
    server = ShardedParameterServer(
        registry.init_params(cfg, seed=0, device="cpu"),
        make_policy_factory("bsp", n_workers=2),
        lambda: ServerOptimizer(lr=0.01), 2, 2, apply_mode="fused")
    endpoint = PSServerEndpoint(server)
    transport = make_transport("tcp", n_workers=2)
    transport.serve(endpoint)
    task = WorkerTask(arch=ARCH, n_shards=2, n_iterations=4, seq_len=16,
                      global_batch=2, device="cpu",
                      fault_plan=FaultPlan(kill_worker=1,
                                           kill_worker_round=2).to_dict())
    pool = ProcessWorkerPool(transport.address(), task, 2)
    pool.start()
    try:
        results = pool.join(timeout=CHILD_S, endpoint=endpoint, respawn=1)
        raise_on_failure(results)
        assert pool.respawned == [1]
        assert [r.iterations_done for r in results] == [4, 4]
        for st in server.shards:
            assert st.tracker.workers == []
        assert server.metrics.pushes[0] == 4
        assert server.metrics.pushes[1] >= 4       # the corpse's + rerun
    finally:
        pool.terminate()
        server.stop()
        transport.shutdown()


def test_sigkill_mid_migration_resumes_untorn_and_finishes_the_move(
        tmp_path):
    """The server's FaultPlan SIGKILLs it INSIDE a live reshard 2 -> 3
    (old shards copied out, before the swap).  The restart resumes from
    a pre-migration snapshot, its re-armed trigger finishes the move,
    and both workers complete; every snapshot on disk is of one plan."""
    from repro_torch.api import RunSpec
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    spec = RunSpec.from_dict(_spec_dict(
        tmp_path, snapshot_every_s=0.05, reshard_shards=3,
        reshard_round=8, fault_kill_mid_reshard=True,
        fault_delay_kind=MSG_PUSH, fault_delay_ms=40.0, fault_seed=7))
    sp = ServerProcess(spec, device="cpu", start_timeout=CHILD_S)
    addr = sp.start()
    pool = ProcessWorkerPool(addr, WorkerTask.from_spec(
        spec, 12, device="cpu"), 2)
    pool.start()
    try:
        assert sp.wait_dead(CHILD_S), "the mid-migration kill never fired"
        assert sp.restart() == addr
        assert sp.resumed_step is not None and sp.resumed_step > 0
        results = pool.join(timeout=CHILD_S)
        raise_on_failure(results)
        assert [r.iterations_done for r in results] == [12, 12]
        assert all(r.rebuilds >= 1 for r in results)
    finally:
        pool.terminate()
        sp.stop()
        sp.kill()
    mgr = CheckpointManager(spec.ft.dir, keep=spec.ft.keep)
    steps = mgr.steps()
    for s in steps:
        ex = mgr.peek_extras(s)
        assert len(ex["shards"]) == ex["n_shards"] == len(ex["versions"])
        assert (ex["n_shards"], ex["reshard_epoch"] >= 1) in \
            ((2, False), (3, True))
    final = mgr.peek_extras(steps[-1])
    assert final["n_shards"] == 3
    losses = [p[2] for p in final["metrics"]["loss_trajectory"]]
    assert len(losses) >= 12 and all(map(math.isfinite, losses))


def test_a_reply_cut_mid_frame_is_a_dead_connection():
    """A server SIGKILLed while it sends a large reply leaves the client
    a short read: the tcp channel reports a closed transport (what the
    worker's reconnect path retries), not a malformed frame."""
    import socket
    import threading

    from repro_torch.transport.tcp import TcpChannel
    from repro_torch.wireformat import MSG_ECHO, Frame, encode_frame
    reply = encode_frame(Frame(kind=MSG_ECHO,
                               payload=torch.ones(64, WIRE_LANES)))
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]

    def serve_half():
        conn, _ = listener.accept()
        with conn:
            conn.recv(1 << 16)
            conn.sendall(reply[:len(reply) // 2])   # then the server dies

    t = threading.Thread(target=serve_half, daemon=True)
    t.start()
    channel = TcpChannel("127.0.0.1", port)
    try:
        with pytest.raises(TransportClosed, match="short read"):
            channel.request(encode_frame(Frame(kind=MSG_ECHO)))
    finally:
        channel.close()
        listener.close()
        t.join(timeout=10.0)
    assert not t.is_alive()
