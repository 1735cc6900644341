"""The port's transports across real process boundaries, on the CPU.

Counterparts of ``tests/test_transport.py`` for ``repro_torch.transport``:
bitwise echo and pull across a spawned process over tcp and shmem, a
spawned push landing bit for bit like a local push, per-shard routing
across two endpoints, a killed worker freeing its barrier seat, error
replies to a garbage header and an oversized length, shutdown releasing
gated DSSP workers; then the cross-package runs over tcp (the
reference's worker processes against the port's endpoint, and the
port's against the reference's; a serving replica of each package
subscribed to the other's endpoint), and a 3-worker DSSP
``ps-transport`` session against the ``ps-threads`` session of the same
spec.

Every spawned child runs under a deadline (``q.get(timeout=...)``,
``join(timeout=...)``, the pool's ``join`` timeout), so a hang fails
the test instead of eating the suite's limit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import multiprocessing
import os
import socket
import struct
import threading
import time

import pytest
import torch

from repro_torch import api
from repro_torch import wireformat as tw
from repro_torch.core.policies import make_policy_factory
from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                          raise_on_failure)
from repro_torch.models import registry
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.plan import build_shard_plan
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.transport import (PSServerEndpoint, ShardRouter,
                                   TransportClosed, connect, make_transport)

torch.set_num_threads(2)

#: every spawned child's deadline, seconds
CHILD_S = 180.0


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Spawned children inherit the environment: two threads each, so
    concurrent workers do not oversubscribe the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


# ---------------------------------------------------------------- helpers
def tiny_params():
    return {"w": torch.ones(48, 32), "b": torch.zeros(17)}


def make_server(n_workers=1, n_shards=2, policy="asp"):
    return ShardedParameterServer(
        tiny_params(),
        make_policy_factory(policy, n_workers=n_workers, staleness=2,
                            s_lower=0, s_upper=2),
        lambda: ServerOptimizer(lr=0.05), n_workers, n_shards,
        apply_mode="fused")


def serve(kind, server, n_workers=1, shards=None):
    endpoint = PSServerEndpoint(server, shards=shards)
    transport = make_transport(kind, n_workers=n_workers)
    transport.serve(endpoint)
    return endpoint, transport


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def seeded(rows: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, tw.WIRE_LANES, generator=g)


def spawn(target, *args):
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=target, args=(*args, q), daemon=True)
    p.start()
    return p, q


def finish(p, q):
    try:
        return q.get(timeout=CHILD_S)
    finally:
        p.join(timeout=30.0)
        if p.is_alive():
            p.terminate()


# ============================================= process-boundary round trip
def _echo_child(address, seed, q):
    try:
        client = connect(address, 0)
        rows = client.hello()
        buf = seeded(rows, seed)
        back = client.echo(buf)
        back8 = client.echo(buf, compress="int8")
        pulled = client.pull_packed()
        client.bye()
        client.close()
        q.put({"echo": digest(back), "echo8": digest(back8),
               "pull": digest(pulled), "rows": rows})
    except BaseException as e:
        q.put({"error": repr(e)})


@pytest.mark.parametrize("kind", ["tcp", "shmem"])
def test_bitwise_roundtrip_across_process_boundary(kind):
    server = make_server()
    endpoint, transport = serve(kind, server)
    rows = server.plan.wire_layout().total_rows
    got = finish(*spawn(_echo_child, transport.address(), 42))
    server.stop()
    transport.shutdown()
    assert "error" not in got, got
    assert got["rows"] == rows
    buf = seeded(rows, 42)
    assert got["echo"] == digest(buf)
    # int8 is lossy but deterministic: the local quantize/dequantize is
    # bitwise what came back over the wire
    deq = tw.decode_frame(tw.encode_frame(
        tw.Frame(kind=tw.MSG_ECHO, payload=buf), compress="int8")).payload
    assert got["echo8"] == digest(deq)
    assert got["pull"] == digest(server.pull_packed())


def _push_child(address, seed, q):
    try:
        client = connect(address, 0)
        rows = client.hello()
        ok = client.push_packed(seeded(rows, seed))
        after = client.pull_packed()
        client.bye()
        client.close()
        q.put({"ok": ok, "after": digest(after)})
    except BaseException as e:
        q.put({"error": repr(e)})


@pytest.mark.parametrize("kind", ["tcp", "shmem"])
def test_push_across_boundary_matches_local_push(kind):
    """A spawned process's push lands bit-identically to the same push
    made locally (the full pull-push-apply-pull cycle)."""
    remote, local = make_server(), make_server()
    endpoint, transport = serve(kind, remote)
    rows = remote.plan.wire_layout().total_rows
    got = finish(*spawn(_push_child, transport.address(), 7))
    remote.stop()
    transport.shutdown()
    assert "error" not in got, got
    assert got["ok"]
    local.push_packed(0, seeded(rows, 7))
    assert got["after"] == digest(local.pull_packed())


# ==================================================== shard-routed endpoints
def test_per_shard_routing_across_two_endpoints():
    """Different shards behind different endpoints (even different
    backends) apply exactly like one full-buffer push."""
    routed, mono = make_server(), make_server()
    layout = routed.plan.wire_layout()
    ep0, t0 = serve("tcp", routed, shards=[0])
    ep1, t1 = serve("shmem", routed, n_workers=1, shards=[1])
    c0, c1 = t0.connect(0), t1.connect(0)
    c0.hello(), c1.hello()
    router = ShardRouter({0: c0, 1: c1}, layout.shard_rows)
    wire = seeded(layout.total_rows, 5)
    assert router.push_packed(wire)
    mono.push_packed(0, wire.clone())
    assert torch.equal(router.pull_packed(), mono.pull_packed())
    assert routed.shard_versions() == mono.shard_versions()
    # frames for a shard an endpoint does not serve are rejected
    with pytest.raises(tw.FrameError):
        c0.pull_packed(shard=1)
    with pytest.raises(tw.FrameError):
        c0.pull_packed()  # routed endpoints require an explicit shard
    c0.close(), c1.close()
    routed.stop(), mono.stop()
    t0.shutdown(), t1.shutdown()


# ========================================================== failure paths
def _truncating_child(address, q):
    """Connects, HELLOs, then sends HALF a push frame and dies."""
    try:
        client = connect(address, 0)
        rows = client.hello()
        raw = tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, worker=0,
                                       payload=torch.ones(rows, 512)))
        client.channel._sock.sendall(raw[:len(raw) // 2])
        q.put("sent-half")
    except BaseException as e:
        q.put(f"error {e!r}")
    q.close()
    q.join_thread()
    os._exit(1)


def test_worker_killed_mid_push_frees_its_barrier_seat():
    server = make_server(n_workers=2, policy="bsp")
    endpoint, transport = serve("tcp", server)
    assert finish(*spawn(_truncating_child, transport.address())) == \
        "sent-half"
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if all(0 not in st.tracker.counts for st in server.shards):
            break
        time.sleep(0.05)
    assert all(0 not in st.tracker.counts for st in server.shards), \
        "dead worker still holds a barrier seat"
    # worker 1's BSP push does not block on the corpse
    c1 = transport.connect(1)
    c1.hello()
    rows = server.plan.wire_layout().total_rows
    t0 = time.monotonic()
    assert c1.push_packed(torch.zeros(rows, 512))
    assert time.monotonic() - t0 < 10.0
    c1.bye()
    c1.close()
    server.stop()
    transport.shutdown()


def test_tcp_garbage_header_gets_error_reply():
    server = make_server()
    endpoint, transport = serve("tcp", server)
    _, host, port = transport.address()
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(b"GARBAGE!" * 8)
        reply = sock.recv(1 << 16)
    frame = tw.decode_frame(reply)
    assert frame.kind == tw.MSG_ERR and "magic" in frame.error
    # the server keeps serving fresh connections
    c = transport.connect(0)
    c.hello()
    assert c.echo(torch.ones(8, 512)).shape == (8, 512)
    c.close()
    server.stop()
    transport.shutdown()


def test_tcp_oversized_length_field_rejected():
    server = make_server()
    endpoint, transport = serve("tcp", server)
    _, host, port = transport.address()
    raw = bytearray(tw.encode_frame(tw.Frame(
        kind=tw.MSG_PUSH, worker=0, payload=torch.zeros(8, 512))))
    struct.pack_into("<Q", raw, 28, tw.MAX_PAYLOAD + 1)
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(bytes(raw))
        frame = tw.decode_frame(sock.recv(1 << 16))
    assert frame.kind == tw.MSG_ERR and "exceeds" in frame.error
    server.stop()
    transport.shutdown()


def test_push_stamped_with_a_reshard_epoch_is_refused_naming_item_8():
    """A push stamped with a reshard epoch the server never issued is
    refused with the retryable "resync" error (before the item-8 slice,
    every stamped push was refused naming the item)."""
    server = make_server()
    endpoint, transport = serve("inproc", server)
    c = transport.connect(0)
    c.hello()
    c.reshard_epoch = 1
    with pytest.raises(tw.FrameError, match="resync"):
        c.push_packed(torch.zeros(server.plan.wire_layout().total_rows, 512))
    server.stop()
    transport.shutdown()


def test_pull_cache_keeps_one_host_copy_per_shard_version():
    """W workers pulling the same state cost one device-to-host copy:
    the endpoint keeps one host copy per (shard, epoch, version), for
    delta regions and full pulls alike, and replaces it when the shard
    advances."""
    server = make_server(n_workers=2)
    endpoint, transport = serve("inproc", server, n_workers=2)
    fetched = []
    real_host = endpoint._host

    def counting_host(key, epoch, version, fetch):
        def counted():
            fetched.append((key, version))
            return fetch()
        return real_host(key, epoch, version, counted)

    endpoint._host = counting_host
    a, b = transport.connect(0), transport.connect(1)
    a.hello(), b.hello()
    da, db = a.pull_delta((-1, -1)), b.pull_delta((-1, -1))
    assert fetched == [(0, 0), (1, 0)]
    assert all(torch.equal(x, y) for x, y in zip(da.regions, db.regions))
    a.pull_packed(), b.pull_packed()
    assert fetched[2:] == [(-1, 0)]
    rows = server.plan.wire_layout().total_rows
    assert a.push_packed(torch.ones(rows, 512))
    b.pull_delta(db.versions)
    assert fetched[3:] == [(0, 1), (1, 1)]
    a.bye(), b.bye()
    server.stop()
    transport.shutdown()


@pytest.mark.parametrize("kind", ["tcp", "shmem"])
def test_clean_shutdown_unblocks_waiting_dssp_workers(kind):
    """A DSSP worker blocked in the gate (too far ahead of a silent peer)
    is released by server.stop() with a STOP reply."""
    server = make_server(n_workers=2, policy="dssp")
    endpoint, transport = serve(kind, server, n_workers=2)
    rows = server.plan.wire_layout().total_rows
    released = threading.Event()
    state = {}

    def runner():
        c = transport.connect(0)
        c.hello()
        alive = True
        for i in range(50):  # hits the DSSP upper threshold long before 50
            alive = c.push_packed(torch.zeros(rows, 512), clock=i)
            if not alive:
                break
        state["alive"] = alive
        released.set()
        c.close()

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    time.sleep(1.0)
    assert not released.is_set(), "worker was never gated — bad setup"
    server.stop()
    assert released.wait(timeout=15.0), \
        "stop() did not unblock the gated DSSP worker"
    assert state["alive"] is False  # the release was a STOP, not an OK
    t.join(timeout=10.0)
    transport.shutdown()


def test_subscriber_takes_no_seat_and_trace_frames_are_dropped():
    """A ``MSG_SUB`` replica pulls without a barrier seat (BSP keeps
    releasing the one trainer); TRACE flushes to an endpoint without a
    collector are acknowledged and dropped."""
    server = make_server(n_workers=1, policy="bsp")
    endpoint, transport = serve("tcp", server, n_workers=2)
    trainer, replica = transport.connect(0), transport.connect(1)
    rows = trainer.hello()
    assert replica.subscribe() == rows
    assert all(st.tracker.workers == [0] for st in server.shards)
    trainer.send_trace([{"name": "compute_step", "worker": 0}])
    for i in range(3):      # BSP would block on a seated silent peer
        assert trainer.push_packed(torch.zeros(rows, 512), clock=i)
    d = replica.pull_delta((-1, -1))
    assert d.versions == (3, 3)
    replica.close()         # a dead replica frees nothing it never held
    trainer.bye()
    trainer.close()
    server.stop()
    transport.shutdown()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_client_reconnect_reacquires_its_seat_once():
    """After the server's transport dies and comes back on the same
    port, ``reconnect`` rebuilds the channel with backoff and re-HELLOs;
    the seat exists exactly once and the wire works end to end."""
    from repro_torch.ft.backoff import BackoffPolicy, retry
    from repro_torch.transport.tcp import TcpTransport
    server = make_server()
    endpoint = PSServerEndpoint(server)
    port = _free_port()
    first = TcpTransport("127.0.0.1", port)
    first.serve(endpoint)
    client = connect(("tcp", "127.0.0.1", port), 0)
    rows = client.hello()
    first.shutdown()
    with pytest.raises((TransportClosed, OSError)):
        for _ in range(4):                  # the first recv may drain
            client.pull_packed()
    client.channel.close()

    def rebind():
        t = TcpTransport("127.0.0.1", port)
        t.serve(endpoint)
        return t

    second = retry(rebind, BackoffPolicy(base_s=0.05, max_s=0.5,
                                         max_tries=10))
    try:
        policy = BackoffPolicy(base_s=0.05, max_s=0.4, max_tries=8)
        assert client.reconnect(policy) == rows
        assert client.reconnects == 1
        assert all(st.tracker.workers == [0] for st in server.shards)
        assert client.push_packed(seeded(rows, 1))
        client.bye()
        client.close()
    finally:
        server.stop()
        second.shutdown()


def test_client_surfaces_shutdown_as_transport_closed():
    server = make_server()
    endpoint, transport = serve("tcp", server)
    c = transport.connect(0)
    c.hello()
    server.stop()
    transport.shutdown()
    with pytest.raises((TransportClosed, tw.FrameError)):
        for _ in range(3):  # first call may still see a buffered STOP
            c.pull_packed()
    c.close()


# ====================================================== worker processes
def _spec(mod, *, kind="tcp", workers=2, sync="dssp", shards=2,
          straggler=1.0, lr=3e-3, s_lower=1, s_upper=4, compression="none",
          endpoint=False):
    return mod.RunSpec(
        model=mod.ModelSpec(arch="h2o-danube-1.8b", smoke=True),
        data=mod.DataSpec(seq_len=32, global_batch=4, seed=3),
        optimizer=mod.OptimizerSpec(lr=lr, momentum=0.9),
        sync=mod.SyncSpec(mode=sync, s_lower=s_lower, s_upper=s_upper),
        ps=mod.ServerSpec(kind="sharded", shards=shards, workers=workers,
                          apply="fused", straggler=straggler),
        wire=mod.WireSpec(format="packed", delta_pull=True,
                          compression=compression),
        transport=mod.TransportSpec(kind=kind, endpoint=endpoint))


def _losses(server):
    return [loss for _, _, loss in server.metrics.loss_trajectory]


@pytest.mark.parametrize("kind,compression", [
    ("tcp", "none"), ("shmem", "none"), ("tcp", "int8")])
def test_transport_session_trains_with_spawned_workers(kind, compression):
    """``ps-transport`` with 2 spawned workers: every push applied, no
    release past s_upper, losses finite, each worker's diagnostics
    filled in (CPU: no launches, no device memory)."""
    spec = _spec(api, kind=kind, compression=compression, straggler=2.0)
    assert spec.engine == "ps-transport"
    with api.build_session(spec, device="cpu", timeout=CHILD_S) as s:
        m = s.run(8)
    assert m["iterations_done"] == 8 and m["pushes"] == 8
    assert s.server.version == 8 * 2          # every shard, every push
    assert m["max_staleness"] <= spec.sync.s_upper + 1
    losses = _losses(s.server)
    assert len(losses) == 8 and all(map(math.isfinite, losses))
    for r in s.results:
        assert r.error is None and r.iterations_done == 4
        assert len(r.compute_s) == len(r.push_s) == 4
        assert r.launches and not any(r.launches.values())
        assert r.peak_memory_bytes == 0
        # int8 frames carry a byte per element, the f32 wire four
        per = 1 if compression == "int8" else 4
        rows = s.server.plan.wire_layout().total_rows
        assert r.push_bytes == [tw.HEADER_SIZE + rows * 512 * per] * 4


def test_external_workers_drive_an_inproc_endpoint():
    """``transport.endpoint=True`` over inproc: the session serves the
    frame protocol to the caller's own client; ``run`` refuses, and
    ``reshard`` migrates the served store (a no-op at the same arity)."""
    spec = _spec(api, kind="inproc", endpoint=True, workers=1)
    assert spec.engine == "ps-transport"
    session = api.build_session(spec, device="cpu", external_workers=True)
    try:
        client = connect(session.address(), 0)
        rows = client.hello()
        assert rows == session.server.plan.wire_layout().total_rows
        d = client.pull_delta((-1,) * spec.ps.shards)
        assert d.shards == tuple(range(spec.ps.shards))
        wire = torch.cat([r for r in d.regions])
        assert torch.equal(wire, session.server.pull_packed())
        assert client.push_packed(torch.ones(rows, 512), clock=0)
        assert session.server.version == spec.ps.shards
        again = client.pull_delta(d.versions)
        assert again.shards == tuple(range(spec.ps.shards))
        assert session.reshard(3) is True
        assert session.reshard(3) is False
        d = client.pull_delta(again.versions)
        assert d.full and d.epoch == 1 and len(d.versions) == 3
        client.bye()
        with pytest.raises(api.SpecError, match="external_workers"):
            session.run(2)
    finally:
        session.close()


def test_worker_without_cuda_raises():
    """A worker given ``cuda:0`` where there is none raises; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the worker would run")
    server = make_server()
    endpoint, transport = serve("tcp", server)
    task = WorkerTask(arch="h2o-danube-1.8b", n_shards=2, n_iterations=1,
                      device="cuda:0")
    pool = ProcessWorkerPool(transport.address(), task, 1)
    pool.start()
    results = pool.join(timeout=CHILD_S, endpoint=endpoint)
    server.stop()
    transport.shutdown()
    assert "no CUDA device" in (results[0].error or "")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raise_on_failure(results)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "jamba-v0.1-52b"])
def test_worker_plan_from_shapes_equals_plan_from_weights(arch):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    for n_shards in (1, 4):
        meta = build_shard_plan(registry.abstract_params(cfg), n_shards)
        real = build_shard_plan(registry.init_params(cfg, device="cpu"),
                                n_shards)
        assert meta.shards == real.shards
        assert meta.leaf_shapes == real.leaf_shapes
        assert meta.leaf_dtypes == real.leaf_dtypes
        assert meta.wire_layout() == real.wire_layout()


def test_full_width_single_frame_depth_limit():
    """One full-width h2o-danube-1.8b pull (S=4, bf16) fits the 2 GiB
    frame limit at 12 layers and at 13 (the chip phase's cut, the
    deepest that fits), not at 14 or the published 24."""
    from repro_torch.configs import get_config
    full = get_config("h2o-danube-1.8b")

    def frame_bytes(n_layers):
        cfg = dataclasses.replace(full, n_layers=n_layers)
        layout = build_shard_plan(registry.abstract_params(cfg),
                                  4).wire_layout()
        return layout.total_rows * tw.WIRE_LANES * 2

    assert frame_bytes(12) == 1_995_055_104 <= tw.MAX_PAYLOAD
    assert frame_bytes(13) == 2_133_999_616 <= tw.MAX_PAYLOAD
    assert tw.MAX_PAYLOAD < frame_bytes(14)
    assert frame_bytes(24) > tw.MAX_PAYLOAD


def test_full_width_frame_still_fits_after_a_reshard_to_six_shards():
    """The 13-layer cut resharded S=4 -> S'=6 (the ft chip phase): each
    extra shard region pads by less than one (8, 512) tile, so the full
    pull after the migration — and a worker's full resync after a
    failover — is still one frame under the 2 GiB limit."""
    from repro_torch.configs import get_config
    cut = dataclasses.replace(get_config("h2o-danube-1.8b"), n_layers=13)
    plan = build_shard_plan(registry.abstract_params(cut), 4)
    before = plan.wire_layout().total_rows * tw.WIRE_LANES
    after_plan = plan.rebuild(6)
    after = after_plan.wire_layout().total_rows * tw.WIRE_LANES
    assert after_plan.wire_layout().total_elems == \
        plan.wire_layout().total_elems
    assert after - plan.wire_layout().total_elems <= 6 * (8 * 512 - 1)
    assert before * 2 == 2_133_999_616
    assert after * 2 <= tw.MAX_PAYLOAD


# ========================================================= cross-package
def test_reference_workers_train_against_the_port_endpoint():
    """The reference's ``ProcessWorkerPool`` (JAX on the CPU) pushes and
    pulls its frames into the port's endpoint over tcp."""
    from repro.launch import proc_pool as jpool
    spec = _spec(api, workers=2)
    session = api.build_session(spec, device="cpu", external_workers=True)
    try:
        task = jpool.WorkerTask(arch="h2o-danube-1.8b", n_shards=2,
                                n_iterations=2, smoke=True, seq_len=32,
                                global_batch=4, data_seed=3,
                                delta_pull=True)
        pool = jpool.ProcessWorkerPool(session.address(), task, 2)
        pool.start()
        results = pool.join(timeout=CHILD_S, endpoint=session.endpoint)
        pool.terminate()
        jpool.raise_on_failure(results)
        assert [r.iterations_done for r in results] == [2, 2]
        assert session.server.version == 4 * 2
        losses = _losses(session.server)
        assert len(losses) == 4 and all(map(math.isfinite, losses))
    finally:
        session.close()


def test_port_workers_train_against_the_reference_endpoint():
    """The port's ``ProcessWorkerPool`` (``device='cpu'``) pushes and
    pulls its frames into the reference's endpoint over tcp."""
    import repro.api as japi
    session = japi.build_session(_spec(japi, workers=2),
                                 external_workers=True)
    try:
        task = WorkerTask(arch="h2o-danube-1.8b", n_shards=2,
                          n_iterations=2, smoke=True, seq_len=32,
                          global_batch=4, data_seed=3, delta_pull=True,
                          device="cpu")
        pool = ProcessWorkerPool(session.address(), task, 2)
        pool.start()
        results = pool.join(timeout=CHILD_S, endpoint=session.endpoint)
        pool.terminate()
        raise_on_failure(results)
        assert [r.iterations_done for r in results] == [2, 2]
        assert session.server.version == 4 * 2
        losses = _losses(session.server)
        assert len(losses) == 4 and all(map(math.isfinite, losses))
    finally:
        session.close()


def _train_and_serve(address, endpoint, replica_pool):
    """The port's 2 worker processes train through ``address`` while
    ``replica_pool`` (one replica, either package's) serves; returns the
    replica's results."""
    task = WorkerTask(arch="h2o-danube-1.8b", n_shards=2, n_iterations=4,
                      smoke=True, seq_len=32, global_batch=4, data_seed=3,
                      delta_pull=True, device="cpu")
    pool = ProcessWorkerPool(address, task, 2)
    pool.start()
    replica_pool.start()
    try:
        results = pool.join(timeout=CHILD_S, endpoint=endpoint)
        served = replica_pool.join(timeout=CHILD_S, endpoint=endpoint)
    finally:
        pool.terminate()
        replica_pool.terminate()
    raise_on_failure(results)
    return served


#: one replica's serving load in the cross-package runs
_SERVE = dict(requests=4, start_at_version=1, prompt_len=8, max_new=4,
              max_batch=4, staleness_bound=4, refresh_every_s=0.05,
              data_seed=3)


def test_port_replica_serves_from_the_reference_endpoint():
    """A port replica process (``device='cpu'``) subscribes to the
    reference's tcp endpoint with ``MSG_SUB`` and serves from its delta
    pulls while the port's workers train into it."""
    import repro.api as japi
    from repro_torch.serve import (ReplicaPool, ReplicaTask,
                                   aggregate_serve,
                                   raise_on_replica_failure)
    session = japi.build_session(_spec(japi, workers=2),
                                 external_workers=True)
    try:
        rpool = ReplicaPool(session.address(), ReplicaTask(
            arch="h2o-danube-1.8b", n_shards=2, device="cpu", **_SERVE),
            1, first_id=2)
        served = _train_and_serve(session.address(), session.endpoint,
                                  rpool)
        raise_on_replica_failure(served)
        agg = aggregate_serve(served)
        assert agg["requests"] == 4 and agg["violations"] == 0, agg
        assert agg["version_max"] > 0, agg
        assert session.server.version == 8 * 2
    finally:
        session.close()


def test_reference_replica_serves_from_the_port_endpoint():
    """A reference replica process (JAX on the CPU) subscribes to the
    port's tcp endpoint and serves from its delta pulls while the port's
    workers train into it."""
    from repro.serve import ReplicaPool as JReplicaPool
    from repro.serve import ReplicaTask as JReplicaTask
    from repro.serve import aggregate_serve as jaggregate
    from repro.serve import raise_on_replica_failure as jraise
    session = api.build_session(_spec(api, workers=2), device="cpu",
                                external_workers=True)
    try:
        rpool = JReplicaPool(session.address(), JReplicaTask(
            arch="h2o-danube-1.8b", n_shards=2, **_SERVE), 1, first_id=2)
        served = _train_and_serve(session.address(), session.endpoint,
                                  rpool)
        jraise(served)
        agg = jaggregate(served)
        assert agg["requests"] == 4 and agg["violations"] == 0, agg
        assert agg["version_max"] > 0, agg
        assert session.server.version == 8 * 2
    finally:
        session.close()


def test_tcp_processes_match_threads():
    """3 spawned DSSP workers over tcp reach the threaded session's final
    loss on the same spec, within the reference test's asynchrony
    tolerance (``max(0.15 |loss|, 0.15)``)."""
    kw = dict(workers=3, sync="dssp", shards=2, straggler=1.5, lr=0.02,
              s_lower=0, s_upper=3)
    with api.build_session(_spec(api, kind="inproc", **kw),
                           device="cpu") as s:
        s.run(24)
        threads = _losses(s.server)
    with api.build_session(_spec(api, kind="tcp", **kw), device="cpu",
                           timeout=CHILD_S) as s:
        s.run(24)
        procs = _losses(s.server)
        assert s.server.version > 0 and s.server.metrics.total_pushes >= 3
    assert threads and procs
    fin_t, fin_p = threads[-1], procs[-1]
    assert math.isfinite(fin_t) and math.isfinite(fin_p)
    assert abs(fin_p - fin_t) <= max(0.15 * abs(fin_t), 0.15), (fin_t, fin_p)
