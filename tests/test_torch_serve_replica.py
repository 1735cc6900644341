"""The port's serving tier on the CPU: the ``MSG_SUB`` no-seat rule, the
resident buffer's delta refreshes (bit for bit a full pull, rebuilt by a
live reshard), the freshness admission gate, the batching queue, and
training while serving, in the ``ps-threads`` engine and over tcp with
spawned replica processes.

Counterparts of ``tests/test_serving.py``'s ``TestSubscription``,
``TestRefresh``, ``TestBatchQueue`` and e2e tests, against
``repro_torch.serve``.  The e2e runs are timing-dependent in the
reference (ROADMAP queue 3): they assert mechanisms and counts, never
times.  Every thread and child is joined under a deadline.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import wireformat as wf
from repro_torch.configs import get_smoke_config
from repro_torch.core.policies import make_policy_factory
from repro_torch.obs.trace import TRACE
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.serve import (BatchQueue, DecodeRequest, Decoder,
                               DirectSubscription, ParamSubscriber,
                               Refresher, ReplicaResult, ReplicaTask,
                               ReplicaWorker, TransportSubscription,
                               aggregate_serve, bootstrap_versions)
from repro_torch.transport import PSServerEndpoint, make_transport

torch.set_num_threads(2)

#: deadline of every join, seconds
JOIN_S = 180.0


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Spawned children inherit the environment: two threads each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


# ---------------------------------------------------------------- helpers
def tiny_params():
    return {"w": torch.ones(48, 32), "b": torch.zeros(17)}


def make_server(n_workers=1, n_shards=2, policy="asp", params=None):
    return ShardedParameterServer(
        tiny_params() if params is None else params,
        make_policy_factory(policy, n_workers=n_workers, staleness=2,
                            s_lower=0, s_upper=2),
        lambda: ServerOptimizer(lr=0.05), n_workers, n_shards,
        apply_mode="fused")


def make_subscriber(server, replica_id=9):
    layout = server.plan.wire_layout()
    sub = DirectSubscription(server, replica_id)
    return ParamSubscriber(sub, layout, replica_id=replica_id,
                           device="cpu"), layout


def push_random(server, rng, layout, worker=0):
    g = rng.randn(layout.total_rows, wf.WIRE_LANES).astype(np.float32)
    server.push_packed(worker, torch.from_numpy(g))


def wait_version(server, target, timeout=10.0):
    deadline = time.monotonic() + timeout
    while server.version < target:
        if time.monotonic() > deadline:
            raise TimeoutError(f"server stuck at {server.version} < "
                               f"{target}")
        time.sleep(0.002)


def full_wire(server):
    return server.pull_packed(0)


# ============================================================ MSG_SUB
class TestSubscription:
    def test_sub_frame_codec_roundtrip(self):
        f = wf.Frame(kind=wf.MSG_SUB, worker=5)
        g = wf.decode_frame(wf.encode_frame(f))
        assert (g.kind, g.worker) == (wf.MSG_SUB, 5)

    def test_subscriber_takes_no_barrier_seat(self):
        """2 BSP workers must release with a subscriber present: had the
        SUB taken a seat, the round barrier would wait for a third push
        that never comes."""
        server = make_server(n_workers=2, policy="bsp")
        endpoint = PSServerEndpoint(server)
        for w in (0, 1):
            r = endpoint.handle(wf.Frame(kind=wf.MSG_HELLO, worker=w))
            assert r.kind == wf.MSG_OK
        r = endpoint.handle(wf.Frame(kind=wf.MSG_SUB, worker=9))
        assert r.kind == wf.MSG_OK
        assert r.clock == server.version
        wire = torch.zeros((endpoint.wire_rows(), wf.WIRE_LANES))
        replies = []

        def push(w):
            replies.append(endpoint.handle(
                wf.Frame(kind=wf.MSG_PUSH, worker=w, payload=wire)).kind)

        threads = [threading.Thread(target=push, args=(w,))
                   for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads), \
            "BSP round blocked: the subscriber took a barrier seat"
        assert replies == [wf.MSG_OK, wf.MSG_OK]
        server.stop()

    def test_dead_subscriber_is_not_removed_as_worker(self):
        server = make_server(n_workers=2)
        endpoint = PSServerEndpoint(server)
        endpoint.handle(wf.Frame(kind=wf.MSG_HELLO, worker=0))
        endpoint.handle(wf.Frame(kind=wf.MSG_SUB, worker=9))
        removed = []
        orig = server.remove_worker
        server.remove_worker = lambda w: (removed.append(w), orig(w))
        endpoint.on_disconnect(9)   # subscriber: unregister only
        assert removed == []
        endpoint.on_disconnect(0)   # worker: its seat is freed
        assert removed == [0]
        server.stop()

    def test_sub_rejected_on_per_shard_endpoint(self):
        server = make_server(n_shards=2)
        endpoint = PSServerEndpoint(server, shards=[0])
        r = endpoint.handle(wf.Frame(kind=wf.MSG_SUB, worker=9))
        assert r.kind == wf.MSG_ERR
        assert "full-store" in r.error
        server.stop()

    def test_transport_subscription_refreshes_bitwise_over_tcp(self):
        """A replica over tcp: SUB, then delta refreshes copied out of
        the receive buffer into the resident buffer, bit for bit the
        server's store; the reply views are dropped after each copy."""
        server = make_server(n_workers=1, n_shards=3)
        server.add_worker(0)
        endpoint = PSServerEndpoint(server)
        transport = make_transport("tcp", n_workers=2)
        transport.serve(endpoint)
        try:
            client = transport.connect(1)
            sub = TransportSubscription(client, 3)
            layout = server.plan.wire_layout()
            assert sub.rows == layout.total_rows
            ps = ParamSubscriber(sub, layout, replica_id=1, device="cpu")
            assert ps.refresh() and ps.full_refreshes == 0
            rng = np.random.RandomState(0)
            for i in range(3):
                push_random(server, rng, layout)
                wait_version(server, (i + 1) * 3)
                assert ps.refresh()
                buf, ver = ps.snapshot()
                assert torch.equal(buf, full_wire(server))
                assert ver == server.version
            assert ps.refresh_bytes == 4 * layout.total_rows * 512 * 4
            server.stop()
            assert not ps.refresh() and ps.stopped
            sub.close()
        finally:
            server.stop()
            transport.shutdown()


# ============================================================ refresh
class TestRefresh:
    def test_unbootstrapped_is_never_fresh(self):
        server = make_server()
        ps, _ = make_subscriber(server)
        assert ps.versions == bootstrap_versions(2)
        assert ps.staleness() == ParamSubscriber.UNBOOTSTRAPPED
        assert ps.refresh()
        assert ps.staleness() == 0
        server.stop()

    def test_unbootstrapped_gate_waits_for_the_first_refresh(self):
        """No bound admits an all-zeros buffer: the gate blocks until
        the bootstrap full snapshot lands."""
        server = make_server()
        ps, _ = make_subscriber(server)
        admitted = []
        t = threading.Thread(
            target=lambda: admitted.append(ps.wait_fresh(1 << 20)))
        t.start()
        time.sleep(0.3)
        assert t.is_alive(), "gate admitted an unbootstrapped replica"
        assert ps.refresh()
        t.join(timeout=10.0)
        assert not t.is_alive() and admitted == [0]
        server.stop()

    def test_delta_refresh_matches_full_pull_bitwise(self):
        """The resident buffer after N delta refreshes equals a full
        pull byte for byte: region patching reconstructs the exact
        store."""
        server = make_server(n_workers=1, n_shards=3)
        server.add_worker(0)
        ps, layout = make_subscriber(server)
        assert ps.refresh()
        rng = np.random.RandomState(0)
        for i in range(4):
            push_random(server, rng, layout)
            wait_version(server, (i + 1) * 3)
            assert ps.refresh()
            buf, ver = ps.snapshot()
            assert torch.equal(buf, full_wire(server))
            assert ver == server.version
        assert ps.full_refreshes == 0  # deltas all the way
        server.stop()

    def test_snapshot_is_a_clone(self):
        server = make_server(n_workers=1)
        server.add_worker(0)
        ps, layout = make_subscriber(server)
        ps.refresh()
        snap, _ = ps.snapshot()
        before = snap.clone()
        push_random(server, np.random.RandomState(5), layout)
        wait_version(server, 2)
        ps.refresh()
        assert torch.equal(snap, before)   # the refresh patched only _buf
        assert not torch.equal(ps.snapshot()[0], before)
        server.stop()

    def test_stopped_server_serves_final_weights(self):
        """A replica that trails at stop time catches up to the FINAL
        weights before freezing."""
        server = make_server(n_workers=1)
        server.add_worker(0)
        ps, layout = make_subscriber(server)
        push_random(server, np.random.RandomState(1), layout)
        wait_version(server, 2)
        server.stop()
        assert ps.refresh()         # the catch-up delta still lands
        assert not ps.refresh()     # now caught up: STOP freezes it
        assert ps.stopped
        buf, ver = ps.snapshot()
        assert torch.equal(buf, full_wire(server))
        assert ver == server.version
        assert ps.wait_fresh(0) == 0  # frozen weights are fresh forever

    def test_wait_fresh_blocks_until_refresh_lands(self):
        server = make_server(n_workers=1)
        server.add_worker(0)
        ps, layout = make_subscriber(server)
        ps.refresh()
        push_random(server, np.random.RandomState(2), layout)
        wait_version(server, 2)
        assert ps.staleness() == 2
        TRACE.enable(source="test")
        try:
            admitted = []
            t = threading.Thread(
                target=lambda: admitted.append(ps.wait_fresh(0)))
            t.start()
            time.sleep(0.3)
            assert t.is_alive(), "gate admitted a stale replica"
            assert ps.refresh_needed.is_set()
            ps.refresh()
            t.join(timeout=10.0)
            assert admitted == [0]
            assert ps.blocks == 1
            names = {e["name"] for e in TRACE.drain()}
            assert "staleness_block" in names
            assert "replica_refresh" in names
        finally:
            TRACE.disable()
        server.stop()

    @pytest.mark.parametrize("seed,bound", [(0, 0), (1, 1), (2, 3)])
    def test_admission_staleness_bounded_under_live_updates(self, seed,
                                                           bound):
        """Against a seeded schedule of live pushes, EVERY admission the
        gate grants is within the bound, measured against the server's
        version at admission time."""
        server = make_server(n_workers=1)
        server.add_worker(0)
        ps, layout = make_subscriber(server)
        refresher = Refresher(ps, refresh_every_s=0.002)
        refresher.start()
        rng = np.random.RandomState(seed)
        stop = threading.Event()

        def trainer():
            while not stop.is_set():
                push_random(server, rng, layout)
                time.sleep(rng.uniform(0.0, 0.004))

        t = threading.Thread(target=trainer, daemon=True)
        t.start()
        try:
            pace = np.random.RandomState(seed + 100)
            admitted = [ps.wait_fresh(bound) for _ in range(25)
                        if not time.sleep(pace.uniform(0.0, 0.003))]
            assert len(admitted) == 25
            assert all(a <= bound for a in admitted), admitted
        finally:
            stop.set()
            t.join(timeout=10.0)
            refresher.stop()
            server.stop()
        assert not t.is_alive() and not refresher.is_alive()

    def test_live_reshard_rebuilds_the_resident_buffer(self):
        """A reshard 2 -> 3 under a subscriber: its old-arity vector gets
        a full reply in the new layout, from which the resident buffer
        and its row starts are rebuilt; deltas resume after it."""
        server = make_server(n_workers=1, n_shards=2)
        server.add_worker(0)
        ps, _ = make_subscriber(server)
        assert ps.refresh()
        old_rows = ps.snapshot()[0].shape[0]
        assert server.reshard(3)
        assert ps.refresh()
        assert len(ps.versions) == 3 and ps.full_refreshes == 1
        buf, ver = ps.snapshot()
        assert torch.equal(buf, full_wire(server))
        assert ver == server.version
        assert buf.shape[0] == server.plan.wire_layout().total_rows
        assert buf.shape[0] != old_rows
        layout = server.plan.wire_layout()
        assert ps._row_start == layout.shard_row_start
        push_random(server, np.random.RandomState(3), layout)
        wait_version(server, 3)
        assert ps.refresh() and ps.full_refreshes == 1
        assert torch.equal(ps.snapshot()[0], full_wire(server))
        server.stop()


def test_replica_worker_rebuilds_its_decoder_after_a_live_reshard():
    """The serve loop over the dense smoke model: one batch, a live
    reshard of the server 2 -> 3, a second batch.  The decoder's plan is
    re-derived at the new arity and, the weights unchanged, decodes the
    same tokens."""
    from repro_torch.models import registry
    cfg = get_smoke_config("h2o-danube-1.8b")
    params = registry.init_params(cfg, seed=0, device="cpu")
    server = make_server(n_workers=1, n_shards=2, params=params)
    ps, _ = make_subscriber(server, replica_id=1)
    ps.refresh()
    decoder = Decoder(cfg, server.plan, prompt_len=6, max_new=3,
                      max_batch=2, device="cpu")
    queue = BatchQueue()
    worker = ReplicaWorker(1, ps, queue, decoder, staleness_bound=0,
                           batch_window_ms=0.0, max_batch=2)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 6))
    reqs = []
    for i in range(2):
        reqs.append(DecodeRequest(i, prompts[i].astype(np.int32)))
        queue.submit(reqs[-1])
    served = threading.Thread(target=worker.serve, daemon=True)
    served.start()
    for r in reqs:
        assert r.done.wait(60.0)
    assert server.reshard(3)
    ps.refresh()
    more = [DecodeRequest(2 + i, prompts[i].astype(np.int32))
            for i in range(2)]
    for r in more:
        queue.submit(r)
    queue.close()
    served.join(timeout=JOIN_S)
    assert not served.is_alive()
    assert worker.decoder is not decoder
    assert worker.decoder.plan.n_shards == 3
    for a, b in zip(reqs, more):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.staleness == b.staleness == 0
    server.stop()


# ============================================================ batching
class TestBatchQueue:
    def req(self, i):
        return DecodeRequest(request_id=i, prompt=np.zeros(4, np.int32),
                             enqueue_t=time.perf_counter())

    def test_fifo_batch_up_to_max(self):
        q = BatchQueue()
        for i in range(5):
            q.submit(self.req(i))
        batch = q.next_batch(max_batch=3, window_s=0.0)
        assert [r.request_id for r in batch] == [0, 1, 2]
        batch = q.next_batch(max_batch=3, window_s=0.0)
        assert [r.request_id for r in batch] == [3, 4]

    def test_linger_window_collects_late_arrivals(self):
        q = BatchQueue()
        q.submit(self.req(0))
        timer = threading.Timer(0.05, lambda: q.submit(self.req(1)))
        timer.start()
        batch = q.next_batch(max_batch=4, window_s=0.5)
        timer.join(timeout=10.0)
        assert len(batch) == 2

    def test_close_drains_then_returns_none(self):
        q = BatchQueue()
        q.submit(self.req(0))
        q.close()
        assert len(q.next_batch(2, 0.0)) == 1
        assert q.next_batch(2, 0.0) is None
        with pytest.raises(RuntimeError):
            q.submit(self.req(1))

    def test_next_batch_blocks_until_submit(self):
        q = BatchQueue()
        got = []
        t = threading.Thread(
            target=lambda: got.append(q.next_batch(2, 0.0)))
        t.start()
        time.sleep(0.1)
        assert t.is_alive()
        q.submit(self.req(7))
        t.join(timeout=10.0)
        assert [r.request_id for r in got[0]] == [7]

    def test_aggregate_handles_empty_and_none(self):
        agg = aggregate_serve([None])
        assert agg["requests"] == 0 and agg["violations"] == 0

    def test_aggregate_has_the_reference_keys(self):
        from repro.serve import ReplicaResult as JResult
        from repro.serve import aggregate_serve as jaggregate
        kw = dict(served=3, batches=2, violations=0, blocks=1, refreshes=4,
                  full_refreshes=1, latencies_s=[0.1, 0.2, 0.3],
                  staleness_values=[0, 2], served_versions=[3, 5],
                  legal_fraction=0.5, span_s=2.0)
        ours = aggregate_serve([ReplicaResult(4, **kw), None])
        theirs = jaggregate([JResult(4, **kw), None])
        assert ours == theirs


# ============================================================ spec/task
def _serve_spec(trace_path=""):
    return api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b", smoke=True),
        data=api.DataSpec(seq_len=32, global_batch=4),
        ps=api.ServerSpec(kind="sharded", shards=2, workers=2,
                          apply="fused"),
        sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=4),
        wire=api.WireSpec(format="packed", delta_pull=True),
        transport=api.TransportSpec(kind="tcp", endpoint=True),
        obs=api.ObsSpec(trace=bool(trace_path), trace_path=trace_path),
        serve=api.ServeSpec(replicas=2, requests=6, request_every_ms=100.0,
                            start_at_version=1, prompt_len=8, max_new=4,
                            max_batch=4, staleness_bound=4))


def test_subscriber_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the buffer would "
                    "live there")
    server = make_server()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParamSubscriber(DirectSubscription(server, 9),
                        server.plan.wire_layout())
    server.stop()


def test_serve_spec_is_the_reference_spec_and_builds_a_task():
    """The reference's ``_serve_spec`` is accepted as the reference
    accepts it, and its replica task carries the session's device."""
    import repro.api as japi
    spec = _serve_spec()
    assert japi.RunSpec.from_json(spec.to_json()).to_json() == \
        spec.to_json()
    task = ReplicaTask.from_spec(spec, device="cpu")
    assert (task.requests, task.prompt_len, task.max_new, task.max_batch,
            task.staleness_bound, task.start_at_version) == (6, 8, 4, 4,
                                                             4, 1)
    assert task.device == "cpu" and task.n_shards == 2
    assert task.to_dict()["model_config"] is None


def _check_serve(m, spec):
    assert m["final_loss"] is not None and math.isfinite(m["final_loss"])
    assert m["applied_updates"] > 0
    serve = m["serve"]
    assert serve["replicas"] == 2
    assert serve["requests"] == 2 * spec.serve.requests, serve
    assert serve["violations"] == 0, serve
    assert serve["staleness_max"] <= spec.serve.staleness_bound
    assert serve["version_max"] > 0, "no replica served an updated version"
    assert set(serve) == set(aggregate_serve([]))


def test_e2e_threaded_train_and_serve():
    """``ps-threads``: two replica threads against the in-heap server
    while two trainer threads push."""
    spec = dataclasses.replace(_serve_spec(),
                               transport=api.TransportSpec())
    assert spec.engine == "ps-threads"
    with api.build_session(spec, device="cpu", timeout=JOIN_S) as session:
        m = session.run(steps=24)
        results = session.serve_results
    _check_serve(m, spec)
    assert [r.replica_id for r in results] == [2, 3]
    for r in results:
        assert r.error is None and r.served == 6
        assert r.refreshes >= 1 and r.refresh_bytes > 0


def test_e2e_tcp_train_and_serve_traced(tmp_path):
    """The acceptance e2e: 2 tcp worker processes train while 2 replica
    processes serve via delta pulls; the serve spans land in the merged
    trace beside the trainers'."""
    trace = str(tmp_path / "serve_trace.jsonl")
    spec = _serve_spec(trace)
    assert spec.engine == "ps-transport"
    with api.build_session(spec, device="cpu", timeout=JOIN_S) as session:
        m = session.run(steps=24)
        results = session.serve_results
    _check_serve(m, spec)
    for r in results:
        assert r.error is None and r.exitcode == 0 and r.served == 6
        assert r.launches and not any(r.launches.values())  # CPU
        assert r.peak_memory_bytes == 0
    names = set()
    with open(trace) as fh:
        for line in fh:
            names.add(json.loads(line)["name"])
    for want in ("replica_refresh", "decode_batch", "push", "compute_step"):
        assert want in names, f"{want} missing from {sorted(names)}"
