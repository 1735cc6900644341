"""The port's trace collection, export and analysis against the reference.

Counterparts of ``tests/test_obs.py`` for ``repro_torch.obs``: the
collector's ingest and dedup, spill recovery with a torn final line,
the Chrome export byte for byte the reference's for the same events,
``summarize`` equal to the reference's (on synthetic events and on a
traced DSSP run of the port's server), the CLI, and ``MSG_TRACE``
batches of spawned worker processes reaching the endpoint's collector.
Spawned children run under a deadline (the pool's ``join`` timeout).
"""

from __future__ import annotations

import json
import random

import pytest
import torch

from repro.obs import export as jexport
from repro.obs import format_summary as jformat_summary
from repro.obs import summarize as jsummarize
from repro_torch.obs import (TRACE, MetricsSampler, TraceCollector,
                             TraceRecorder, format_summary, read_jsonl,
                             read_trace, summarize, write_chrome_trace,
                             write_jsonl)

torch.set_num_threads(2)

#: every spawned child's deadline, seconds
CHILD_S = 180.0


@pytest.fixture(autouse=True)
def _few_threads_and_clean_trace(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    TRACE.disable()


def _evt(seq, name="push", *, src=None, worker=-1, clock=-1, ts=0.0,
         dur=0.0, shard=-1, **args):
    e = {"seq": seq, "ts": ts, "dur": dur, "name": name,
         "worker": worker, "shard": shard, "clock": clock}
    if src is not None:
        e["src"] = src
    if args:
        e["args"] = args
    return e


def _mixed_events(n=60, seed=0):
    """A seeded mix of every event kind the DSSP path records."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = rng.randrange(3)
        kind = rng.choice(["compute_step", "gate_wait", "push",
                           "dssp_decision", "apply", "snapshot_shard",
                           "reshard_shard", "failover", "reconnect"])
        args = {}
        if kind == "push":
            args = {"staleness": rng.randrange(5), "applied": True,
                    "credit": rng.random() < 0.3}
        elif kind == "dssp_decision":
            args = {"reason": rng.choice(["grant", "credit_spend",
                                          "within", "block"]),
                    "threshold": rng.randrange(1, 5)}
        out.append(_evt(i, kind, src=rng.choice(["server", f"w{w}"]),
                        worker=w, clock=rng.randrange(10),
                        ts=1000.0 + i * 0.013 + rng.random() * 1e-3,
                        dur=rng.random() * 0.05 if rng.random() < 0.7
                        else 0.0, shard=rng.randrange(-1, 4), **args))
    return out


# ============================================================ collector
def test_collector_ingest_dedups_by_src_seq_and_drops_malformed():
    c = TraceCollector()
    batch = [_evt(0, src="w0"), _evt(1, src="w0")]
    assert c.ingest("w0", batch) == 2
    assert c.ingest("w0", [dict(e) for e in batch]) == 0   # frame + spill
    assert c.ingest("w1", [_evt(0, src="w1")]) == 1        # other source
    assert c.ingest("w2", [{"seq": 0, "ts": 1.0, "name": "push"},
                           "not-a-dict", {"seq": 1, "ts": 2.0}, None]) == 1
    assert len(c) == 4
    assert [e for e in c.events() if e.get("src") == "w2"][0]["seq"] == 0
    # the merge order does not depend on arrival order
    c2 = TraceCollector()
    for e in reversed(c.events()):
        c2.ingest("x", [e])
    assert c.by_worker_clock() == c2.by_worker_clock()


def test_spill_recovery_tolerates_a_torn_final_line(tmp_path):
    spill = tmp_path / "spill"
    spill.mkdir()
    lines = [json.dumps(_evt(i, src="w0", worker=0, clock=i))
             for i in range(3)]
    (spill / "w0.jsonl").write_text(
        "\n".join(lines) + "\n" + lines[0][: len(lines[0]) // 2])
    c = TraceCollector()
    c.ingest("w0", [_evt(0, src="w0", worker=0, clock=0),
                    _evt(1, src="w0", worker=0, clock=1)])
    assert c.ingest_spill_dir(spill) == 1   # only clock 2 is new
    assert sorted(e["clock"] for e in c.events()) == [0, 1, 2]
    assert read_jsonl(spill / "w0.jsonl") == \
        jexport.read_jsonl(spill / "w0.jsonl")


def test_metrics_sampler_samples_and_stops():
    r = TraceRecorder()
    r.enable(source="srv")
    calls = []
    s = MetricsSampler(r, lambda: calls.append(1) or {"n": len(calls)},
                       every=0.01)
    s.start()
    s._halt.wait(0.08)
    s.stop()
    snaps = [e for e in r.drain() if e["name"] == "metrics_snapshot"]
    assert len(snaps) >= 2 and snaps[-1]["args"]["n"] == len(calls)


def test_event_names_hold_every_name_the_ft_code_emits():
    from repro_torch.obs.trace import EVENT_NAMES
    assert {"snapshot", "snapshot_shard", "snapshot_write", "failover",
            "reconnect", "fault", "reshard",
            "reshard_shard"} <= set(EVENT_NAMES)


# ============================================================== export
def test_chrome_export_is_byte_identical_to_the_reference(tmp_path):
    events = _mixed_events()
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    assert write_chrome_trace(events, ours) == len(events)
    jexport.write_chrome_trace(events, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_trace(ours) == jexport.read_trace(theirs)
    jl, jl_ref = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    write_jsonl(events, jl)
    jexport.write_jsonl(events, jl_ref)
    assert jl.read_bytes() == jl_ref.read_bytes()
    assert read_trace(jl) == events


# =========================================================== summarize
def test_summarize_equals_the_reference_on_synthetic_events():
    for seed in range(3):
        events = _mixed_events(seed=seed)
        assert summarize(events) == jsummarize(events)
        assert format_summary(summarize(events)) == \
            jformat_summary(jsummarize(events))
    assert summarize([]) == jsummarize([])


def test_summarize_equals_the_reference_on_a_traced_dssp_run():
    """Two threads push into the port's DSSP server with tracing on; the
    recorded trace reduces to the same summary in both packages."""
    import threading

    from repro_torch.core.policies import make_policy_factory
    from repro_torch.ps.server import ServerOptimizer
    from repro_torch.ps.sharded.server import ShardedParameterServer
    srv = ShardedParameterServer(
        {"w": torch.ones(48, 32), "b": torch.zeros(17)},
        make_policy_factory("dssp", n_workers=2, s_lower=0, s_upper=2),
        lambda: ServerOptimizer(lr=0.05), 2, 2, apply_mode="fused")
    rows = srv.plan.wire_layout().total_rows
    TRACE.enable(source="server")

    def worker(w):
        g = torch.full((rows, 512), 1e-3)
        for it in range(6):
            t0 = TRACE.now()
            TRACE.span("compute_step", t0, worker=w, clock=it)
            srv.push_packed(w, g)
        srv.remove_worker(w)

    threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    events = TRACE.drain()
    TRACE.disable()
    srv.stop()
    assert {"push", "compute_step"} <= {e["name"] for e in events}
    assert summarize(events) == jsummarize(events)


# ================================================================= CLI
def test_obs_cli_summarize(tmp_path, capsys):
    from repro_torch.obs.__main__ import main as obs_main
    ev = [_evt(0, "compute_step", src="w0", worker=0, clock=0, ts=1.0,
               dur=0.5)]
    path = str(tmp_path / "t.jsonl")
    write_jsonl(ev, path)
    assert obs_main(["summarize", path]) == 0
    out = capsys.readouterr().out
    assert "events" in out and "wall time" in out
    assert obs_main(["summarize", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == 1
    assert obs_main(["summarize", str(tmp_path / "missing.json")]) != 0


# ======================================================= worker frames
def test_spawned_workers_trace_batches_reach_the_collector():
    """Two spawned worker processes with tracing on and no spill file:
    every one of their ``compute_step`` spans arrives over ``MSG_TRACE``
    frames at the endpoint's collector."""
    from repro_torch.core.policies import make_policy_factory
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    from repro_torch.models import registry
    from repro_torch.configs import get_smoke_config
    from repro_torch.ps.server import ServerOptimizer
    from repro_torch.ps.sharded.server import ShardedParameterServer
    from repro_torch.transport import PSServerEndpoint, make_transport

    cfg = get_smoke_config("h2o-danube-1.8b")
    server = ShardedParameterServer(
        registry.init_params(cfg, seed=0, device="cpu"),
        make_policy_factory("asp", n_workers=2), lambda:
        ServerOptimizer(lr=0.01), 2, 2, apply_mode="fused")
    collector = TraceCollector()
    endpoint = PSServerEndpoint(server, collector=collector)
    transport = make_transport("tcp", n_workers=2)
    transport.serve(endpoint)
    task = WorkerTask(arch="h2o-danube-1.8b", n_shards=2, n_iterations=3,
                      seq_len=16, global_batch=2, device="cpu",
                      trace=True, trace_flush_every=2)
    pool = ProcessWorkerPool(transport.address(), task, 2)
    pool.start()
    try:
        raise_on_failure(pool.join(timeout=CHILD_S, endpoint=endpoint))
    finally:
        pool.terminate()
        server.stop()
        transport.shutdown()
    steps = sorted((e["src"], e["clock"]) for e in collector.events()
                   if e["name"] == "compute_step")
    assert steps == [(f"w{w}", it) for w in (0, 1) for it in range(3)]
