"""Restartable out-of-process parameter server.

Counterpart of ``repro/ft/server_proc.py``.  ``ServerProcess`` hosts a
``build_server(spec)`` + ``PSServerEndpoint`` + ``TcpTransport`` stack
in its *own* spawned process, which is what makes killing it
meaningful: SIGKILL takes out the packed store (and the process's CUDA
context), every live socket and every in-flight push.

    sp = ServerProcess(spec)         # spec.ft.dir names the ckpt dir
    addr = sp.start()                # fresh run: no snapshot to load
    ... workers train, the snapshotter checkpoints every snapshot_every_s
    sp.kill()                        # SIGKILL — or the machine dies
    addr2 = sp.restart()             # same port, resumes from the latest
                                     # snapshot; workers' reconnect loops
                                     # re-HELLO and full-resync

``restart`` rebinds the SAME host:port, so the address workers hold
stays valid across the failover — their backoff loop only has to
outlast the restart (for a CUDA server: a new context, the model's
weights built on the device, then the snapshot read back and copied in,
before the first request is served).

The child runs on ``device`` (``cuda:0`` unless the caller names
another, as the tests name the CPU) and builds the spec's model, or
``model_config`` when given (the session's override).  It restores the
latest snapshot BEFORE it serves, so its first pull answers from the
restored store, never from fresh weights.

tcp only: shmem segments die with the process that owns them.

In-process faults: ``spec.ft.fault_kill_server_round >= 0`` arms a
watchdog thread that SIGKILLs the server the moment its aggregate push
count reaches the round; a restarted incarnation never re-arms it.  The
live-reshard trigger (``spec.ft.reshard_*``) is re-armed in every
incarnation; ``fault_kill_mid_reshard`` SIGKILLs the first incarnation
inside its migration.  After a migration completes the child takes one
snapshot at once (when snapshots are on), so a failover after it
resumes in the new layout instead of migrating again — the reference
waits for the next periodic snapshot.

The server-side trace ring spills to ``<trace_spill>/server<i>.jsonl``
on a short cadence, so its spans survive the SIGKILL; with
``spec.obs.trace`` the workers' ``MSG_TRACE`` batches go to
``<trace_spill>/frames-server<i>.jsonl`` as they arrive.  With
``spec.obs.sample_every > 0`` a ``MetricsSampler`` adds the server's
counters (and, on CUDA, its peak device memory) to that trace.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

_SPILL_PERIOD_S = 0.2


def _spill_loop(trace, path: str, stop: threading.Event) -> None:
    with open(path, "a", encoding="utf-8") as fh:
        while True:
            stopped = stop.wait(_SPILL_PERIOD_S)
            for e in trace.drain():
                fh.write(json.dumps(e, separators=(",", ":")))
                fh.write("\n")
            fh.flush()
            if stopped:
                return


class _FrameSpill:
    """The server process's collector: every ``MSG_TRACE`` batch a worker
    sends is appended to ``path`` as JSONL at once, so the batches
    survive a SIGKILL of the server and the parent merges them with the
    spill files (a ``TraceCollector`` dedups the events that arrived
    both ways)."""

    def __init__(self, path: str):
        self._fh = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def ingest(self, source: str, events) -> int:
        n = 0
        with self._lock:
            for e in events:
                if not isinstance(e, dict) or "name" not in e:
                    continue
                if not e.get("src"):
                    e = dict(e, src=source)
                self._fh.write(json.dumps(e, separators=(",", ":")))
                self._fh.write("\n")
                n += 1
            self._fh.flush()
        return n


def _server_main(spec_dict: Dict[str, Any], port: int, queue,
                 trace_spill: str, kill_server_round: int,
                 incarnation: int, device: str, model_config) -> None:
    """Entry point of the spawned server process."""
    import torch

    from repro_torch.api.session import (_obs_snapshot_fn, _registry_params,
                                         build_server)
    from repro_torch.api.spec import RunSpec
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.ft.snapshot import ServerSnapshotter, restore_latest
    from repro_torch.obs.trace import TRACE
    from repro_torch.transport import PSServerEndpoint
    from repro_torch.transport.tcp import TcpTransport

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    spec = RunSpec.from_dict(spec_dict)
    spill_stop = threading.Event()
    if spec.obs.trace or trace_spill:
        TRACE.enable(source=f"server{incarnation}")
    if trace_spill:
        os.makedirs(trace_spill, exist_ok=True)
        threading.Thread(
            target=_spill_loop,
            args=(TRACE, os.path.join(trace_spill,
                                      f"server{incarnation}.jsonl"),
                  spill_stop),
            name="ft-trace-spill", daemon=True).start()

    server = build_server(spec, _registry_params(spec, dev, model_config),
                          dev)
    manager = CheckpointManager(spec.ft.dir, keep=spec.ft.keep)
    # Resume BEFORE serving: the endpoint's pull cache is keyed by
    # version, and a restore lowers versions — nothing may be served
    # from the pre-restore state.
    resumed_step = restore_latest(server, manager)
    endpoint = PSServerEndpoint(server, collector=_FrameSpill(
        os.path.join(trace_spill, f"frames-server{incarnation}.jsonl"))
        if trace_spill and spec.obs.trace else None)
    transport = TcpTransport(spec.transport.host, port)
    transport.serve(endpoint)

    sampler = None
    if TRACE.enabled and spec.obs.sample_every > 0:
        from repro_torch.obs.collect import MetricsSampler
        counters = _obs_snapshot_fn(server)

        def sample() -> Dict[str, Any]:
            out = counters()
            if dev.type == "cuda":
                out["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(dev)
            return out

        sampler = MetricsSampler(TRACE, sample, spec.obs.sample_every)
        sampler.start()

    snapshotter = None
    if spec.ft.snapshot_every_s > 0:
        snapshotter = ServerSnapshotter(
            server, manager, spec.ft.snapshot_every_s).start()

    if kill_server_round >= 0:
        def watchdog() -> None:  # pragma: no cover - dies via SIGKILL
            while server.metrics.total_pushes < kill_server_round:
                time.sleep(0.005)
            os.kill(os.getpid(), signal.SIGKILL)
        threading.Thread(target=watchdog, name="ft-kill-watchdog",
                         daemon=True).start()

    stop = threading.Event()
    if spec.ft.reshards:
        armed_kill = spec.ft.fault_kill_mid_reshard and incarnation == 0

        def _mid_hook(shard_index: int) -> None:
            # Fires after each old shard's state is copied out; dying
            # at index >= 1 leaves the migration genuinely mid-flight.
            if shard_index >= 1:  # pragma: no cover - dies via SIGKILL
                os.kill(os.getpid(), signal.SIGKILL)

        def reshard_trigger() -> None:
            from repro_torch.api.session import reshard_due
            last = server.shard_versions()
            while not stop.is_set() and not server.stopped:
                time.sleep(0.02)
                due, last = reshard_due(server, spec.ft, last)
                if due:
                    moved = server.reshard(
                        spec.ft.reshard_shards,
                        _mid_hook=_mid_hook if armed_kill else None)
                    if moved and snapshotter is not None:
                        snapshotter.save_now()
                    return

        threading.Thread(target=reshard_trigger,
                         name="ft-reshard-trigger", daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    queue.put(("up", transport.address(), resumed_step))
    stop.wait()

    # Graceful shutdown: final snapshot, release gated pushes with a
    # STOP, tear the wire down, flush the trace spill.
    if snapshotter is not None:
        try:
            snapshotter.stop(final_save=True)
        except Exception:
            pass  # a torn final save must not block the shutdown
    if sampler is not None:
        sampler.stop()
    server.stop()
    transport.shutdown()
    server.shutdown()
    spill_stop.set()
    time.sleep(2 * _SPILL_PERIOD_S)  # let the spill thread drain
    queue.put(("down", server.metrics.total_pushes, None))


class ServerProcess:
    """Parent-side handle on one spawned, restartable server."""

    def __init__(self, spec, *, port: int = 0, trace_spill: str = "",
                 start_timeout: float = 300.0, device: str = "cuda:0",
                 model_config=None):
        self.spec = spec
        self.port = port            # 0 = ephemeral on first start
        self.trace_spill = trace_spill
        self.start_timeout = start_timeout
        self.device = str(device)
        self.model_config = model_config
        self.incarnation = 0
        self.resumed_step: Optional[int] = None
        self.address: Optional[Tuple] = None
        #: seconds from spawn to serving, per incarnation
        self.start_s: list = []
        self._ctx = multiprocessing.get_context("spawn")
        self._queue = self._ctx.Queue()
        self._proc: Optional[multiprocessing.Process] = None

    def start(self) -> Tuple:
        """Spawn (or respawn) the server; blocks until it serves.
        Returns its transport address — stable across restarts."""
        if self._proc is not None and self._proc.is_alive():
            raise RuntimeError("server process already running")
        # The FaultPlan's server-kill only fires in the FIRST
        # incarnation: a restarted server must get to finish the run.
        kill_round = (self.spec.ft.fault_kill_server_round
                      if self.incarnation == 0 else -1)
        t0 = time.monotonic()
        self._proc = self._ctx.Process(
            target=_server_main,
            args=(self.spec.to_dict(), self.port, self._queue,
                  self.trace_spill, kill_round, self.incarnation,
                  self.device, self.model_config),
            name=f"ft-ps-server-{self.incarnation}", daemon=True)
        self._proc.start()
        deadline = t0 + self.start_timeout
        while True:
            try:
                tag, addr, resumed = self._queue.get(timeout=1.0)
            except Exception:
                if not self._proc.is_alive():
                    raise RuntimeError(
                        f"server process died during startup (exit "
                        f"{self._proc.exitcode})") from None
                if time.monotonic() > deadline:
                    raise RuntimeError("server startup timed out")
                continue
            if tag == "up":
                break
        self.start_s.append(time.monotonic() - t0)
        self.address = addr
        self.resumed_step = resumed
        # Pin the ephemeral port the first bind chose so every restart
        # lands on the address the workers are retrying against.
        self.port = addr[2]
        self.incarnation += 1
        return addr

    def restart(self) -> Tuple:
        """Failover: reap the corpse, respawn on the same port (the new
        incarnation resumes from the latest snapshot in spec.ft.dir)."""
        if self._proc is not None:
            self._proc.join(timeout=10.0)
        return self.start()

    def is_alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def wait_dead(self, timeout: float = 60.0) -> bool:
        """Block until the server process exits (a FaultPlan kill is
        asynchronous); False on timeout."""
        deadline = time.monotonic() + timeout
        while self.is_alive():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def kill(self) -> None:
        """SIGKILL — the crash case.  No flush, no final snapshot."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=10.0)

    def stop(self, timeout: float = 120.0) -> None:
        """SIGTERM — the graceful case: final snapshot, STOP replies to
        gated workers, clean socket teardown."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=timeout)

    def __enter__(self) -> "ServerProcess":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        self.kill()


__all__ = ["ServerProcess"]
