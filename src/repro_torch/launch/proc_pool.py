"""Process worker pool: real OS processes driving the PS over a transport.

Counterpart of ``repro/launch/proc_pool.py``.  ``ProcessWorkerPool``
spawns N worker *processes*; each one rebuilds the model config and the
``ShardPlan`` from its ``WorkerTask`` (the plan needs only the
parameters' shapes, so the worker plans over ``meta`` tensors and never
allocates weights it would throw away), connects to the server's
transport address, and runs the paper's worker loop

    pull packed params -> step (unpack, grad, re-pack) ->
    push packed grads -> blocked until the sync policy releases it

entirely in frame bytes.  A per-worker ``slowdown`` factor sleeps
``(slowdown - 1) x measured_compute`` per iteration: genuine
heterogeneous stragglers, with separate interpreters and a real wire in
between.

Each worker runs on the session's device (``WorkerTask.device``,
``cuda:0`` by default: one CUDA context per process on one card) and
raises where that device is missing; it never carries on on the CPU.
Workers are spawned, never forked: the parent holds a CUDA context.
The kernel library is built by the parent before it spawns, so the
workers load it (``kernels/cuda.py``).

Fault tolerance and tracing, as in the reference worker:

  * the task's ``FaultPlan``: the worker SIGKILLs itself at its planned
    iteration, and its channel (and every reconnected one) drops or
    delays frames as planned;
  * a reconnect budget: when the server dies under it, the worker backs
    off, reconnects, re-HELLOs and retries the same iteration (its
    version vector is then ahead of the restored server's, so the next
    delta pull is a full resync);
  * a live reshard: a delta reply at another epoch or shard arity makes
    the worker re-plan at the new arity (``ShardPlan.rebuild``, shapes
    only) and rebuild its step and its resident buffer; a push the
    server cannot place under any layout it knows bounces with a
    "resync" error, and the worker retries the iteration;
  * tracing: the worker's ``TRACE`` ring drains every
    ``trace_flush_every`` iterations into ``MSG_TRACE`` frames, after
    appending the batch to ``<trace_spill>/w<N>.jsonl`` — a worker killed
    mid-run leaves its events on disk (the collector dedups the ones
    that also came over the wire).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class WorkerTask:
    """Everything a spawned worker needs to rebuild its half of the run.

    Must stay picklable and small — it crosses the spawn boundary, the
    weights do not (the worker pulls them over the transport).
    """

    arch: str                 # repro_torch.configs key
    n_shards: int             # parent's ShardPlan arity (layout must match)
    n_iterations: int
    smoke: bool = True
    kernels: str = "auto"     # model.kernels dispatch string (registry)
    seq_len: int = 64
    global_batch: int = 8
    data_seed: int = 0        # worker w streams shard seed data_seed+1+w
    compress: str = "none"    # frame-level wire compression (int8)
    delta_pull: bool = False  # version-delta pulls over PULL_DELTA frames
    device: str = "cuda:0"    # the session's device
    #: a ``ModelConfig`` in place of ``arch``/``smoke`` (the session's
    #: ``model_config=`` override)
    model_config: Any = None
    trace: bool = False       # arm the worker's repro_torch.obs ring
    trace_spill: str = ""     # dir for the per-worker JSONL spill file
    trace_flush_every: int = 32  # iterations between TRACE-frame flushes
    # -- fault tolerance (repro_torch.ft) -------------------------------
    reconnect_tries: int = 0  # per-outage reconnect budget (0 = die)
    reconnect_base_s: float = 0.1
    reconnect_max_s: float = 2.0
    fault_plan: Optional[Dict[str, Any]] = None  # FaultPlan.to_dict()

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_spec(cls, spec, n_iterations: int, *, device: str = "cuda:0",
                  model_config=None, trace_spill: str = "",
                  trace_flush_every: int = 32) -> "WorkerTask":
        """Derive the spawn payload from a ``RunSpec``.

        Only the int8 compression rides the frames (bytes shrink on the
        OS wire; the codec dequantizes on receipt) — topk has no
        frame-level encoding and stays a server-side pass.
        ``n_shards`` is clamped to >= 1: a monolithic spec may carry
        ``ps.shards=0``, but its packed plan is single-shard.
        """
        return cls(arch=spec.model.arch,
                   n_shards=max(1, spec.ps.shards),
                   n_iterations=n_iterations,
                   smoke=spec.model.smoke,
                   kernels=spec.model.kernels,
                   seq_len=spec.data.seq_len,
                   global_batch=spec.data.global_batch,
                   data_seed=spec.data.seed,
                   compress=("int8" if spec.wire.compression == "int8"
                             else "none"),
                   delta_pull=spec.wire.delta_pull,
                   device=device,
                   model_config=model_config,
                   trace=spec.obs.trace,
                   trace_spill=trace_spill,
                   trace_flush_every=trace_flush_every,
                   reconnect_tries=spec.ft.reconnect_tries,
                   reconnect_base_s=spec.ft.reconnect_base_s,
                   reconnect_max_s=spec.ft.reconnect_max_s,
                   fault_plan=(spec.ft.fault_plan().to_dict()
                               if spec.ft.faults else None))


@dataclasses.dataclass
class WorkerResult:
    worker_id: int
    iterations_done: int
    error: Optional[str] = None      # traceback text for failed workers
    exitcode: Optional[int] = None
    # -- diagnostics of the worker process (they change no behaviour) --
    #: the process's kernel launch counts (``perfcount.LAUNCHES``)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: seconds of each step, from before the step to after the loss
    #: reached the host (without the straggler sleep)
    compute_s: List[float] = dataclasses.field(default_factory=list)
    #: ``torch.cuda.max_memory_allocated`` of the process (0 on the CPU)
    peak_memory_bytes: int = 0
    #: reconnects after the server died, and layout rebuilds after a
    #: live reshard
    reconnects: int = 0
    rebuilds: int = 0
    #: per iteration: seconds of the pull (request to params in place),
    #: of the push (request to release, the gate wait included), of the
    #: whole iteration, and frame bytes received by the pull and sent
    #: by the push
    pull_s: List[float] = dataclasses.field(default_factory=list)
    push_s: List[float] = dataclasses.field(default_factory=list)
    iteration_s: List[float] = dataclasses.field(default_factory=list)
    pull_bytes: List[int] = dataclasses.field(default_factory=list)
    push_bytes: List[int] = dataclasses.field(default_factory=list)


def _task_config(task: Dict[str, Any]):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = task.get("model_config")
    if cfg is None:
        cfg = (get_smoke_config(task["arch"]) if task["smoke"]
               else get_config(task["arch"]))
        if task.get("kernels", "auto") != cfg.kernels:
            cfg = dataclasses.replace(cfg, kernels=task["kernels"])
    return cfg


def _worker_main(task: Dict[str, Any], address, worker_id: int,
                 slowdown: float, queue) -> None:
    """Entry point of one spawned worker process."""
    result = WorkerResult(worker_id, 0)
    try:
        import torch

        from repro_torch.api.session import packed_step, worker_batches
        from repro_torch.data.synthetic import DataConfig
        from repro_torch.ft.backoff import BackoffPolicy
        from repro_torch.ft.faults import FaultPlan, kill_self, wrap_channel
        from repro_torch.models import registry
        from repro_torch.obs.trace import TRACE
        from repro_torch.perfcount import LAUNCHES, TRANSPORT
        from repro_torch.ps.sharded.plan import build_shard_plan
        from repro_torch.transport import connect
        from repro_torch.transport.base import TransportClosed
        from repro_torch.wireformat import WIRE_LANES, FrameError

        device = torch.device(task["device"])
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"worker {worker_id} was given {device} and finds no "
                    "CUDA device")
            torch.cuda.set_device(device)
        cfg = _task_config(task)
        data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=task["seq_len"],
                              global_batch=task["global_batch"],
                              seed=task["data_seed"])
        plan = build_shard_plan(registry.abstract_params(cfg),
                                task["n_shards"])
        stream = worker_batches(cfg, data_cfg, worker_id, device)

        fault_plan = FaultPlan.from_dict(task["fault_plan"])
        reconnect_policy = (BackoffPolicy(
            base_s=task["reconnect_base_s"], factor=2.0,
            max_s=task["reconnect_max_s"],
            max_tries=task["reconnect_tries"])
            if task["reconnect_tries"] > 0 else None)
        spill_fh = None
        if task["trace"]:
            TRACE.enable(source=f"w{worker_id}")
            if task["trace_spill"]:
                os.makedirs(task["trace_spill"], exist_ok=True)
                spill_fh = open(os.path.join(task["trace_spill"],
                                             f"w{worker_id}.jsonl"),
                                "a", encoding="utf-8")

        client = connect(address, worker_id, compress=task["compress"])
        if fault_plan.wants_channel:
            # Drop/delay faults wrap the live channel AND the factory, so
            # a reconnected channel stays faulty too.
            client.channel = wrap_channel(client.channel, fault_plan,
                                          worker_id)
            inner_factory = client.channel_factory
            if inner_factory is not None:
                client.channel_factory = lambda: wrap_channel(
                    inner_factory(), fault_plan, worker_id)

        def flush_trace() -> None:
            """Drain the ring: spill file first, then a TRACE frame."""
            if not TRACE.enabled:
                return
            events = TRACE.drain()
            if not events:
                return
            if spill_fh is not None:
                for e in events:
                    spill_fh.write(json.dumps(e, separators=(",", ":")))
                    spill_fh.write("\n")
                spill_fh.flush()
            try:
                client.send_trace(events)
            except Exception:
                pass  # server gone: the spill file still has them

        rows = client.hello()
        if rows != plan.wire_layout().total_rows:
            raise ValueError(
                f"server wire layout has {rows} rows, local plan derives "
                f"{plan.wire_layout().total_rows} — task spec out of "
                "sync with server")
        delta_pull = bool(task["delta_pull"])
        # The layout-shaped state, rebuilt by a live reshard: the plan,
        # the step (its gradient wire), and for delta pulls a RESIDENT
        # buffer on the device into which only the shard regions whose
        # version advanced are copied, straight from the receive buffer.
        state: Dict[str, Any] = {"epoch": client.reshard_epoch}

        def rebuild_layout(n_shards: int, epoch: int) -> None:
            """Re-plan at the server's arity (shapes only, never weights)
            and re-size every layout-shaped buffer.  The reply that
            triggered this is a full snapshot in the NEW layout, so
            copying it into the fresh buffer is complete."""
            p = plan if n_shards == plan.n_shards else \
                plan.rebuild(n_shards)
            layout = p.wire_layout()
            state.update(plan=p, layout=layout,
                         step=packed_step(cfg, p, device),
                         versions=(-1,) * n_shards, epoch=epoch)
            state["resident"] = (
                torch.zeros((layout.total_rows, WIRE_LANES),
                            dtype=layout.dtype, device=device)
                if delta_pull else None)
            # pushes are now packed against the new layout
            client.reshard_epoch = epoch

        rebuild_layout(plan.n_shards, client.reshard_epoch)

        def pull():
            """The latest params on the device, or None once the server
            has stopped.  The reply's tensors view the transport's
            receive buffer; they are copied and dropped here, before the
            next request (a view left alive would pin a shmem slot)."""
            if not delta_pull:
                host = client.pull_packed(copy=False)
                if (host is not None and host.shape[0]
                        != state["layout"].total_rows):
                    # A live reshard changed the layout.  A plain pull
                    # carries no arity: probe with a mismatched delta
                    # pull, whose full reply has the new arity and epoch.
                    del host
                    probe = client.pull_delta((-1,), copy=False)
                    if probe is None:
                        return None
                    rebuild_layout(len(probe.versions), probe.epoch)
                    result.rebuilds += 1
                    del probe
                    host = client.pull_packed(copy=False)
                return None if host is None else host.to(device, copy=True)
            d = client.pull_delta(state["versions"], copy=False)
            if d is None:
                return None
            if (d.epoch != state["epoch"]
                    or len(d.versions) != len(state["versions"])):
                rebuild_layout(len(d.versions), d.epoch)
                result.rebuilds += 1
                if not d.full:
                    # an epoch change arrives as a full snapshot; if not,
                    # re-pull from scratch
                    d = client.pull_delta(state["versions"], copy=False)
                    if d is None:
                        return None
            row_start = state["layout"].shard_row_start
            resident = state["resident"]
            for j, region in zip(d.shards, d.regions):
                resident[row_start[j]:row_start[j]
                         + region.shape[0]].copy_(region)
            state["versions"] = d.versions
            return resident

        LAUNCHES.reset()
        try:
            it = 0
            while it < task["n_iterations"]:
                if fault_plan.worker_kill_due(worker_id, it):
                    flush_trace()
                    kill_self()  # the process dies here
                try:
                    t_it = time.monotonic()
                    rx0 = TRANSPORT.bytes_rx
                    wire_p = pull()
                    if wire_p is None:
                        break  # server stopped
                    result.pull_s.append(time.monotonic() - t_it)
                    result.pull_bytes.append(TRANSPORT.bytes_rx - rx0)
                    batch = next(stream)
                    t_tr = TRACE.now() if TRACE.enabled else 0.0
                    t0 = time.monotonic()
                    wire_g, aux = state["step"](wire_p, batch)
                    loss = float(aux["loss"])   # waits for the step
                    compute = time.monotonic() - t0
                    result.compute_s.append(compute)
                    if slowdown > 1.0:
                        # The sleep IS the emulated slower device, so the
                        # compute_step span includes it.
                        time.sleep(compute * (slowdown - 1.0))
                    if TRACE.enabled:
                        TRACE.span("compute_step", t_tr, worker=worker_id,
                                   clock=it, args={"loss": loss})
                    client.record_loss(it, loss)
                    t_push, tx0 = time.monotonic(), TRANSPORT.bytes_tx
                    alive = client.push_packed(wire_g, clock=it)
                    result.push_s.append(time.monotonic() - t_push)
                    result.push_bytes.append(TRANSPORT.bytes_tx - tx0)
                    result.iteration_s.append(time.monotonic() - t_it)
                except FrameError as e:
                    if "resync" not in str(e):
                        raise
                    # Retryable bounce: the server could not place this
                    # push under any layout it knows (a failed-over
                    # server restored to a plan before our epoch).  The
                    # pull at the top resyncs and rebuilds first.
                    continue
                except (TransportClosed, OSError):
                    # The server died under us.  With a reconnect budget:
                    # back off, rebuild the channel, re-HELLO (idempotent:
                    # the seat is re-acquired, never duplicated) and
                    # retry this iteration.  A push that died mid-gate is
                    # sent again (ordinary async-SGD noise).
                    if reconnect_policy is None:
                        raise
                    client.reconnect(reconnect_policy, seed=worker_id)
                    result.reconnects += 1
                    continue
                result.iterations_done += 1
                it += 1
                if it % max(1, task["trace_flush_every"]) == 0:
                    flush_trace()
                if not alive:
                    break  # released with a STOP: training is over
        finally:
            flush_trace()
            client.bye()
            client.close()
            if spill_fh is not None:
                spill_fh.close()
            result.launches = LAUNCHES.snapshot()
            if device.type == "cuda":
                result.peak_memory_bytes = torch.cuda.max_memory_allocated(
                    device)
        queue.put(result)
    except BaseException:
        result.error = traceback.format_exc()
        queue.put(result)
        raise


class ProcessWorkerPool:
    """Spawn/join N transport workers with per-worker slowdown factors."""

    def __init__(self, address, task: WorkerTask, n_workers: int, *,
                 slowdowns: Optional[Sequence[float]] = None):
        if slowdowns is not None and len(slowdowns) != n_workers:
            raise ValueError(f"{len(slowdowns)} slowdown factors for "
                             f"{n_workers} workers")
        self.address = address
        self.task = task
        self.n_workers = n_workers
        self.slowdowns = list(slowdowns or [1.0] * n_workers)
        self._ctx = multiprocessing.get_context("spawn")
        self._queue = self._ctx.Queue()
        self.procs: List[multiprocessing.Process] = []
        #: worker ids replaced by ``join(respawn=...)``
        self.respawned: List[int] = []

    def start(self) -> None:
        task = self.task.to_dict()
        for w in range(self.n_workers):
            self.procs.append(self._spawn(w, task))

    def _spawn(self, w: int, task: Dict[str, Any]):
        p = self._ctx.Process(
            target=_worker_main,
            args=(task, self.address, w, self.slowdowns[w], self._queue),
            name=f"ps-proc-worker-{w}", daemon=True)
        p.start()
        return p

    @staticmethod
    def _respawn_task(task: Dict[str, Any]) -> Dict[str, Any]:
        """The task a replacement worker runs: identical, minus the
        self-kill fault (a respawned worker re-killing itself at the
        same round would churn forever)."""
        clean = dict(task)
        fp = dict(clean.get("fault_plan") or {})
        if fp:
            fp["kill_worker"] = -1
            fp["kill_worker_round"] = -1
            clean["fault_plan"] = fp
        return clean

    def join(self, timeout: float = 900.0, *, endpoint=None,
             respawn: int = 0) -> List[WorkerResult]:
        """Join all workers; reap stragglers; surface per-worker results.

        ``endpoint`` (a ``PSServerEndpoint``) gets ``on_disconnect`` for
        every abnormal exit — transports without connection semantics
        (shmem) cannot detect a dead peer themselves, and a corpse must
        not keep its seat in the barrier group.

        ``respawn`` is the elastic-fleet budget: up to that many
        abnormally dead workers are replaced by fresh processes running
        the same task.  The corpse's seat is freed by ``on_disconnect``
        first, and the replacement's HELLO re-acquires it — exactly
        once.  The replacement restarts its loop from iteration 0.
        """
        deadline = time.monotonic() + timeout
        by_worker: Dict[int, WorkerResult] = {}
        reported = set()
        respawn_left = int(respawn)
        respawn_task = self._respawn_task(self.task.to_dict())
        # Poll instead of a blocking per-process join: a worker that
        # dies abnormally must release its barrier seat IMMEDIATELY, or
        # gate-blocked survivors would wait on the corpse for the rest
        # of the timeout.  Results are drained as they come: a child
        # exits only once its queued result is flushed to the pipe.
        while time.monotonic() < deadline:
            self._drain(by_worker)
            alive = False
            for w, p in enumerate(self.procs):
                if p.is_alive():
                    alive = True
                elif p.exitcode not in (0, None) and w not in reported:
                    if endpoint is not None:
                        endpoint.on_disconnect(w)
                    reported.add(w)
                    if respawn_left > 0:
                        respawn_left -= 1
                        by_worker.pop(w, None)
                        self.procs[w] = self._spawn(w, respawn_task)
                        self.respawned.append(w)
                        reported.discard(w)
                        alive = True
            if not alive:
                break
            time.sleep(0.05)
        self._drain(by_worker)
        results = []
        for w, p in enumerate(self.procs):
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            r = by_worker.get(w) or WorkerResult(w, 0, error="no result "
                                                 "(killed or timed out)")
            r.exitcode = p.exitcode
            if (r.error or p.exitcode not in (0, None)) \
                    and endpoint is not None and w not in reported:
                endpoint.on_disconnect(w)
            results.append(r)
        return results

    def _drain(self, into: Dict[int, WorkerResult]) -> None:
        import queue as _queue
        while True:
            try:
                r = self._queue.get_nowait()
            except _queue.Empty:
                return
            into[r.worker_id] = r

    def terminate(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=5.0)


def raise_on_failure(results: Sequence[WorkerResult]) -> None:
    failed = [r for r in results if r.error]
    if failed:
        msgs = "\n".join(f"-- worker {r.worker_id} "
                         f"(exit {r.exitcode}) --\n{r.error}"
                         for r in failed)
        raise RuntimeError(f"{len(failed)} worker process(es) failed:\n"
                           f"{msgs}")
