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

Left for ROADMAP queue 1, item 8: the reference worker's fault plan,
trace spill and flushes, reconnect budget and live-reshard rebuild.  A
delta reply whose reshard epoch or shard arity differs from the
worker's raises ``FrameError`` rather than rebuilding.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
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

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_spec(cls, spec, n_iterations: int, *, device: str = "cuda:0",
                  model_config=None) -> "WorkerTask":
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
                   model_config=model_config)


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
        from repro_torch.models import registry
        from repro_torch.perfcount import LAUNCHES, TRANSPORT
        from repro_torch.ps.sharded.plan import build_shard_plan
        from repro_torch.transport import connect
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
        layout = plan.wire_layout()
        step = packed_step(cfg, plan, device)
        stream = worker_batches(cfg, data_cfg, worker_id, device)

        client = connect(address, worker_id, compress=task["compress"])
        rows = client.hello()
        if rows != layout.total_rows:
            raise ValueError(
                f"server wire layout has {rows} rows, local plan derives "
                f"{layout.total_rows} — task spec out of sync with server")
        # Version-delta pulls keep a RESIDENT buffer on the device: only
        # the shard regions whose version advanced cross the wire, and
        # they are copied into it in place straight from the receive
        # buffer.
        delta_pull = bool(task["delta_pull"])
        resident = (torch.zeros((layout.total_rows, WIRE_LANES),
                                dtype=layout.dtype, device=device)
                    if delta_pull else None)
        state = {"versions": (-1,) * task["n_shards"]}
        row_start = layout.shard_row_start
        epoch = client.reshard_epoch

        def pull():
            """The latest params on the device, or None once the server
            has stopped.  The reply's tensors view the transport's
            receive buffer; they are copied and dropped here, before the
            next request (a view left alive would pin a shmem slot)."""
            if not delta_pull:
                host = client.pull_packed(copy=False)
                return None if host is None else host.to(device, copy=True)
            d = client.pull_delta(state["versions"], copy=False)
            if d is None:
                return None
            if d.epoch != epoch or len(d.versions) != task["n_shards"]:
                raise FrameError(
                    f"delta reply at reshard epoch {d.epoch} with "
                    f"{len(d.versions)} shards, worker at epoch {epoch} "
                    f"with {task['n_shards']}: live resharding comes "
                    "with ROADMAP queue 1, item 8")
            for j, region in zip(d.shards, d.regions):
                resident[row_start[j]:row_start[j]
                         + region.shape[0]].copy_(region)
            state["versions"] = d.versions
            return resident

        LAUNCHES.reset()
        try:
            for it in range(task["n_iterations"]):
                t_it = time.monotonic()
                rx0 = TRANSPORT.bytes_rx
                wire_p = pull()
                if wire_p is None:
                    break  # server stopped
                result.pull_s.append(time.monotonic() - t_it)
                result.pull_bytes.append(TRANSPORT.bytes_rx - rx0)
                batch = next(stream)
                t0 = time.monotonic()
                wire_g, aux = step(wire_p, batch)
                loss = float(aux["loss"])   # waits for the step
                compute = time.monotonic() - t0
                result.compute_s.append(compute)
                if slowdown > 1.0:
                    # The sleep IS the emulated slower device.
                    time.sleep(compute * (slowdown - 1.0))
                client.record_loss(it, loss)
                t_push, tx0 = time.monotonic(), TRANSPORT.bytes_tx
                alive = client.push_packed(wire_g, clock=it)
                result.push_s.append(time.monotonic() - t_push)
                result.push_bytes.append(TRANSPORT.bytes_tx - tx0)
                result.iteration_s.append(time.monotonic() - t_it)
                result.iterations_done += 1
                if not alive:
                    break  # released with a STOP: training is over
        finally:
            client.bye()
            client.close()
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

    def start(self) -> None:
        task = self.task.to_dict()
        for w in range(self.n_workers):
            p = self._ctx.Process(
                target=_worker_main,
                args=(task, self.address, w, self.slowdowns[w],
                      self._queue),
                name=f"ps-proc-worker-{w}", daemon=True)
            p.start()
            self.procs.append(p)

    def join(self, timeout: float = 900.0, *,
             endpoint=None) -> List[WorkerResult]:
        """Join all workers; reap stragglers; surface per-worker results.

        ``endpoint`` (a ``PSServerEndpoint``) gets ``on_disconnect`` for
        every abnormal exit — transports without connection semantics
        (shmem) cannot detect a dead peer themselves, and a corpse must
        not keep its seat in the barrier group.
        """
        deadline = time.monotonic() + timeout
        by_worker: Dict[int, WorkerResult] = {}
        reported = set()
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
