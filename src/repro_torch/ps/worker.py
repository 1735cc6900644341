"""Worker threads for the parameter-server layer.

Each worker runs the paper's loop (Alg. 1 worker block):

    pull w_s  →  replace local weights  →  compute grads on a mini-batch
    →  push grads  →  (blocked until the server sends OK)

``step_fn`` is ``(params, batch) -> (grads, aux)``; batches come from a
per-worker data shard.  A ``speed_factor > 1`` makes the worker
proportionally slower by sleeping ``(speed_factor − 1) ×
measured_compute`` per iteration — the paper's heterogeneous cluster on
one card.

``wire_format='packed'`` (the main path) speaks the packed wire
(``pull_packed``/``push_packed``): params and grads are ``(rows, 512)``
buffers.  ``wire_format='tree'`` pulls the parameter tree
(``server.pull``) and pushes the gradient tree (``server.push``).
With ``delta_pull=True`` (packed only) the worker keeps a resident
packed buffer ON THE DEVICE plus the per-shard version vector of its
last pull, and patches in place (``copy_``) only the shard regions that
advanced; after a live reshard (the server's shard count changed) it
rebuilds that buffer against the server's new plan and resyncs.  (The
reference
keeps a host buffer because JAX arrays are immutable; here the buffer is
simply overwritten, between steps, by the thread that owns it.)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch._compat import warn_legacy
from repro_torch import tree as tree_util
from repro_torch.api.protocol import ParameterServerProtocol
from repro_torch.obs.trace import TRACE

StepFn = Callable[[Any, Any], Any]  # (params, batch) -> (grads, aux)


def wait_for(t: Any) -> None:
    """Block until the work that produced ``t`` (a tensor or a tree of
    them) is done.

    On CUDA: an event recorded on the current stream, then
    ``event.synchronize()``.  Every worker thread issues onto the same
    stream, so a device-wide ``torch.cuda.synchronize()`` would also wait
    for the OTHER workers' queued work and charge it to this worker's
    step — skewing the measured compute that the straggler emulation
    scales.  On the CPU the work is already done."""
    if not isinstance(t, torch.Tensor):
        t = tree_util.leaves(t)[0]
    if t.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()


class PSWorker(threading.Thread):
    def __init__(self, worker_id: int, server: ParameterServerProtocol,
                 step_fn: StepFn, batches: Iterator[Any], n_iterations: int,
                 *, speed_factor: float = 1.0,
                 loss_from_aux: Optional[Callable[[Any], float]] = None,
                 wire_format: str = "packed",
                 delta_pull: bool = False,
                 name: Optional[str] = None):
        super().__init__(name=name or f"ps-worker-{worker_id}", daemon=True)
        warn_legacy("PSWorker",
                    "repro_torch.api.build_session (sessions construct and "
                    "join their own workers)")
        if wire_format not in ("tree", "packed"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if delta_pull and wire_format != "packed":
            raise ValueError("delta_pull tracks per-shard versions of "
                             "the packed snapshot; it requires "
                             "wire_format='packed'")
        self.worker_id = worker_id
        self.server = server
        self.step_fn = step_fn
        self.batches = batches
        self.n_iterations = n_iterations
        self.speed_factor = speed_factor
        self.loss_from_aux = loss_from_aux
        self.wire_format = wire_format
        self.delta_pull = delta_pull
        self.iterations_done = 0
        #: measured seconds of each step (without the straggler sleep)
        self.compute_s: list = []
        self.failure: Optional[BaseException] = None

    def _delta_puller(self) -> Callable[[int], torch.Tensor]:
        """Version-delta pulls into a resident device buffer: only the
        shard regions whose version advanced are copied in, in place
        (the bootstrap vector of -1s makes the first delta carry every
        shard).  Returns a drop-in replacement for ``pull_packed``."""
        from repro_torch.wireformat import WIRE_LANES
        state = {}

        def rebuild() -> None:
            # against the server's CURRENT plan (an in-heap worker shares
            # the server's objects, so ``server.plan`` IS the new plan)
            layout = self.server.plan.wire_layout()
            state["layout"] = layout
            state["resident"] = torch.zeros(
                (layout.total_rows, WIRE_LANES), dtype=layout.dtype,
                device=self.server.device)
            state["versions"] = (-1,) * len(layout.shard_rows)

        rebuild()

        def pull(worker_id: int) -> torch.Tensor:
            d = self.server.pull_delta(worker_id, state["versions"])
            while len(d.versions) != len(state["versions"]):
                # Live reshard: the server's arity moved under us.
                # Rebuild the resident buffer and re-bootstrap; if the
                # plan moves yet again meanwhile, resync once more.
                rebuild()
                d = self.server.pull_delta(worker_id, state["versions"])
            state["versions"] = d.versions
            layout, resident = state["layout"], state["resident"]
            for j, region in zip(d.shards, d.regions):
                start = layout.shard_row_start[j]
                resident[start:start + region.shape[0]].copy_(region)
            return resident

        return pull

    def run(self) -> None:
        packed = self.wire_format == "packed"
        pull = (self._delta_puller() if self.delta_pull
                else self.server.pull_packed if packed
                else self.server.pull)
        push = self.server.push_packed if packed else self.server.push
        try:
            for it in range(self.n_iterations):
                if self.server.stopped:
                    break
                params = pull(self.worker_id)
                t_tr = TRACE.now() if TRACE.enabled else 0.0
                t0 = time.monotonic()
                grads, aux = self.step_fn(params, next(self.batches))
                wait_for(grads)
                compute = time.monotonic() - t0
                self.compute_s.append(compute)
                if self.speed_factor > 1.0:
                    # The sleep IS the emulated (slower-device) compute,
                    # so the compute_step span includes it.
                    time.sleep(compute * (self.speed_factor - 1.0))
                if TRACE.enabled:
                    TRACE.span("compute_step", t_tr,
                               worker=self.worker_id, clock=it)
                if self.loss_from_aux is not None:
                    self.server.record_loss(it, self.loss_from_aux(aux))
                push(self.worker_id, grads)
                self.iterations_done += 1
        except BaseException as e:  # surfaced by run_cluster
            self.failure = e
        finally:
            # Leave the barrier group on ANY exit — completion, a stopped
            # server or a crash: a departed worker must not gate the
            # survivors.
            self.server.remove_worker(self.worker_id)


def run_cluster(server: ParameterServerProtocol, workers: list,
                timeout: float = 600.0) -> None:
    """Start all workers, join them, re-raise the first worker failure."""
    for w in workers:
        w.start()
    deadline = time.monotonic() + timeout
    for w in workers:
        w.join(timeout=max(0.0, deadline - time.monotonic()))
    server.stop()
    for w in workers:
        w.join(timeout=5.0)
        if w.failure is not None:
            raise w.failure
    alive = [w.name for w in workers if w.is_alive()]
    if alive:
        raise TimeoutError(f"workers did not finish: {alive}")
