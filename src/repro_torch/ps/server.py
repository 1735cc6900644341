"""Threaded parameter server, its optimizer and its coalescing window.

Counterpart of ``repro/ps/server.py``.  ``ParameterServer`` holds the
globally shared weights, applies pushed gradients under one lock (paper
Alg. 1 line 2: concurrent pushes are serialised) and gates workers
through the configured ``SyncPolicy``.  Workers are threads running the
port's training step; every thread issues onto the device's one stream.

The server optimizer is momentum SGD (workers send raw gradients),
optionally damped by 1/(1+staleness) (Omnivore-style momentum
tempering).  Every apply writes NEW tensors — the fused kernels'
outputs — so a reference to the server's weights is a consistent
snapshot: nothing a worker pulled is ever updated in place.

``CoalesceWindow`` is shared by both servers (one per lock domain: the
mono server, or each shard of the sharded server): concurrent packed
applies fold through ONE ``fused_update_batched`` launch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.api.protocol import DeltaPull, ParameterServerProtocol
from repro_torch.core.policies import SyncPolicy
from repro_torch.core.staleness import StalenessTracker
from repro_torch.kernels.fused_update import fused_update, fused_update_batched
from repro_torch.obs.trace import TRACE
from repro_torch.perfcount import WIRE
from repro_torch.ps.metrics import RunMetrics
from repro_torch.ps.sharded.plan import build_shard_plan

Params = Any  # tree of tensors
Grads = Any

#: Default linger (seconds) a coalescing flusher waits for its window
#: to fill before launching a partial batch — small next to a training
#: step, long enough for concurrently pushing workers to meet.
DEFAULT_COALESCE_WAIT_S = 0.05


class CoalesceWindow:
    """Bounded micro-batching window over packed applies.

    ``submit`` is called UNDER ``cond`` with one contribution; the first
    contributor with no flush in flight becomes the *flusher*: it
    lingers up to ``server.coalesce_wait`` for the window to fill
    (capped at the live worker count, recomputed on every wake-up, so a
    departing worker shrinks an in-flight linger), drains up to
    ``server.coalesce`` contributions, and folds them through ONE
    ``fused_update_batched`` launch in enqueue order.  The dispatch runs
    with ``cond`` RELEASED so concurrent pushes can queue into the next
    window; ``install`` re-installs the buffers and the version bump
    together under the lock, so readers never see a version that does
    not match the resident buffer.  Later contributors wait until the
    flusher has applied their sequence number.

    ``server`` supplies the live knobs (``coalesce``, ``coalesce_wait``,
    ``stopped``, ``_clock``); ``get_pm`` returns the resident (params,
    momentum) wire buffers; ``install(p, m, n)`` commits them plus an
    ``n``-contribution version bump (called under ``cond``).  ``shard``
    labels the ``coalesce_flush`` span.
    """

    def __init__(self, server, cond, optimizer, tracker, get_pm, install,
                 shard: int = -1):
        self.server = server
        self.cond = cond
        self.optimizer = optimizer
        self.tracker = tracker
        self.get_pm = get_pm
        self.install = install
        self.shard = shard
        self.pending: list = []      # (wire_g, scale) tuples
        self.applying = False        # a flusher owns the window
        self.enq_seq = 0             # contributions ever queued
        self.applied_seq = 0         # contributions ever applied

    def submit(self, wire_g: torch.Tensor, scale: float) -> None:
        """Queue one contribution (called under ``cond``) and return
        once it has been applied."""
        srv = self.server
        self.pending.append((wire_g, scale))
        self.enq_seq += 1
        my_seq = self.enq_seq
        self.cond.notify_all()       # wake a lingering flusher
        if self.applying:
            while self.applied_seq < my_seq and not srv.stopped:
                self.cond.wait(timeout=0.5)
            return
        self.applying = True
        try:
            def window() -> int:
                return max(1, min(srv.coalesce, len(self.tracker.workers)))

            while self.pending and not srv.stopped:
                if srv.coalesce_wait > 0.0 and len(self.pending) < window():
                    deadline = srv._clock() + srv.coalesce_wait
                    while (len(self.pending) < window()
                           and not srv.stopped):
                        remaining = deadline - srv._clock()
                        if remaining <= 0:
                            break
                        self.cond.wait(timeout=remaining)
                batch = self.pending[:srv.coalesce]
                del self.pending[:len(batch)]
                self._flush(batch)
        finally:
            self.applying = False
            self.cond.notify_all()

    def _flush(self, batch: list) -> None:
        """One batched launch over ``batch`` (called under ``cond``;
        drops the lock for the kernel dispatch)."""
        t0 = TRACE.now() if TRACE.enabled else 0.0
        opt = self.optimizer
        p, m = self.get_pm()
        self.cond.release()
        try:
            new_p, new_m = fused_update_batched(
                p, m, [b for b, _ in batch], lr=opt.lr, beta=opt.momentum,
                scales=[s for _, s in batch])
        finally:
            self.cond.acquire()
        self.install(new_p, new_m, len(batch))
        self.applied_seq += len(batch)
        if len(batch) > 1:
            WIRE.apply_launches_saved += len(batch) - 1
        if TRACE.enabled:
            TRACE.span("coalesce_flush", t0, shard=self.shard,
                       args={"n": len(batch)})
        self.cond.notify_all()


class ServerOptimizer:
    """SGD with optional momentum + staleness-aware damping.

    The packed servers run the step as the fused kernel over whole
    regions, reading only the hyper-parameters here; ``step`` is the
    tree-wire apply, one ``fused_update`` per leaf, with momentum kept
    per leaf (like the reference's per-leaf velocity tree).
    """

    def __init__(self, lr: float, momentum: float = 0.0,
                 staleness_damping: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.staleness_damping = staleness_damping
        self._velocity: Optional[Params] = None

    def scale(self, staleness: int) -> float:
        """The gradient's step scale for a push of this staleness."""
        return 1.0 / (1.0 + staleness) if self.staleness_damping else 1.0

    def step(self, params: Params, grads: Grads, staleness: int) -> Params:
        """New parameters (new tensors) after one momentum step."""
        pl, treedef = tree_util.flatten(params)
        gl = tree_util.leaves(grads)
        if len(pl) != len(gl):
            raise ValueError(f"{len(gl)} gradient leaves for {len(pl)} "
                             "parameter leaves")
        vl = (tree_util.leaves(self._velocity)
              if self._velocity is not None
              else [torch.zeros_like(p) for p in pl])
        scale = self.scale(staleness)
        new_p, new_v = [], []
        for p, v, g in zip(pl, vl, gl):
            po, vo = fused_update(p, v, g.to(p.dtype), lr=self.lr,
                                  beta=self.momentum, scale=scale)
            new_p.append(po)
            new_v.append(vo)
        self._velocity = tree_util.unflatten(treedef, new_v)
        return tree_util.unflatten(treedef, new_p)


class ParameterServer(ParameterServerProtocol):
    """Global weight store + Algorithm-1 gating.  Thread-safe.

    ``apply_mode='packed'`` makes the plan's lane-aligned (rows, 512)
    wire buffer the resident representation: params + momentum live
    packed, a tree push packs ONCE and folds through a single fused
    launch, and ``push_packed``/``pull_packed`` skip the tree<->wire
    boundary entirely (the monolithic counterpart of the sharded
    server's packed hot path).  ``coalesce > 1`` (packed only) folds
    concurrent pushes through ``CoalesceWindow``.
    """

    def __init__(self, params: Params, policy: SyncPolicy,
                 optimizer: ServerOptimizer, n_workers: int,
                 clock: Callable[[], float] = time.monotonic,
                 apply_mode: str = "tree", coalesce: int = 1,
                 coalesce_wait: Optional[float] = None):
        if apply_mode not in ("tree", "packed"):
            raise ValueError(f"unknown apply mode {apply_mode!r}")
        if coalesce < 1:
            raise ValueError(f"coalesce window must be >= 1, got {coalesce}")
        if coalesce > 1 and apply_mode != "packed":
            raise ValueError("coalesce > 1 batches packed applies; it "
                             "requires apply_mode='packed'")
        self._params: Optional[Params] = params
        self.policy = policy
        self.optimizer = optimizer
        self.apply_mode = apply_mode
        self.tracker = StalenessTracker(range(n_workers))
        self.metrics = RunMetrics(policy=policy.name, n_workers=n_workers)
        self._cond = threading.Condition()
        self._clock = clock
        self._t0 = clock()
        self.version = 0          # number of applied updates
        self.stopped = False
        self.coalesce = coalesce
        self.coalesce_wait = (coalesce_wait if coalesce_wait is not None
                              else (DEFAULT_COALESCE_WAIT_S
                                    if coalesce > 1 else 0.0))
        self.device = tree_util.leaves(params)[0].device
        if apply_mode == "packed":
            self.plan = build_shard_plan(params, 1)
            self._wire_p = self.plan.pack(params)
            self._wire_m = torch.zeros_like(self._wire_p)
            self._window = CoalesceWindow(
                self, self._cond, optimizer, self.tracker,
                self._get_pm, self._install_pm, shard=0)
        else:
            self.plan = None

    # -- worker API -----------------------------------------------------------
    def pull(self, worker: int) -> Params:
        """The latest global weights.  Packed mode keeps a
        version-keyed unpacked cache, rebuilt OUTSIDE the lock."""
        t0 = TRACE.now() if TRACE.enabled else 0.0
        with self._cond:
            if self._params is not None:
                params = self._params
                if TRACE.enabled:
                    TRACE.span("pull", t0, worker=worker,
                               args={"version": self.version,
                                     "cached": True})
                return params
            wire, version = self._wire_p, self.version
        params = self.plan.unpack(wire)
        with self._cond:
            if self.version == version and self._params is None:
                self._params = params
            if TRACE.enabled:
                TRACE.span("pull", t0, worker=worker,
                           args={"version": version, "cached": False})
            return params

    def pull_packed(self, worker: int = -1) -> torch.Tensor:
        """The packed wire buffer itself — already a consistent snapshot."""
        if self.apply_mode != "packed":
            raise ValueError("pull_packed requires apply_mode='packed'")
        t0 = TRACE.now() if TRACE.enabled else 0.0
        with self._cond:
            wire, version = self._wire_p, self.version
        if TRACE.enabled:
            TRACE.span("pull", t0, worker=worker,
                       args={"version": version, "packed": True})
        return wire

    def pull_delta(self, worker: int,
                   versions: Optional[Any] = None) -> DeltaPull:
        """Single-shard version-delta pull: the whole buffer when the
        version moved (or on a vector mismatch — ``full=True``), an
        empty delta when the worker is already current."""
        if self.apply_mode != "packed":
            raise ValueError("pull_delta requires apply_mode='packed'")
        t0 = TRACE.now() if TRACE.enabled else 0.0
        with self._cond:
            wire, version = self._wire_p, self.version
        full_bytes = wire.numel() * wire.element_size()
        mismatch = (versions is None or len(versions) != 1
                    or int(versions[0]) > version)
        if not mismatch and int(versions[0]) == version:
            WIRE.full_pull_bytes_avoided += full_bytes
            if TRACE.enabled:
                TRACE.span("pull_delta", t0, worker=worker,
                           args={"version": version, "empty": True})
            return DeltaPull(versions=(version,))
        WIRE.delta_bytes_tx += full_bytes
        if TRACE.enabled:
            TRACE.span("pull_delta", t0, worker=worker,
                       args={"version": version, "full": mismatch})
        return DeltaPull(versions=(version,), shards=(0,),
                         regions=(wire,), full=mismatch)

    def push(self, worker: int, grads: Grads) -> None:
        """Alg. 1 server block: update weights, then gate.  Blocks the
        calling worker thread until the policy releases it."""
        self._push(worker, grads, packed=False)

    def push_packed(self, worker: int, wire: torch.Tensor) -> None:
        """Packed-wire push: the gradient arrives in wire layout and
        folds straight through one fused launch — zero server-side
        packing."""
        if self.apply_mode != "packed":
            raise ValueError("push_packed requires apply_mode='packed'")
        if tuple(wire.shape) != tuple(self._wire_p.shape):
            raise ValueError(f"wire buffer {tuple(wire.shape)} does not "
                             f"match layout {tuple(self._wire_p.shape)}")
        self._push(worker, wire, packed=True)

    def _push(self, worker: int, payload: Any, packed: bool) -> None:
        t_push = TRACE.now() if TRACE.enabled else 0.0
        if self.apply_mode == "packed" and not packed:
            # Pack BEFORE taking the lock, so concurrent pulls and pushes
            # never wait behind the copy.
            payload = self.plan.pack(payload)
        with self._cond:
            now = self._clock() - self._t0
            rec = self.tracker.record_push(worker, now)
            dec = self.policy.on_push(self.tracker, worker, now)
            if dec.apply_update:
                t_apply = TRACE.now() if TRACE.enabled else 0.0
                if self.apply_mode == "packed":
                    scale = self.optimizer.scale(rec.staleness)
                    if self.coalesce > 1:
                        self._window.submit(payload, scale)
                    else:
                        self._apply_packed(payload, scale)
                        self.version += 1
                else:
                    self._params = self.optimizer.step(
                        self._params, payload, rec.staleness)
                    self.version += 1
                if TRACE.enabled:
                    TRACE.span("apply", t_apply, worker=worker,
                               clock=rec.iteration)
            self.metrics.record_push(
                worker, rec.staleness, applied=dec.apply_update,
                credit=dec.credit_used, time=now)
            self._cond.notify_all()
            if not dec.release_now:
                t_wait = TRACE.now() if TRACE.enabled else 0.0
                arrival = self._clock()
                while (not self.stopped
                       and not self.policy.may_release(self.tracker, worker)):
                    self._cond.wait(timeout=0.5)
                waited = self._clock() - arrival
                rec.waited = waited
                self.metrics.record_wait(worker, waited)
                if TRACE.enabled:
                    TRACE.span("gate_wait", t_wait, worker=worker,
                               clock=rec.iteration)
            if TRACE.enabled:
                TRACE.span("push", t_push, worker=worker,
                           clock=rec.iteration,
                           args={"staleness": rec.staleness,
                                 "applied": dec.apply_update,
                                 "credit": dec.credit_used})

    def _apply_packed(self, wire_g: torch.Tensor, scale: float) -> None:
        opt = self.optimizer
        self._wire_p, self._wire_m = fused_update(
            self._wire_p, self._wire_m, wire_g,
            lr=opt.lr, beta=opt.momentum, scale=scale)
        self._params = None

    # -- coalescing-window plumbing (see ``CoalesceWindow``) ------------------
    def _get_pm(self):
        return self._wire_p, self._wire_m

    def _install_pm(self, p, m, n: int) -> None:
        self._wire_p, self._wire_m = p, m
        self._params = None
        self.version += n

    def record_loss(self, step: int, loss: float) -> None:
        """Record (wall_time, applied_update_count, loss)."""
        with self._cond:
            now = self._clock() - self._t0
            self.metrics.record_loss_point(now, self.version, float(loss))

    # -- elastic membership ---------------------------------------------------
    def add_worker(self, worker: int) -> None:
        with self._cond:
            self.tracker.add_worker(worker)
            self.metrics.n_workers = len(self.tracker.workers)

    def remove_worker(self, worker: int) -> None:
        """A departing/failed worker must not stall the barrier: drop it
        from the tracker so gap computations ignore it, then wake
        waiters (and a lingering flusher, whose window shrinks)."""
        with self._cond:
            self.tracker.remove_worker(worker)
            self.metrics.n_workers = len(self.tracker.workers)
            self._cond.notify_all()

    def stop(self) -> None:
        """Unblock everything (end of training / fault injection)."""
        with self._cond:
            self.stopped = True
            self._cond.notify_all()

    # -- inspection -----------------------------------------------------------
    def staleness_profile(self) -> Dict[int, int]:
        with self._cond:
            return self.tracker.staleness_profile()
