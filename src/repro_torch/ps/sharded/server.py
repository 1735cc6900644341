"""Sharded (partitioned) parameter server — per-shard locks and gating.

Counterpart of the core of ``repro/ps/sharded/server.py``.  The weight
tree is partitioned by a ``ShardPlan`` into S size-balanced shards, and
every shard owns its own

  * lock (condition variable)      — pushes to distinct shards overlap,
  * version counter                — per-shard applied-update count,
  * ``ServerOptimizer`` settings   — momentum lives with its slice,
  * ``SyncPolicy`` + ``StalenessTracker`` — per-shard Algorithm-1 gating,
  * ``RunMetrics``                 — per-shard staleness/wait accounting.

Every shard keeps params + momentum resident in the plan's packed wire
layout (an 8-row-aligned ``(rows, 512)`` region) on the server's
device.  ``push_packed`` slices the worker's gradient wire into per-shard
row views; each shard's policy gates the push and its region folds in
through ONE ``fused_update`` kernel launch, which writes NEW buffers —
the old ones stay valid for whoever pulled them, so a reference to a
shard's buffer IS a consistent snapshot.  ``pull_packed`` serves a
version-keyed concatenated snapshot built outside the shard locks;
``pull_delta`` ships only the shards whose version moved.

Every shard gates independently (``gating='sharded'``).  Not ported yet,
and refused at construction: the global gate, tree-wire applies, wire
compression (ROADMAP queue 1, item 7), coalesced applies
(``coalesce > 1``, queue 1 item 3 with queue 2 kernel 2) and live
resharding (queue 1, item 8).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.api.protocol import DeltaPull, ParameterServerProtocol
from repro_torch.core.policies import SyncPolicy
from repro_torch.core.staleness import StalenessTracker
from repro_torch.kernels.fused_update import fused_update
from repro_torch.obs.trace import TRACE
from repro_torch.perfcount import WIRE
from repro_torch.ps.metrics import RunMetrics
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.plan import ShardPlan, build_shard_plan
from repro_torch.wireformat import WIRE_LANES

Params = Any


class _ShardState:
    """Everything one shard owns.  All mutation under ``self.cond``."""

    def __init__(self, index: int, packed_p: torch.Tensor,
                 policy: SyncPolicy, optimizer: ServerOptimizer,
                 workers: Sequence[int]):
        self.index = index
        self.cond = threading.Condition()
        self.policy = policy
        self.optimizer = optimizer
        self.tracker = StalenessTracker(workers)
        self.metrics = RunMetrics(policy=f"{policy.name}/shard{index}",
                                  n_workers=len(list(workers)))
        self.version = 0
        self._packed_p = packed_p
        self._packed_m = torch.zeros_like(packed_p)

    def apply_packed(self, wire_g: torch.Tensor, staleness: int) -> None:
        """Fold the shard's (rows, 512) gradient region through one
        ``fused_update`` launch.  The kernel writes new buffers: earlier
        snapshots of this shard stay untouched."""
        if wire_g.shape[0] == 0:      # empty shard (more shards than pieces)
            self.version += 1
            return
        opt = self.optimizer
        self._packed_p, self._packed_m = fused_update(
            self._packed_p, self._packed_m, wire_g, lr=opt.lr,
            beta=opt.momentum, scale=opt.scale(staleness))
        self.version += 1


class ShardedParameterServer(ParameterServerProtocol):
    """Partitioned weight store + per-shard Algorithm-1 gating."""

    def __init__(self, params: Params, policy_factory: Callable[[], SyncPolicy],
                 optimizer_factory: Callable[[], ServerOptimizer],
                 n_workers: int, n_shards: int, *,
                 split_oversized: bool = True,
                 gating: str = "sharded",
                 apply_mode: str = "fused",
                 wire_compression: Optional[str] = None,
                 coalesce: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if gating != "sharded":
            raise NotImplementedError(
                f"gating={gating!r}: only per-shard gating is ported "
                "(ROADMAP queue 1, item 3)")
        if apply_mode != "fused":
            raise NotImplementedError(
                f"apply_mode={apply_mode!r}: only the packed fused apply is "
                "ported (ROADMAP queue 1, item 3)")
        if wire_compression not in (None, "none", ""):
            raise NotImplementedError(
                "wire compression comes with ROADMAP queue 1, item 7")
        if coalesce != 1:
            raise NotImplementedError(
                "coalesce > 1 (CoalesceWindow + fused_update_batched) comes "
                "with ROADMAP queue 1, item 3 and queue 2, kernel 2")
        self.plan: ShardPlan = build_shard_plan(
            params, n_shards, split_oversized=split_oversized)
        self.gating = gating
        self.n_shards = n_shards
        self.apply_mode = apply_mode
        self.coalesce = coalesce
        workers = range(n_workers)
        wire = self.plan.pack(params)
        self.shards: List[_ShardState] = [
            _ShardState(j, self.plan.shard_wire(wire, j).clone(),
                        policy_factory(), optimizer_factory(), workers)
            for j in range(n_shards)]
        del wire
        self.metrics = RunMetrics(
            policy=f"{self.shards[0].policy.name} xS{n_shards}[{gating}]",
            n_workers=n_workers)
        self._metrics_lock = threading.Lock()
        # Version-keyed packed snapshot cache for ``pull_packed``.
        self._snap_lock = threading.Lock()
        self._snap_key: Optional[tuple] = None
        self._snap_wire: Optional[torch.Tensor] = None
        self._clock = clock
        self._t0 = clock()
        self.stopped = False

    # -- pulls ---------------------------------------------------------------
    def _snapshot_refs(self):
        """(per-shard buffers, versions), each pair grabbed under its own
        shard lock — buffers are never mutated, so a reference is a
        consistent snapshot."""
        snaps, versions = [], []
        for st in self.shards:
            with st.cond:
                snaps.append(st._packed_p)
                versions.append(st.version)
        return snaps, versions

    def pull_packed(self, worker: int = -1) -> torch.Tensor:
        """Full (total_rows, 512) wire snapshot of the parameters.

        The concatenation happens OUTSIDE every shard lock and is cached
        keyed by the shard-version vector, so pulls between applies are a
        dictionary hit.  A slower concurrent pull installs its result
        only if it dominates the cached key (component-wise >=,
        somewhere >), so the cache never moves backwards.
        """
        t0 = TRACE.now() if TRACE.enabled else 0.0
        snaps, versions = self._snapshot_refs()
        key = tuple(versions)
        with self._snap_lock:
            if self._snap_key == key:
                if TRACE.enabled:
                    TRACE.span("pull", t0, worker=worker,
                               args={"packed": True, "cached": True})
                return self._snap_wire
        bufs = [b for b in snaps if b.shape[0]]
        wire = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
        with self._snap_lock:
            cached = self._snap_key
            if cached is None or (
                    all(n >= c for n, c in zip(key, cached))
                    and any(n > c for n, c in zip(key, cached))):
                self._snap_key, self._snap_wire = key, wire
        if TRACE.enabled:
            TRACE.span("pull", t0, worker=worker,
                       args={"packed": True, "cached": False})
        return wire

    def pull(self, worker: int) -> Params:
        """The parameter tree: views into a packed snapshot."""
        return self.plan.unpack(self.pull_packed(worker))

    def pull_delta(self, worker: int,
                   versions: Optional[Sequence[int]]) -> DeltaPull:
        """Version-delta pull: ship only the shards that advanced.

        ``versions`` is the vector the worker saw on its last pull; the
        reply carries the regions of shards whose version moved plus the
        fresh vector.  A vector of the wrong arity, or one ahead of the
        server, falls back to a full snapshot (``full=True``).
        """
        t0 = TRACE.now() if TRACE.enabled else 0.0
        snaps, cur = self._snapshot_refs()
        n_shards = len(snaps)
        layout = self.plan.wire_layout()
        itemsize = torch.empty((), dtype=layout.dtype).element_size()
        full_bytes = layout.total_rows * WIRE_LANES * itemsize
        mismatch = (versions is None or len(versions) != n_shards
                    or any(int(v) > c for v, c in zip(versions, cur)))
        if mismatch:
            changed = [j for j in range(n_shards) if snaps[j].shape[0]]
        else:
            changed = [j for j, (v, c) in enumerate(zip(versions, cur))
                       if int(v) != c and snaps[j].shape[0]]
        regions = tuple(snaps[j] for j in changed)
        delta_bytes = sum(int(r.shape[0]) for r in regions) \
            * WIRE_LANES * itemsize
        WIRE.delta_bytes_tx += delta_bytes
        if not mismatch:
            WIRE.full_pull_bytes_avoided += full_bytes - delta_bytes
        if TRACE.enabled:
            TRACE.span("pull_delta", t0, worker=worker,
                       args={"shards": len(changed), "bytes": delta_bytes,
                             "full": mismatch})
        return DeltaPull(versions=tuple(cur), shards=tuple(changed),
                         regions=regions, full=mismatch)

    # -- pushes --------------------------------------------------------------
    def push_packed(self, worker: int, wire, epoch: Optional[int] = None
                    ) -> None:
        """Packed-wire push: the zero-repack hot path.

        ``wire`` is the full (total_rows, 512) buffer or a list of
        per-shard regions.  The server only takes row-range VIEWS, each
        shard folds its region through one ``fused_update`` launch, and
        nothing keeps a reference to ``wire`` after this call returns
        (the worker reuses the buffer for its next gradient).  Blocks
        until every shard's policy has released the worker.
        """
        if epoch not in (None, 0):
            raise NotImplementedError(
                "reshard epochs come with ROADMAP queue 1, item 8")
        layout = self.plan.wire_layout()
        if isinstance(wire, (list, tuple)):
            shard_bufs = list(wire)
            if len(shard_bufs) != self.n_shards:
                raise ValueError(f"got {len(shard_bufs)} shard buffers, "
                                 f"plan has {self.n_shards} shards")
            for j, buf in enumerate(shard_bufs):
                if tuple(buf.shape) != (layout.shard_rows[j], WIRE_LANES):
                    raise ValueError(
                        f"shard {j}: buffer {tuple(buf.shape)} does not "
                        f"match layout ({layout.shard_rows[j]}, "
                        f"{WIRE_LANES})")
        else:
            # Slicing clamps, so an undersized buffer would silently hand
            # trailing shards an empty region — reject it up front.
            if tuple(wire.shape) != (layout.total_rows, WIRE_LANES):
                raise ValueError(
                    f"wire buffer {tuple(wire.shape)} does not match layout "
                    f"({layout.total_rows}, {WIRE_LANES})")
            shard_bufs = self.plan.shard_wires(wire)
        self._push_payloads(worker, shard_bufs)

    def _push_payloads(self, worker: int, payloads: Sequence[Any]) -> None:
        """Every worker visits shards in the SAME order 0..S-1: with
        blocking policies a per-worker rotated order deadlocks (a
        circular wait across two shards' barriers)."""
        t_push = TRACE.now() if TRACE.enabled else 0.0
        now = self._clock() - self._t0
        max_stale, any_applied, any_credit = 0, False, False
        total_wait = 0.0
        for st, payload in zip(self.shards, payloads):
            stale, applied, credit, waited = self._push_shard(
                st, worker, payload)
            max_stale = max(max_stale, stale)
            any_applied = any_applied or applied
            any_credit = any_credit or credit
            total_wait += waited
        with self._metrics_lock:
            self.metrics.record_push(worker, max_stale, applied=any_applied,
                                     credit=any_credit, time=now)
            if total_wait > 0:
                self.metrics.record_wait(worker, total_wait)
            clock = self.metrics.pushes.get(worker, -1)
        if TRACE.enabled:
            TRACE.span("push", t_push, worker=worker, clock=clock,
                       args={"staleness": max_stale, "applied": any_applied,
                             "credit": any_credit})

    def _push_shard(self, st: _ShardState, worker: int, payload: Any):
        j = st.index
        with st.cond:
            now = self._clock() - self._t0
            rec = st.tracker.record_push(worker, now)
            dec = st.policy.on_push(st.tracker, worker, now)
            if dec.apply_update:
                t_apply = TRACE.now() if TRACE.enabled else 0.0
                st.apply_packed(payload, rec.staleness)
                if TRACE.enabled:
                    TRACE.span("apply", t_apply, worker=worker, shard=j,
                               clock=rec.iteration)
            st.metrics.record_push(worker, rec.staleness,
                                   applied=dec.apply_update,
                                   credit=dec.credit_used, time=now)
            st.cond.notify_all()
            waited = 0.0
            if not dec.release_now:
                t_wait = TRACE.now() if TRACE.enabled else 0.0
                arrival = self._clock()
                while (not self.stopped
                       and not st.policy.may_release(st.tracker, worker)):
                    st.cond.wait(timeout=0.5)
                waited = self._clock() - arrival
                rec.waited = waited
                st.metrics.record_wait(worker, waited)
                if TRACE.enabled:
                    TRACE.span("gate_wait", t_wait, worker=worker, shard=j,
                               clock=rec.iteration)
            return rec.staleness, dec.apply_update, dec.credit_used, waited

    # -- accounting ----------------------------------------------------------
    def record_loss(self, step: int, loss: float) -> None:
        with self._metrics_lock:
            now = self._clock() - self._t0
            self.metrics.record_loss_point(now, self.version, float(loss))

    # -- elastic membership --------------------------------------------------
    def add_worker(self, worker: int) -> None:
        for st in self.shards:
            with st.cond:
                st.tracker.add_worker(worker)
                st.metrics.n_workers = len(st.tracker.workers)
                st.cond.notify_all()
        with self._metrics_lock:
            self.metrics.n_workers = len(self.shards[0].tracker.workers)

    def remove_worker(self, worker: int) -> None:
        """Departure must not stall ANY shard's barrier: drop the worker
        from every shard tracker, waking that shard's waiters."""
        for st in self.shards:
            with st.cond:
                st.tracker.remove_worker(worker)
                st.metrics.n_workers = len(st.tracker.workers)
                st.cond.notify_all()
        with self._metrics_lock:
            self.metrics.n_workers = len(self.shards[0].tracker.workers)

    def reshard(self, n_shards: int) -> bool:
        raise NotImplementedError(
            "live resharding comes with ROADMAP queue 1, item 8")

    def stop(self) -> None:
        self.stopped = True
        for st in self.shards:
            with st.cond:
                st.cond.notify_all()

    # -- inspection ----------------------------------------------------------
    @property
    def version(self) -> int:
        """Total applied shard-updates."""
        return sum(st.version for st in self.shards)

    def shard_versions(self) -> List[int]:
        return [st.version for st in self.shards]
