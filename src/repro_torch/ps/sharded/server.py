"""Sharded (partitioned) parameter server — per-shard locks and gating.

Counterpart of ``repro/ps/sharded/server.py``.  The weight tree is
partitioned by a ``ShardPlan`` into S size-balanced shards, and every
shard owns its own

  * lock (condition variable)      — pushes to distinct shards overlap,
  * version counter                — per-shard applied-update count,
  * ``ServerOptimizer``            — momentum lives with its slice,
  * ``SyncPolicy`` + ``StalenessTracker`` — per-shard Algorithm-1 gating,
  * ``RunMetrics``                 — per-shard staleness/wait accounting.

Gating modes
------------
``sharded`` (default)  every shard gates independently with its own
    policy; a push returns when the LAST shard releases the worker.
``global``  one policy/tracker gates the worker exactly once per push
    (the monolithic semantics) while the weight store stays partitioned.

Apply modes
-----------
``fused`` keeps params + momentum resident in the plan's packed wire
layout (an 8-row-aligned ``(rows, 512)`` region) on the server's device
and folds a push through ONE ``fused_update`` launch per shard;
``tree`` steps the shard's piece list through its ``ServerOptimizer``.
Every apply writes NEW buffers — the old ones stay valid for whoever
pulled them, so a reference to a shard's buffer IS a consistent
snapshot.

Packed wire (the zero-repack hot path): ``push_packed`` slices the
worker's gradient wire into per-shard row views; ``pull_packed`` serves
a version-keyed concatenated snapshot built outside the shard locks;
``pull_delta`` ships only the shards whose version moved.

``coalesce=K`` arms a ``CoalesceWindow`` per shard: contributions that
arrive while a flush is in flight (or within the linger
``coalesce_wait``) fold through ONE ``fused_update_batched`` launch, in
enqueue order — bit for bit the uncoalesced applies — while the sync
policy still sees, decides and releases every worker individually.

Compression: ``wire_compression='int8'/'topk'`` compresses each packed
shard region through one fused kernel launch with a per-(worker, shard)
f32 error-feedback buffer on the server's device; ``compressor=`` (a
tree ``Compressor``) does the same per piece on the tree wire.

Live reshard (S -> S')
----------------------
``reshard(n_shards)`` migrates the packed parameter+momentum regions
into a new plan WITHOUT stopping training (migration map in
``repro_torch.ft.reshard``).  Old shards are retired one at a time under
their own locks (the only per-shard pause, traced as
``reshard_shard``); pushes that land on a retired shard PARK their
packed region and are replayed through the migration map after the
atomic ``(plan, shards, n_shards)`` swap — applied exactly once,
accounted in ``WIRE.reshard_parked``/``reshard_replayed``.  Each swap
bumps ``reshard_epoch``; stale-epoch pushes (clients that packed
against the old layout) are translated through the retained migration
maps, and delta pulls carry the epoch so clients fall back to a full
pull and rebuild.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.api.protocol import DeltaPull, ParameterServerProtocol
from repro_torch.core.policies import Decision, SyncPolicy
from repro_torch.core.staleness import StalenessTracker
from repro_torch.kernels.fused_update import fused_update
from repro_torch.obs.trace import TRACE
from repro_torch.optim.compression import Compressor, make_packed_compressor
from repro_torch.perfcount import WIRE
from repro_torch.ps.metrics import RunMetrics
from repro_torch.ps.server import (DEFAULT_COALESCE_WAIT_S, CoalesceWindow,
                                   ServerOptimizer)
from repro_torch.ps.sharded.plan import ShardPlan, build_shard_plan
from repro_torch.wireformat import WIRE_LANES

Params = Any
Grads = Any


class _ShardState:
    """Everything one shard owns.  All mutation under ``self.cond``."""

    def __init__(self, index: int, plan: ShardPlan,
                 pieces: List[torch.Tensor], packed_p: Optional[torch.Tensor],
                 policy: SyncPolicy, optimizer: ServerOptimizer,
                 workers: Sequence[int], apply_mode: str, *,
                 packed_m: Optional[torch.Tensor] = None, version: int = 0):
        self.index = index
        self.plan = plan
        self.cond = threading.Condition()
        self.policy = policy
        self.optimizer = optimizer
        self.tracker = StalenessTracker(workers)
        self.metrics = RunMetrics(policy=f"{policy.name}/shard{index}",
                                  n_workers=len(list(workers)))
        self.version = int(version)
        self.apply_mode = apply_mode
        #: the shard's ``CoalesceWindow`` (fused mode; set by the server)
        self.window: Optional[CoalesceWindow] = None
        #: live-reshard state (``ShardedParameterServer.reshard``): a
        #: retired shard parks incoming applies for replay; an abandoned
        #: shard releases its barrier waiters (its peers now push to the
        #: new shards)
        self.retired = False
        self.abandoned = False
        self.parked: List[Any] = []   # (packed region, staleness) pairs
        if apply_mode == "fused":
            self._packed_p = packed_p
            self._packed_m = (torch.zeros_like(packed_p) if packed_m is None
                              else packed_m)
            # unpacked pieces: a cache rebuilt at most once per version,
            # outside the shard lock (``_shard_snapshot``)
            self._pieces: Optional[List[torch.Tensor]] = None
        else:
            self._pieces = list(pieces)

    def pieces(self) -> List[torch.Tensor]:
        if self._pieces is None:  # fused mode, invalidated by an apply
            self._pieces = self.plan.shard_pieces_from_wire(
                self._packed_p, self.index)
        return self._pieces

    def apply(self, grad_pieces: List[torch.Tensor], staleness: int) -> None:
        """Tree-wire apply: an optimizer step, or pack + fold."""
        if not grad_pieces:           # empty shard: bookkeeping only
            self.version += 1
            return
        if self.apply_mode == "fused":
            self.apply_packed(self.plan.pack_shard_pieces(
                grad_pieces, self.index), staleness)
        else:
            self._pieces = self.optimizer.step(self.pieces(), grad_pieces,
                                               staleness)
            self.version += 1

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
        self._pieces = None
        self.version += 1


class ShardedParameterServer(ParameterServerProtocol):
    """Partitioned weight store + per-shard Algorithm-1 gating."""

    def __init__(self, params: Params, policy_factory: Callable[[], SyncPolicy],
                 optimizer_factory: Callable[[], ServerOptimizer],
                 n_workers: int, n_shards: int, *,
                 split_oversized: bool = True,
                 gating: str = "sharded",
                 apply_mode: str = "fused",
                 compressor: Optional[Compressor] = None,
                 wire_compression: Optional[str] = None,
                 topk_fraction: float = 0.05,
                 coalesce: int = 1,
                 coalesce_wait: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if gating not in ("sharded", "global"):
            raise ValueError(f"unknown gating mode {gating!r}")
        if apply_mode not in ("tree", "fused"):
            raise ValueError(f"unknown apply mode {apply_mode!r}")
        if wire_compression not in (None, "none", "", "int8", "topk"):
            raise ValueError(
                f"unknown wire compression {wire_compression!r}")
        if coalesce < 1:
            raise ValueError(f"coalesce window must be >= 1, got {coalesce}")
        if coalesce > 1 and apply_mode != "fused":
            raise ValueError("coalesce > 1 batches packed applies; it "
                             "requires apply_mode='fused'")
        self.coalesce = coalesce
        self.coalesce_wait = (coalesce_wait if coalesce_wait is not None
                              else (DEFAULT_COALESCE_WAIT_S
                                    if coalesce > 1 else 0.0))
        self.plan: ShardPlan = build_shard_plan(
            params, n_shards, split_oversized=split_oversized)
        self.gating = gating
        self.n_shards = n_shards
        self.apply_mode = apply_mode
        self._split_oversized = split_oversized
        # Kept so a live reshard can mint policies and optimizer state
        # for the new shard set.
        self._policy_factory = policy_factory
        self._optimizer_factory = optimizer_factory
        # Live-reshard state: the epoch counts completed migrations and
        # rides HELLO/SUB/DELTA replies; ``_reshard_cond`` makes
        # ``(plan, shards, n_shards, epoch)`` reads/swaps atomic and
        # tracks in-flight pushes per epoch, so parked regions are
        # replayed only once nothing can still append to them.
        self.reshard_epoch = 0
        self._reshard_lock = threading.Lock()     # one migration at a time
        self._reshard_cond = threading.Condition()
        self._inflight: Dict[int, int] = {}       # epoch -> active pushes
        self._retired_plans: Dict[int, ShardPlan] = {}
        self._migrations: Dict[int, Any] = {}     # epoch e -> map e -> e+1
        workers = range(n_workers)
        if apply_mode == "fused":
            wire = self.plan.pack(params)
            self.device = wire.device
            regions = [self.plan.shard_wire(wire, j).clone()
                       for j in range(n_shards)]
            pieces: List[List[torch.Tensor]] = [[] for _ in regions]
            del wire
        else:
            pieces = self.plan.split(params)
            regions = [None] * n_shards
            self.device = next(p for ps in pieces for p in ps).device
        self.shards: List[_ShardState] = [
            _ShardState(j, self.plan, pieces[j], regions[j],
                        policy_factory(), optimizer_factory(), workers,
                        apply_mode)
            for j in range(n_shards)]
        if apply_mode == "fused":
            for st in self.shards:
                st.window = self._make_window(st)
        if gating == "global":
            self._gate_policy = policy_factory()
            self._gate_tracker = StalenessTracker(workers)
            self._gate_cond = threading.Condition()
        self.metrics = RunMetrics(
            policy=f"{self.shards[0].policy.name} xS{n_shards}[{gating}]",
            n_workers=n_workers)
        self._metrics_lock = threading.Lock()
        self.compressor = (compressor if compressor is not None
                           and compressor.name != "none" else None)
        self._err: Dict[int, List[Any]] = {}   # worker -> per-shard err state
        # Packed-path fused wire compression: per-(worker, shard) f32
        # error-feedback buffers in wire layout, on the server's device.
        self.wire_compression = make_packed_compressor(
            wire_compression, fraction=topk_fraction)
        self._wire_err: Dict[int, Dict[int, torch.Tensor]] = {}
        # Version-keyed packed snapshot cache for ``pull_packed``.
        self._snap_lock = threading.Lock()
        self._snap_key: Optional[tuple] = None
        self._snap_wire: Optional[torch.Tensor] = None
        self._clock = clock
        self._t0 = clock()
        self.stopped = False

    # -- pulls ---------------------------------------------------------------
    def _require_fused(self, what: str) -> None:
        if self.apply_mode != "fused":
            raise ValueError(f"{what} requires apply_mode='fused' (tree "
                             "mode has no resident packed store)")

    def _plan_state(self):
        """Mutually consistent ``(plan, shards, epoch)``: a live reshard
        swaps all three under ``_reshard_cond``."""
        with self._reshard_cond:
            return self.plan, self.shards, self.reshard_epoch

    def _plan_for_epoch(self, epoch: Optional[int]):
        """``(plan, epoch)`` a push was packed against: ``None`` or the
        current epoch -> the live plan; an older epoch -> the retired
        plan kept for translation; an epoch the server never issued
        raises (the client must re-pull, a retryable condition)."""
        with self._reshard_cond:
            cur = self.reshard_epoch
            if epoch is None or int(epoch) == cur:
                return self.plan, cur
            plan = self._retired_plans.get(int(epoch))
        if plan is None:
            raise ValueError(
                f"unknown reshard epoch {epoch} (server at {cur}); "
                "re-pull to resync")
        return plan, int(epoch)

    def _snapshot_refs(self):
        """(plan, per-shard buffers, versions, epoch), each (buffer,
        version) pair grabbed under its own shard lock — buffers are
        never mutated, so a reference is a consistent snapshot."""
        plan, shards, epoch = self._plan_state()
        snaps, versions = [], []
        for st in shards:
            with st.cond:
                snaps.append(st._packed_p)
                versions.append(st.version)
        return plan, snaps, versions, epoch

    def _shard_snapshot(self, st: _ShardState) -> List[torch.Tensor]:
        """One shard's piece list, unpacking OUTSIDE the shard lock and
        installing the cache only if the shard has not moved meanwhile."""
        with st.cond:
            if st._pieces is not None:
                return list(st._pieces)
            packed, version = st._packed_p, st.version
        pieces = st.plan.shard_pieces_from_wire(packed, st.index)
        with st.cond:
            if st.version == version and st._pieces is None:
                st._pieces = list(pieces)
        return pieces

    def pull(self, worker: int) -> Params:
        """The parameter tree, reassembled from per-shard snapshots (each
        consistent under its own lock; cross-shard skew is bounded by
        the gating policies)."""
        t0 = TRACE.now() if TRACE.enabled else 0.0
        plan, shards, _ = self._plan_state()
        params = plan.assemble([self._shard_snapshot(st) for st in shards])
        if TRACE.enabled:
            TRACE.span("pull", t0, worker=worker)
        return params

    def pull_packed(self, worker: int = -1) -> torch.Tensor:
        """Full (total_rows, 512) wire snapshot of the parameters.

        The concatenation happens OUTSIDE every shard lock and is cached
        keyed by the reshard epoch and the shard-version vector, so pulls
        between applies are a dictionary hit.  A slower concurrent pull
        installs its result only if it is of a newer epoch or dominates
        the cached key (component-wise >=, somewhere >), so the cache
        never moves backwards.
        """
        self._require_fused("pull_packed")
        t0 = TRACE.now() if TRACE.enabled else 0.0
        _, snaps, versions, epoch = self._snapshot_refs()
        key = (epoch,) + tuple(versions)
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
            if cached is None or key[0] > cached[0] or (
                    key[0] == cached[0]
                    and all(n >= c for n, c in zip(key[1:], cached[1:]))
                    and any(n > c for n, c in zip(key[1:], cached[1:]))):
                self._snap_key, self._snap_wire = key, wire
        if TRACE.enabled:
            TRACE.span("pull", t0, worker=worker,
                       args={"packed": True, "cached": False})
        return wire

    def pull_packed_shard(self, shard: int, worker: int = -1) -> torch.Tensor:
        """One shard's resident (rows, 512) region (a consistent
        snapshot): the unit per-shard endpoints route on."""
        self._require_fused("pull_packed_shard")
        _, shards, _ = self._plan_state()
        st = shards[shard]
        with st.cond:
            return st._packed_p

    def pull_delta(self, worker: int,
                   versions: Optional[Sequence[int]]) -> DeltaPull:
        """Version-delta pull: ship only the shards that advanced.

        ``versions`` is the vector the worker saw on its last pull; the
        reply carries the regions of shards whose version moved plus the
        fresh vector.  A vector of the wrong arity, or one ahead of the
        server, falls back to a full snapshot (``full=True``) — which is
        also what a client sees after a live reshard: its vector is of
        the old arity, and the full reply (carrying the new epoch) is
        its resync.
        """
        self._require_fused("pull_delta")
        t0 = TRACE.now() if TRACE.enabled else 0.0
        plan, snaps, cur, epoch = self._snapshot_refs()
        n_shards = len(snaps)
        layout = plan.wire_layout()
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
                         regions=regions, full=mismatch, epoch=epoch)

    # -- pushes --------------------------------------------------------------
    def push_packed_shard(self, worker: int, shard: int, buf) -> None:
        """Single-shard packed push: the unit of per-shard endpoint
        routing.  This shard's policy gates the worker on its own, so
        ``gating='global'`` (one decision spanning all shards of one
        logical push) is refused.  Accounting is per shard only."""
        self._require_fused("push_packed_shard")
        if self.gating == "global":
            raise ValueError(
                "per-shard routed pushes require gating='sharded' (the "
                "global gate must see one push spanning all shards)")
        with self._reshard_cond:
            plan, shards, epoch = self.plan, self.shards, self.reshard_epoch
            self._inflight[epoch] = self._inflight.get(epoch, 0) + 1
        try:
            layout = plan.wire_layout()
            if tuple(buf.shape) != (layout.shard_rows[shard], WIRE_LANES):
                raise ValueError(
                    f"shard {shard}: buffer {tuple(buf.shape)} does not "
                    f"match layout ({layout.shard_rows[shard]}, "
                    f"{WIRE_LANES})")
            if self.wire_compression is not None:
                buf = self._compress_packed_one(worker, shard, buf)
            self._push_shard(shards[shard], worker, buf, packed=True)
        finally:
            self._end_push(epoch)

    def push(self, worker: int, grads: Grads) -> None:
        """Tree-wire push: split the gradients by the plan and push shard
        by shard, in the canonical order 0..S-1 (a per-worker rotated
        order deadlocks blocking policies across two shards' barriers).
        Blocks until every shard's policy (or the global gate) has
        released the worker."""
        plan, _, epoch = self._plan_state()
        pieces_per_shard = plan.split(grads)
        if self.compressor is not None:
            pieces_per_shard = self._compress(worker, pieces_per_shard)
        self._push_payloads(worker, pieces_per_shard, packed=False,
                            epoch=epoch)

    def push_packed(self, worker: int, wire, epoch: Optional[int] = None
                    ) -> None:
        """Packed-wire push: the zero-repack hot path.

        ``wire`` is the full (total_rows, 512) buffer or a list of
        per-shard regions.  The server only takes row-range VIEWS, each
        shard folds its region through one ``fused_update`` launch (plus
        one fused-compression launch when ``wire_compression`` is set),
        and nothing keeps a reference to ``wire`` after this call
        returns (the worker reuses the buffer for its next gradient).
        Blocks until the worker is released.

        ``epoch`` is the reshard epoch the pusher packed against
        (transports carry it on the frame).  A stale epoch is validated
        against the RETIRED plan and translated through the migration
        maps, so nothing a lagging client sent is lost.  ``None`` means
        "the layout this buffer matches" — inferred from its row count
        for in-heap callers that hold a plan rather than an epoch.
        """
        self._require_fused("push_packed")
        if epoch is None and not isinstance(wire, (list, tuple)):
            epoch = self._infer_epoch(int(wire.shape[0]))
        plan, epoch = self._plan_for_epoch(epoch)
        layout = plan.wire_layout()
        if isinstance(wire, (list, tuple)):
            shard_bufs = list(wire)
            if len(shard_bufs) != plan.n_shards:
                raise ValueError(f"got {len(shard_bufs)} shard buffers, "
                                 f"plan has {plan.n_shards} shards")
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
            shard_bufs = plan.shard_wires(wire)
        # Stale-epoch pushes skip wire compression: the per-(worker,
        # shard) error-feedback buffers were reset at the swap and are
        # shaped for the NEW plan.
        if self.wire_compression is not None and epoch == self.reshard_epoch:
            shard_bufs = self._compress_packed(worker, shard_bufs)
        self._push_payloads(worker, shard_bufs, packed=True, epoch=epoch)

    def _infer_epoch(self, rows: int) -> Optional[int]:
        """The epoch whose full-buffer row count is ``rows`` — newest
        first, so in-heap callers still holding an old plan keep working
        across a reshard."""
        with self._reshard_cond:
            if self.plan.wire_layout().total_rows == rows:
                return self.reshard_epoch
            for e in sorted(self._retired_plans, reverse=True):
                if self._retired_plans[e].wire_layout().total_rows == rows:
                    return e
            return self.reshard_epoch   # let validation raise with detail

    def _end_push(self, epoch: int) -> None:
        with self._reshard_cond:
            self._inflight[epoch] -= 1
            self._reshard_cond.notify_all()

    def _push_payloads(self, worker: int, payloads: Sequence[Any],
                       packed: bool, epoch: Optional[int] = None) -> None:
        t_push = TRACE.now() if TRACE.enabled else 0.0
        # Atomically: which epoch's shard set this push applies to, and
        # register it in flight — a live reshard replays parked regions
        # only after every push of the old epoch has finished.
        with self._reshard_cond:
            cur = self.reshard_epoch
            shards = self.shards
            self._inflight[cur] = self._inflight.get(cur, 0) + 1
        try:
            if epoch is not None and epoch != cur:
                if not packed:
                    # A tree push that raced the swap: pack each piece
                    # list into its OLD-plan region, then translate.
                    old_plan = self._retired_plans.get(epoch)
                    if old_plan is None:
                        raise ValueError(
                            f"unknown reshard epoch {epoch}; re-pull to "
                            "resync")
                    payloads = [old_plan.pack_shard_pieces(p, j)
                                for j, p in enumerate(payloads)]
                    packed = True
                payloads = self._translate_stale(payloads, epoch, cur)
            now = self._clock() - self._t0
            # Global mode: the gate decides FIRST (monolithic order:
            # decide, apply, then maybe block), and its decision governs
            # every shard's apply.
            gate_dec = gate_stale = None
            if self.gating == "global":
                gate_dec, gate_stale = self._gate_decide(worker)
            max_stale, any_applied, any_credit = 0, False, False
            total_wait = 0.0
            for st, payload in zip(shards, payloads):
                stale, applied, credit, waited = self._push_shard(
                    st, worker, payload, packed, gate_dec, gate_stale)
                max_stale = max(max_stale, stale)
                any_applied = any_applied or applied
                any_credit = any_credit or credit
                total_wait += waited
            if gate_dec is not None:
                total_wait += self._gate_wait(worker, gate_dec)
                max_stale = gate_stale
            with self._metrics_lock:
                self.metrics.record_push(worker, max_stale,
                                         applied=any_applied,
                                         credit=any_credit, time=now)
                if total_wait > 0:
                    self.metrics.record_wait(worker, total_wait)
                clock = self.metrics.pushes.get(worker, -1)
            if TRACE.enabled:
                TRACE.span("push", t_push, worker=worker, clock=clock,
                           args={"staleness": max_stale,
                                 "applied": any_applied,
                                 "credit": any_credit})
        finally:
            self._end_push(cur)

    def _translate_stale(self, payloads: Sequence[torch.Tensor], epoch: int,
                         cur: int) -> List[torch.Tensor]:
        """Re-slice per-shard gradient regions packed under a retired
        plan into the current plan's regions, chaining the retained
        migration maps epoch by epoch (slice copies on the device)."""
        bufs = list(payloads)
        for e in range(epoch, cur):
            mig = self._migrations.get(e)
            if mig is None:
                raise ValueError(
                    f"reshard epoch {epoch} predates the retained "
                    "migration maps; re-pull to resync")
            bufs = mig.migrate_grads(bufs)
        WIRE.reshard_translated += 1
        return bufs

    def _push_shard(self, st: _ShardState, worker: int, payload: Any,
                    packed: bool = True,
                    gate_dec: Optional[Decision] = None,
                    gate_stale: Optional[int] = None):
        j = st.index
        with st.cond:
            now = self._clock() - self._t0
            rec = st.tracker.record_push(worker, now)
            if gate_dec is None:
                dec = st.policy.on_push(st.tracker, worker, now)
                apply_staleness = rec.staleness
            else:
                # Global gating: apply iff the gate said so, with the
                # gate's staleness; the release belongs to the gate.
                dec = Decision(apply_update=gate_dec.apply_update,
                               release_now=True,
                               credit_used=gate_dec.credit_used)
                apply_staleness = gate_stale
            if dec.apply_update:
                t_apply = TRACE.now() if TRACE.enabled else 0.0
                if st.retired:
                    # Mid-migration: the shard's state has been copied
                    # out.  Park the region; the reshard replays it
                    # through the migration map onto the NEW shards —
                    # applied exactly once, never lost.
                    self._park(st, payload, packed, apply_staleness)
                elif self.coalesce > 1:
                    self._apply_coalesced(st, payload, packed,
                                          apply_staleness)
                elif packed:
                    st.apply_packed(payload, apply_staleness)
                else:
                    st.apply(payload, apply_staleness)
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
                # ``st.abandoned``: a live reshard swapped this shard out
                # — peers now push to the NEW shards, so this barrier can
                # never fill; release (the new trackers were equalized).
                while (not self.stopped and not st.abandoned
                       and not st.policy.may_release(st.tracker, worker)):
                    st.cond.wait(timeout=0.5)
                waited = self._clock() - arrival
                rec.waited = waited
                st.metrics.record_wait(worker, waited)
                if TRACE.enabled:
                    TRACE.span("gate_wait", t_wait, worker=worker, shard=j,
                               clock=rec.iteration)
            return rec.staleness, dec.apply_update, dec.credit_used, waited

    # -- coalescing ----------------------------------------------------------
    def _make_window(self, st: _ShardState) -> CoalesceWindow:
        """One ``CoalesceWindow`` per shard (the shard's lock domain):
        ``install`` commits buffers + version together, so a reader
        snapshotting (buffer, version) under ``st.cond`` never sees one
        without the other."""
        def get_pm():
            return st._packed_p, st._packed_m

        def install(p, m, n: int) -> None:
            st._packed_p, st._packed_m = p, m
            st._pieces = None
            st.version += n

        return CoalesceWindow(self, st.cond, st.optimizer, st.tracker,
                              get_pm, install, shard=st.index)

    def _apply_coalesced(self, st: _ShardState, payload: Any,
                         packed: bool, staleness: int) -> None:
        """Route one contribution through the shard's window.  Called
        under ``st.cond``."""
        if not packed:
            if not payload:              # empty shard: bookkeeping only
                st.version += 1
                return
            payload = st.plan.pack_shard_pieces(payload, st.index)
        if payload.shape[0] == 0:        # empty shard region
            st.version += 1
            return
        st.window.submit(payload, st.optimizer.scale(staleness))

    # -- live reshard --------------------------------------------------------
    def _park(self, st: _ShardState, payload: Any, packed: bool,
              staleness: int) -> None:
        """Called under ``st.cond`` on a retired shard: hold the packed
        gradient region for replay onto the new shards.  The retired
        shard's version does NOT move (its buffer does not change), so
        delta pulls stay truthful during the migration window."""
        if not packed:
            if not payload:
                return
            payload = st.plan.pack_shard_pieces(payload, st.index)
        if payload.shape[0] == 0:
            return
        st.parked.append((payload, int(staleness)))
        WIRE.reshard_parked += 1

    def reshard(self, n_shards: int, *, split_oversized: Optional[bool] = None,
                _mid_hook: Optional[Callable[[int], None]] = None) -> bool:
        """Live-migrate the packed store to a new shard count S'.

        Training continues throughout: each old shard is paused only for
        the retire-and-grab under its own lock (traced as
        ``reshard_shard``); pushes racing the migration park and replay
        (``_park``); pulls and gating on not-yet-retired shards go on.
        Returns True if a migration ran; a same-arity call is a no-op.
        ``_mid_hook`` (tests and chaos only) fires after each shard's
        copy-out — ``FaultPlan.kill_mid_reshard`` SIGKILLs the server
        there.
        """
        if self.apply_mode != "fused":
            raise ValueError("live reshard requires apply_mode='fused' "
                             "(the packed store is what migrates)")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        from repro_torch.ft.reshard import (build_migration,
                                            equalized_counts,
                                            spread_versions)
        from repro_torch.ft.snapshot import (capture_policy_state,
                                             restore_policy_state)
        with self._reshard_lock:
            old_plan, old_shards, old_epoch = self._plan_state()
            if n_shards == len(old_shards):
                return False
            t0 = TRACE.now() if TRACE.enabled else 0.0
            new_plan = old_plan.rebuild(
                n_shards,
                split_oversized=(self._split_oversized
                                 if split_oversized is None
                                 else split_oversized))
            mig = build_migration(old_plan, new_plan)
            # Phase 1 — retire + grab, one shard at a time.  Marking the
            # shard retired FIRST means nothing new enters its coalesce
            # window while it drains.  The grab is a reference: no apply
            # writes a buffer in place, so it stays valid, and the lock
            # hold is the shard's whole migration pause.
            copied_p, copied_m, copied_v = [], [], []
            counts_per, credits_per = [], []
            for st in old_shards:
                t_s = TRACE.now() if TRACE.enabled else 0.0
                with st.cond:
                    st.retired = True
                    while (st.window is not None and not self.stopped
                           and (st.window.applying or st.window.pending)):
                        st.cond.wait(timeout=0.1)
                    copied_p.append(st._packed_p)
                    copied_m.append(st._packed_m)
                    copied_v.append(st.version)
                    counts_per.append(dict(st.tracker.counts))
                    credits_per.append(dict(st.tracker.credits))
                if TRACE.enabled:
                    TRACE.span("reshard_shard", t_s, shard=st.index)
                if _mid_hook is not None:
                    _mid_hook(st.index)
            # Phase 2 — fold params + momentum through the migration map
            # (slice copies on the device; bitwise) with no lock held.
            # Versions redistribute sum-preserving; tracker counts and
            # credits equalize to the per-worker minimum across old
            # shards (the failover clamp rule).
            new_p = mig.migrate(copied_p)
            new_m = mig.migrate(copied_m)
            del copied_p, copied_m
            new_versions = spread_versions(sum(copied_v), n_shards)
            eq_counts = equalized_counts(counts_per)
            eq_credits = equalized_counts(credits_per)
            pol_state = capture_policy_state(old_shards[0].policy)
            workers = sorted(eq_counts)
            new_states: List[_ShardState] = []
            for k in range(n_shards):
                policy = self._policy_factory()
                restore_policy_state(policy, pol_state)
                st = _ShardState(k, new_plan, [], new_p[k], policy,
                                 self._optimizer_factory(), workers,
                                 "fused", packed_m=new_m[k],
                                 version=new_versions[k])
                st.tracker.counts.update(eq_counts)
                st.tracker.credits.update(eq_credits)
                st.window = self._make_window(st)
                new_states.append(st)
            # Phase 3 — atomic swap + epoch bump.  The old plan and the
            # map are kept so stale-epoch pushes still translate.
            with self._reshard_cond:
                self.plan = new_plan
                self.shards = new_states
                self.n_shards = n_shards
                self._retired_plans[old_epoch] = old_plan
                self._migrations[old_epoch] = mig
                self.reshard_epoch = old_epoch + 1
                self._reshard_cond.notify_all()
            with self._snap_lock:
                self._snap_key = self._snap_wire = None
            # Error-feedback state is layout-shaped; reset it.
            self._err.clear()
            self._wire_err.clear()
            # Phase 4 — release barrier waiters stranded on old shards.
            for st in old_shards:
                with st.cond:
                    st.abandoned = True
                    st.cond.notify_all()
            # Phase 5 — once no push of the old epoch is in flight (none
            # can append to a parked list any more), replay every parked
            # region onto the new shards.
            with self._reshard_cond:
                while (self._inflight.get(old_epoch, 0) > 0
                       and not self.stopped):
                    self._reshard_cond.wait(timeout=0.5)
                self._inflight.pop(old_epoch, None)
            replayed = 0
            for j, st in enumerate(old_shards):
                with st.cond:
                    parked, st.parked = st.parked, []
                for region, staleness in parked:
                    self._replay_region(mig, j, region, staleness)
                    replayed += 1
            WIRE.reshard_replayed += replayed
            if TRACE.enabled:
                TRACE.span("reshard", t0,
                           args={"from": len(old_shards), "to": n_shards,
                                 "epoch": old_epoch + 1,
                                 "replayed": replayed})
            return True

    def _replay_region(self, mig, old_shard: int, region: torch.Tensor,
                       staleness: int) -> None:
        """Apply one parked old-plan gradient region to the new shards.

        The momentum fold runs ONLY over the moved segments: every other
        element of the destination shards already saw this push's decay
        through its own old shard, so a whole-region ``fused_update``
        would decay those elements twice.  The fold is the reference's
        store-dtype arithmetic (``repro_torch.ft.reshard.replay_fold``),
        on new buffers that replace the shard's under its lock.
        """
        from repro_torch.ft.reshard import replay_fold
        flat = region.reshape(-1)
        by_new: Dict[int, List[Any]] = {}
        for mv in mig.moves_from(old_shard):
            by_new.setdefault(mv.new_shard, []).append(mv)
        _, shards, _ = self._plan_state()
        for k, mvs in by_new.items():
            st = shards[k]
            with st.cond:
                opt = st.optimizer
                p = st._packed_p.reshape(-1).clone()
                m = st._packed_m.reshape(-1).clone()
                for mv in mvs:
                    sl = slice(mv.new_off, mv.new_off + mv.size)
                    p[sl], m[sl] = replay_fold(
                        p[sl], m[sl],
                        flat[mv.old_off:mv.old_off + mv.size].to(p.dtype),
                        opt.lr, opt.momentum, opt.scale(staleness))
                st._packed_p = p.view(-1, WIRE_LANES)
                st._packed_m = m.view(-1, WIRE_LANES)
                st._pieces = None
                # The buffer changed, so the version MUST move (delta
                # pulls diff on it): one bump per replayed contribution
                # per touched shard.
                st.version += 1
                st.cond.notify_all()

    # -- global gate ---------------------------------------------------------
    def _gate_decide(self, worker: int):
        """Global-gate bookkeeping + decision (no blocking yet)."""
        with self._gate_cond:
            now = self._clock() - self._t0
            rec = self._gate_tracker.record_push(worker, now)
            dec = self._gate_policy.on_push(self._gate_tracker, worker, now)
            self._gate_cond.notify_all()
            return dec, rec.staleness

    def _gate_wait(self, worker: int, dec: Decision) -> float:
        if dec.release_now:
            return 0.0
        t_wait = TRACE.now() if TRACE.enabled else 0.0
        with self._gate_cond:
            arrival = self._clock()
            while (not self.stopped
                   and not self._gate_policy.may_release(
                       self._gate_tracker, worker)):
                self._gate_cond.wait(timeout=0.5)
            waited = self._clock() - arrival
        if TRACE.enabled:
            TRACE.span("gate_wait", t_wait, worker=worker)
        return waited

    # -- compression ---------------------------------------------------------
    def _compress(self, worker: int,
                  pieces_per_shard: List[List[torch.Tensor]]):
        err = self._err.get(worker)
        if err is None:
            err = [self.compressor.init_error(p) for p in pieces_per_shard]
        out = []
        for j, pieces in enumerate(pieces_per_shard):
            compressed, err[j] = self.compressor.apply(pieces, err[j])
            out.append(compressed)
        self._err[worker] = err
        return out

    def _compress_packed(self, worker: int,
                         shard_bufs: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """Fused wire compression: ONE kernel launch per non-empty
        shard, with per-(worker, shard) f32 error buffers."""
        return [self._compress_packed_one(worker, j, buf)
                for j, buf in enumerate(shard_bufs)]

    def _compress_packed_one(self, worker: int, shard: int,
                             buf: torch.Tensor) -> torch.Tensor:
        if buf.shape[0] == 0:
            return buf
        state = self._wire_err.setdefault(worker, {})
        err = state.get(shard)
        if err is None:
            err = torch.zeros(buf.shape, dtype=torch.float32,
                              device=buf.device)
        buf, err = self.wire_compression.apply(buf, err)
        state[shard] = err
        return buf

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
        if self.gating == "global":
            with self._gate_cond:
                self._gate_tracker.add_worker(worker)
                self._gate_cond.notify_all()
        with self._metrics_lock:
            self.metrics.n_workers = len(self.shards[0].tracker.workers)
        self._err.pop(worker, None)
        self._wire_err.pop(worker, None)

    def remove_worker(self, worker: int) -> None:
        """Departure must not stall ANY shard's barrier: drop the worker
        from every shard tracker (and the global gate), waking waiters
        and lingering flushers; its error-feedback state goes too."""
        for st in self.shards:
            with st.cond:
                st.tracker.remove_worker(worker)
                st.metrics.n_workers = len(st.tracker.workers)
                st.cond.notify_all()
        if self.gating == "global":
            with self._gate_cond:
                self._gate_tracker.remove_worker(worker)
                self._gate_cond.notify_all()
        with self._metrics_lock:
            self.metrics.n_workers = len(self.shards[0].tracker.workers)
        self._err.pop(worker, None)
        self._wire_err.pop(worker, None)

    def stop(self) -> None:
        self.stopped = True
        for st in self.shards:
            with st.cond:
                st.cond.notify_all()
        if self.gating == "global":
            with self._gate_cond:
                self._gate_cond.notify_all()

    # -- inspection ----------------------------------------------------------
    @property
    def version(self) -> int:
        """Total applied shard-updates."""
        return sum(st.version for st in self.shards)

    def shard_versions(self) -> List[int]:
        return [st.version for st in self.shards]

    def staleness_profile(self) -> Dict[int, Dict[int, int]]:
        """shard -> worker -> current gap."""
        out = {}
        for st in self.shards:
            with st.cond:
                out[st.index] = st.tracker.staleness_profile()
        return out
