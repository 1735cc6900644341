"""Server snapshots: capture / restore the whole packed-store state.

Counterpart of ``repro/ft/snapshot.py``: the same tree (``shard000``:
``{"p", "m"}`` per shard) and the same extras, so a snapshot either
package takes restores in the other (through ``CheckpointManager``'s
shared disk format).

A snapshot is everything a restarted server needs to carry on mid-run:

  * the resident packed per-shard parameter + momentum buffers
    (``apply_mode='fused'`` on the sharded server, ``'packed'`` on the
    monolithic one — tree mode has no resident store and is rejected),
  * the per-shard version vector (what version-delta pulls diff
    against: a restored server resumes *behind* any worker's last-seen
    vector, so the component-wise dominance rule in ``pull_delta``
    makes every reconnecting worker fall back to a full resync
    automatically),
  * per-shard ``StalenessTracker`` tables (iteration counts, table A,
    DSSP credits) and sync-policy state (DSSP credit counters +
    Algorithm-2 interval-estimator history; backup-BSP round state),
  * the aggregate ``RunMetrics`` (loss trajectory included), so the
    convergence curve survives the failover.

Capture is **per shard, under that shard's existing lock** — the pause
a snapshot imposes on any one push is one buffer-reference grab plus a
tracker/policy dict copy, emitted as a ``snapshot_shard`` obs span.
The grab is enough because no apply writes a shard's buffers in place:
``fused_update`` and the coalesced flush return new tensors, the replay
fold builds new ones, and the old buffers stay as they were for whoever
holds them.  There is no global pause: the device-to-host copy happens
outside every lock, in ``CheckpointManager.save`` on the snapshotting
thread (on the same stream as the kernels that produced the buffers, so
after them), and the disk write in its writer thread.

``ServerSnapshotter`` is the periodic driver; ``restore_latest`` is
the failover entry point (emits a ``failover`` span).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.trace import TRACE

SNAPSHOT_VERSION = 1


# ===================================================================
# tracker / policy / metrics state (plain dicts, JSON-able)
# ===================================================================
def _tracker_state(tr) -> Dict[str, Any]:
    return {
        "workers": [int(w) for w in tr.workers],
        "counts": {str(w): int(c) for w, c in tr.counts.items()},
        "table": {str(w): [float(a), float(b)]
                  for w, (a, b) in tr.table.items()},
        "credits": {str(w): int(c) for w, c in tr.credits.items()},
    }


def _restore_tracker(tr, state: Dict[str, Any]) -> None:
    import math
    tr.workers = [int(w) for w in state["workers"]]
    tr.counts = {int(w): int(c) for w, c in state["counts"].items()}
    # Table A is NOT restored: its timestamps are clock readings of the
    # DEAD process (relative to its private t0), so diffing them against
    # the new process's clock would feed the Algorithm-2 estimator
    # negative/garbage intervals.  NaNs put the controller on its
    # documented cold-start path (no credit until two fresh pushes).
    tr.table = {int(w): (math.nan, math.nan) for w in state["table"]}
    tr.credits = {int(w): int(c) for w, c in state["credits"].items()}
    tr.history = []  # per-push records are metrics, not resume state


def capture_policy_state(policy) -> Dict[str, Any]:
    """Duck-typed policy state export.  SSP/ASP/BSP gate off the
    tracker alone; DSSP adds credit counters + the Algorithm-2
    estimator history; backup-BSP adds its round bookkeeping."""
    state: Dict[str, Any] = {"class": type(policy).__name__}
    if hasattr(policy, "credits_granted"):           # DSSP
        est = policy.controller.estimator
        state["credits_granted"] = int(policy.credits_granted)
        state["credits_spent"] = int(policy.credits_spent)
        state["estimator"] = {
            "hist": {str(w): [float(x) for x in dq]
                     for w, dq in est._hist.items()},
            "ema": {str(w): float(v) for w, v in est._ema.items()},
        }
    if hasattr(policy, "worker_round"):              # BackupWorkersBSP
        state["round"] = int(policy.round)
        state["applied_this_round"] = int(policy.applied_this_round)
        state["worker_round"] = {str(w): int(r)
                                 for w, r in policy.worker_round.items()}
        state["dropped"] = int(policy.dropped)
    return state


def restore_policy_state(policy, state: Dict[str, Any]) -> None:
    if hasattr(policy, "credits_granted") and "credits_granted" in state:
        policy.credits_granted = int(state["credits_granted"])
        policy.credits_spent = int(state["credits_spent"])
        est = policy.controller.estimator
        for w, xs in state.get("estimator", {}).get("hist", {}).items():
            for x in xs:
                est._hist[int(w)].append(float(x))
        est._ema.update({int(w): float(v) for w, v in
                         state.get("estimator", {}).get("ema", {}).items()})
    if hasattr(policy, "worker_round") and "worker_round" in state:
        policy.round = int(state["round"])
        policy.applied_this_round = int(state["applied_this_round"])
        policy.worker_round = {int(w): int(r)
                               for w, r in state["worker_round"].items()}
        policy.dropped = int(state["dropped"])


def _metrics_state(m) -> Dict[str, Any]:
    return {
        "total_pushes": m.total_pushes,
        "applied_updates": m.applied_updates,
        "dropped_updates": m.dropped_updates,
        "credit_releases": m.credit_releases,
        "total_time": m.total_time,
        "staleness_hist": {str(s): c for s, c in m.staleness_hist.items()},
        "pushes": {str(w): c for w, c in m.pushes.items()},
        "wait_time": {str(w): t for w, t in m.wait_time.items()},
        "loss_trajectory": [[t, s, loss]
                            for t, s, loss in m.loss_trajectory],
        "update_trajectory": [[t, u] for t, u in m.update_trajectory],
    }


def _restore_metrics(m, state: Dict[str, Any]) -> None:
    m.total_pushes = int(state["total_pushes"])
    m.applied_updates = int(state["applied_updates"])
    m.dropped_updates = int(state["dropped_updates"])
    m.credit_releases = int(state["credit_releases"])
    m.total_time = float(state["total_time"])
    m.staleness_hist = {int(s): int(c)
                        for s, c in state["staleness_hist"].items()}
    m.pushes = {int(w): int(c) for w, c in state["pushes"].items()}
    m.wait_time = {int(w): float(t)
                   for w, t in state["wait_time"].items()}
    m.loss_trajectory = [(float(t), int(s), float(loss))
                         for t, s, loss in state["loss_trajectory"]]
    m.update_trajectory = [(float(t), int(u))
                           for t, u in state["update_trajectory"]]


# ===================================================================
# capture
# ===================================================================
def _require_packed(server) -> None:
    if not getattr(server, "packed_wire", False):
        raise ValueError(
            "server snapshots capture the resident packed store; "
            f"apply_mode={getattr(server, 'apply_mode', None)!r} has "
            "none (use ps.apply='fused' or 'packed')")


def snapshot_server(server) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Capture ``(tree, extras)``: the array tree for the
    ``CheckpointManager`` plus the JSON-able bookkeeping.

    Per-shard state is grabbed under that shard's own lock — applies
    never write a buffer in place, so a reference IS a consistent
    snapshot and the pause per shard is bounded by a dict copy, never
    by serialization.  Shards mutated between grabs may differ in
    version: exactly the per-shard consistency the partitioned server
    offers its own pulls.
    """
    _require_packed(server)
    t0 = TRACE.now() if TRACE.enabled else 0.0
    for _attempt in range(8):
        out = _snapshot_once(server)
        if out is not None:
            tree, extras = out
            break
    else:  # pragma: no cover - needs 8 reshards racing one capture
        raise RuntimeError("snapshot raced a live reshard 8 times")
    if TRACE.enabled:
        TRACE.span("snapshot", t0,
                   args={"shards": extras["n_shards"],
                         "version": sum(extras["versions"])})
    return tree, extras


def _snapshot_once(server):
    """One capture attempt; ``None`` when a live reshard swapped the
    shard list mid-capture (the caller retries — mixing regions from
    two plans in one snapshot would be a torn, unrestorable state)."""
    epoch0 = int(getattr(server, "reshard_epoch", 0))
    tree: Dict[str, Any] = {}
    versions: List[int] = []
    shard_states: List[Dict[str, Any]] = []
    shards = getattr(server, "shards", None)
    if shards is not None:                       # ShardedParameterServer
        kind = "sharded"
        for st in shards:
            with st.cond:
                # Span starts AFTER acquisition: it measures the lock
                # HOLD (the pause imposed on that shard's pushes), not
                # time spent queueing behind an in-flight apply.
                ts = TRACE.now() if TRACE.enabled else 0.0
                p, m = st._packed_p, st._packed_m
                version = st.version
                trk = _tracker_state(st.tracker)
                pol = capture_policy_state(st.policy)
            if TRACE.enabled:
                TRACE.span("snapshot_shard", ts, shard=st.index)
            tree[f"shard{st.index:03d}"] = {"p": p, "m": m}
            versions.append(version)
            shard_states.append({"tracker": trk, "policy": pol})
        gate = None
        if server.gating == "global":
            with server._gate_cond:
                gate = {"tracker": _tracker_state(server._gate_tracker),
                        "policy": capture_policy_state(server._gate_policy)}
        with server._metrics_lock:
            metrics = _metrics_state(server.metrics)
        gating = server.gating
    else:                                        # mono ParameterServer
        kind = "mono"
        with server._cond:
            ts = TRACE.now() if TRACE.enabled else 0.0
            p, m = server._wire_p, server._wire_m
            versions.append(server.version)
            shard_states.append(
                {"tracker": _tracker_state(server.tracker),
                 "policy": capture_policy_state(server.policy)})
            metrics = _metrics_state(server.metrics)
        if TRACE.enabled:
            TRACE.span("snapshot_shard", ts, shard=0)
        tree["shard000"] = {"p": p, "m": m}
        gate, gating = None, "mono"
    if int(getattr(server, "reshard_epoch", 0)) != epoch0:
        return None  # a reshard swapped plans mid-capture: retry
    opt = (shards[0].optimizer if shards is not None
           else server.optimizer)
    extras = {
        "snapshot_version": SNAPSHOT_VERSION,
        "kind": kind,
        "gating": gating,
        "n_shards": len(versions),
        "versions": versions,
        "shards": shard_states,
        "gate": gate,
        "optimizer": {"lr": opt.lr, "momentum": opt.momentum,
                      "staleness_damping": bool(opt.staleness_damping)},
        "metrics": metrics,
        # The live-reshard epoch these regions were laid out under —
        # restore uses it (with n_shards) to decide whether the target
        # server must be resharded before the install.
        "reshard_epoch": epoch0,
    }
    return tree, extras


# ===================================================================
# restore
# ===================================================================
def _equalize_counts(shards) -> None:
    """Clamp every worker's iteration count to its cross-shard minimum.

    The snapshot grabs each shard's tracker under its OWN lock, so a
    push in flight at capture time is recorded on the shards it already
    visited but not the rest.  Left as-is, that skew breaks the
    invariant the gating deadlock-freedom argument rests on (a worker's
    counts at shards 0..S-1 differ by at most its one in-flight push,
    always in canonical order): after the worker retries the
    interrupted push, its early-shard counts run TWO ahead of its
    late-shard counts, and two blocked workers can then wait on each
    other across different shards' barriers — a circular wait observed
    as the post-failover DSSP hang.  Clamping to the minimum re-enters
    the canonical-order regime (the retried push re-records uniformly);
    the discarded surplus is exactly the interrupted push the worker is
    about to re-send.
    """
    floor: Dict[int, int] = {}
    for st in shards:
        with st.cond:
            for w, c in st.tracker.counts.items():
                floor[w] = min(floor.get(w, c), c)
    for st in shards:
        with st.cond:
            for w in st.tracker.counts:
                st.tracker.counts[w] = floor[w]
            st.cond.notify_all()


def _on_device(t, device):
    """A restored leaf as a buffer of the server's own (a fresh copy,
    never a view of the loaded array)."""
    import torch
    return torch.as_tensor(t).to(device, copy=True)


def restore_server(server, tree: Dict[str, Any],
                   extras: Dict[str, Any]) -> None:
    """Install a captured snapshot into a freshly-built server of the
    same spec.  Per-shard installs run under each shard's lock and
    notify waiters; caches keyed by version (packed-snapshot cache,
    unpacked-piece cache) are invalidated."""
    _require_packed(server)
    ver = extras.get("snapshot_version")
    if ver != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {ver!r} != supported "
                         f"{SNAPSHOT_VERSION}")
    shards = getattr(server, "shards", None)
    n = len(shards) if shards is not None else 1
    if extras["n_shards"] != n:
        # Cross-plan restore: the snapshot was taken under a different
        # shard arity (a live reshard ran before — or after — the
        # capture).  A resharding-capable server is moved to the
        # snapshot's arity FIRST (which also installs the migration
        # map old->new, so stale-epoch client pushes keep translating);
        # then the install below proceeds shard-for-shard.
        if shards is None or not hasattr(server, "reshard"):
            raise ValueError(
                f"snapshot has {extras['n_shards']} shard(s), server "
                f"has {n} and cannot reshard — restore needs the same "
                "RunSpec the snapshot came from")
        server.reshard(extras["n_shards"])
        shards = server.shards
        n = len(shards)
    versions = [int(v) for v in extras["versions"]]
    states = extras["shards"]
    if shards is not None:
        if extras["kind"] != "sharded":
            raise ValueError(f"snapshot kind {extras['kind']!r} cannot "
                             "restore into a sharded server")
        for st in shards:
            blob = tree[f"shard{st.index:03d}"]
            with st.cond:
                st._packed_p = _on_device(blob["p"], server.device)
                st._packed_m = _on_device(blob["m"], server.device)
                st._pieces = None
                st.version = versions[st.index]
                _restore_tracker(st.tracker, states[st.index]["tracker"])
                restore_policy_state(st.policy,
                                     states[st.index]["policy"])
                st.metrics.n_workers = len(st.tracker.workers)
                st.cond.notify_all()
        _equalize_counts(shards)
        if extras.get("gate") and server.gating == "global":
            with server._gate_cond:
                _restore_tracker(server._gate_tracker,
                                 extras["gate"]["tracker"])
                restore_policy_state(server._gate_policy,
                                     extras["gate"]["policy"])
                server._gate_cond.notify_all()
        with server._snap_lock:
            server._snap_key = server._snap_wire = None
        with server._metrics_lock:
            _restore_metrics(server.metrics, extras["metrics"])
            server.metrics.n_workers = len(shards[0].tracker.workers)
    else:
        if extras["kind"] != "mono":
            raise ValueError(f"snapshot kind {extras['kind']!r} cannot "
                             "restore into a monolithic server")
        blob = tree["shard000"]
        with server._cond:
            server._wire_p = _on_device(blob["p"], server.device)
            server._wire_m = _on_device(blob["m"], server.device)
            server._params = None
            server.version = versions[0]
            _restore_tracker(server.tracker, states[0]["tracker"])
            restore_policy_state(server.policy, states[0]["policy"])
            _restore_metrics(server.metrics, extras["metrics"])
            server.metrics.n_workers = len(server.tracker.workers)
            server._cond.notify_all()


def restore_latest(server, manager) -> Optional[int]:
    """Failover entry point: restore the newest usable snapshot from
    ``manager`` into ``server``.  Returns the snapshot step, or
    ``None`` when the directory holds no (complete) snapshot.

    Cross-plan aware: when the snapshot was captured at a different
    shard arity (it straddles a live reshard), a resharding-capable
    server is moved to the snapshot's arity BEFORE the template tree is
    built, so the shape validation in ``CheckpointManager.restore``
    sees matching region buffers.  The run then resumes under exactly
    the plan the snapshot recorded — never a torn mixture."""
    t0 = TRACE.now() if TRACE.enabled else 0.0
    step = manager.latest_step()
    if step is None:
        return None
    peek = manager.peek_extras(step)
    want = int(peek.get("n_shards", 0))
    shards = getattr(server, "shards", None)
    if (shards is not None and want and want != len(shards)
            and hasattr(server, "reshard")):
        server.reshard(want)
    like, _ = snapshot_server(server)
    tree, extras = manager.restore(step, like)
    restore_server(server, tree, extras)
    if TRACE.enabled:
        TRACE.span("failover", t0,
                   args={"step": step,
                         "versions": [int(v)
                                      for v in extras["versions"]]})
    return step


# ===================================================================
# periodic driver
# ===================================================================
class ServerSnapshotter:
    """Daemon thread checkpointing ``server`` every ``every_s`` seconds
    (skipping intervals where no shard version moved).  ``save_now``
    is the synchronous path tests and final-save hooks use; a failed
    save is re-raised on ``stop()`` so sessions surface it."""

    def __init__(self, server, manager, every_s: float):
        if every_s <= 0:
            raise ValueError("snapshot interval must be positive")
        self.server = server
        self.manager = manager
        self.every_s = float(every_s)
        self.snapshots = 0
        self.failure: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="ft-snapshotter", daemon=True)
        self._last_version = -1
        self._save_lock = threading.Lock()
        #: (seconds, bytes) of every committed write
        self.writes: List[Tuple[float, int]] = []
        if manager.on_write is None:
            manager.on_write = self._on_write

    def _on_write(self, step: int, t0: float, nbytes: int) -> None:
        self.writes.append((time.perf_counter() - t0, nbytes))
        if TRACE.enabled:
            TRACE.span("snapshot_write", t0,
                       args={"step": int(step), "bytes": int(nbytes)})

    def start(self) -> "ServerSnapshotter":
        self._thread.start()
        return self

    def save_now(self) -> bool:
        """One snapshot, skipped (False) when nothing changed since the
        last one."""
        with self._save_lock:   # the periodic thread and a caller's own
            version = int(self.server.version)
            if version == self._last_version:
                return False
            tree, extras = snapshot_server(self.server)
            self.manager.save(version, tree, extras)
            self._last_version = version
            self.snapshots += 1
            return True

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.save_now()
            except BaseException as e:
                self.failure = e
                return

    def stop(self, *, final_save: bool = True,
             timeout: float = 30.0) -> None:
        """Stop the thread, optionally take one last snapshot, flush
        the manager's writer, and re-raise any deferred failure."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self.failure is not None:
            raise self.failure
        if final_save:
            self.save_now()
        self.manager.wait()


__all__ = ["SNAPSHOT_VERSION", "snapshot_server", "restore_server",
           "restore_latest", "ServerSnapshotter",
           "capture_policy_state", "restore_policy_state"]
