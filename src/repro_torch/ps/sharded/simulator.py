"""Sharded extension of the discrete-event PS simulator.

``PSSimulator`` models one server; here every worker iteration fans out
into **per-shard service events**: after computing for
``interval_fn(w, k)`` virtual seconds, worker ``w`` visits shards
0..S-1 in order, paying ``shard_service_fn(shard, w)`` service time per
visit (default 0 — pure gating study), and each shard gates the visit
with its OWN stateful policy instance over its OWN
``StalenessTracker``.  The worker starts its next compute interval only
once the LAST shard has released it.

All workers visit shards in the SAME canonical order — with blocking
policies a rotated/random order deadlocks (worker A blocked at shard 0's
barrier while worker B, whose push would release it, is blocked at
shard 1's, circularly).  A total order over shards makes the wait-for
graph acyclic; pushes to distinct shards still overlap in pipeline
fashion.

This turns the paper's Table-I throughput/wait comparisons into a
function of shard count: at S=1 it degenerates to ``PSSimulator``
(identical event order ⇒ identical metrics), at S>1 it answers the
questions the monolithic paper setup could not pose — does per-shard
DSSP keep every shard's staleness within bound?  how much waiting does
skewed shard load (hot shards via ``shard_service_fn``) add per policy?

Metrics: one aggregate ``RunMetrics`` over worker iterations (a "push"
= one completed fan-out; staleness = the max across shards seen that
iteration) plus one per-shard ``RunMetrics`` with exact per-shard
staleness/wait accounting.

Counterpart of ``repro/ps/sharded/simulator.py`` over the port's
gates, trackers and ``RunMetrics``.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policies import SyncPolicy
from repro_torch.core.staleness import StalenessTracker
from repro_torch.ps.metrics import RunMetrics
from repro_torch.ps.simulator import IntervalFn, constant_intervals

ShardServiceFn = Callable[[int, int], float]  # (shard, worker) -> seconds


class _SimShard:
    def __init__(self, index: int, policy: SyncPolicy, n_workers: int):
        self.index = index
        self.policy = policy
        self.tracker = StalenessTracker(range(n_workers))
        self.metrics = RunMetrics(policy=f"{policy.name}/shard{index}",
                                  n_workers=n_workers)
        self.blocked: Dict[int, float] = {}   # worker -> arrival time


class _WorkerState:
    __slots__ = ("k", "order", "pos", "wait", "stale", "applied", "credit")

    def __init__(self, order: List[int]):
        self.k = 0            # completed compute iterations
        self.order = order    # canonical shard visit order (see module doc)
        self.pos = 0          # index into order for the current fan-out
        self.wait = 0.0       # wait accumulated this fan-out
        self.stale = 0        # max per-shard staleness this fan-out
        self.applied = False
        self.credit = False


class ShardedPSSimulator:
    """Event-driven sharded PS cluster; per-shard gating in virtual time."""

    def __init__(self, policy_factory: Callable[[], SyncPolicy],
                 n_workers: int, n_shards: int, interval_fn: IntervalFn, *,
                 shard_service_fn: Optional[ShardServiceFn] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n = n_workers
        self.s = n_shards
        self.interval_fn = interval_fn
        self.service_fn = shard_service_fn or (lambda shard, worker: 0.0)
        self.shards = [_SimShard(j, policy_factory(), n_workers)
                       for j in range(n_shards)]
        self.metrics = RunMetrics(
            policy=f"{self.shards[0].policy.name} xS{n_shards}",
            n_workers=n_workers)
        self._events: List[Tuple[float, int, int]] = []  # (time, seq, worker)
        self._seq = itertools.count()
        self._workers = [_WorkerState(list(range(n_shards)))
                         for _ in range(n_workers)]
        self.now = 0.0

    # -- scheduling ----------------------------------------------------------
    def _schedule_compute(self, worker: int, at: float) -> None:
        ws = self._workers[worker]
        k = ws.k
        ws.k += 1
        ws.pos = 0
        ws.wait = 0.0
        ws.stale = 0
        ws.applied = False
        ws.credit = False
        first = ws.order[0]
        push_at = (at + self.interval_fn(worker, k)
                   + self.service_fn(first, worker))
        heapq.heappush(self._events, (push_at, next(self._seq), worker))

    def _advance(self, worker: int, at: float, waited: float) -> None:
        """Worker released from its current shard: go to the next shard,
        or finish the fan-out and start the next compute interval."""
        ws = self._workers[worker]
        ws.wait += waited
        ws.pos += 1
        if ws.pos < self.s:
            nxt = ws.order[ws.pos]
            heapq.heappush(self._events,
                           (at + self.service_fn(nxt, worker),
                            next(self._seq), worker))
        else:
            if ws.wait > 0:
                self.metrics.record_wait(worker, ws.wait)
            self._schedule_compute(worker, at)

    # -- main loop -------------------------------------------------------------
    def run(self, max_pushes: Optional[int] = None,
            max_time: Optional[float] = None) -> RunMetrics:
        """``max_pushes`` counts completed worker fan-outs (one per
        compute iteration — comparable to ``PSSimulator`` pushes)."""
        if max_pushes is None and max_time is None:
            raise ValueError("need a stopping condition")
        for w in range(self.n):
            self._schedule_compute(w, 0.0)

        while self._events:
            t, _, w = heapq.heappop(self._events)
            if max_time is not None and t > max_time:
                break
            self.now = t
            ws = self._workers[w]
            shard = self.shards[ws.order[ws.pos]]
            rec = shard.tracker.record_push(w, t)
            dec = shard.policy.on_push(shard.tracker, w, t)
            shard.metrics.record_push(w, rec.staleness,
                                      applied=dec.apply_update,
                                      credit=dec.credit_used, time=t)
            ws.stale = max(ws.stale, rec.staleness)
            ws.applied = ws.applied or dec.apply_update
            ws.credit = ws.credit or dec.credit_used
            if ws.pos == self.s - 1:
                # All shards have seen this fan-out: record the aggregate
                # push at ARRIVAL (matching PSSimulator's timing — a
                # blocked worker's push still counts before its wait).
                self.metrics.record_push(w, ws.stale, applied=ws.applied,
                                         credit=ws.credit, time=t)
            if dec.release_now:
                self._advance(w, t, 0.0)
            else:
                shard.blocked[w] = t
            self._drain(shard, t)
            if (max_pushes is not None
                    and self.metrics.total_pushes >= max_pushes):
                break

        # Tail waits of workers still blocked in some shard.
        for shard in self.shards:
            for w, arrival in shard.blocked.items():
                waited = max(0.0, self.now - arrival)
                shard.metrics.record_wait(w, waited)
                self.metrics.record_wait(w, waited)
            shard.blocked.clear()
        return self.metrics

    def _drain(self, shard: _SimShard, t: float) -> None:
        progressed = True
        while progressed:
            progressed = False
            for w in sorted(shard.blocked):
                if shard.policy.may_release(shard.tracker, w):
                    arrival = shard.blocked.pop(w)
                    waited = t - arrival
                    if waited > 0:
                        shard.metrics.record_wait(w, waited)
                    self._advance(w, t, waited)
                    progressed = True

    # -- inspection ------------------------------------------------------------
    def shard_metrics(self) -> List[RunMetrics]:
        return [s.metrics for s in self.shards]

    def max_staleness_per_shard(self) -> List[int]:
        return [s.metrics.max_staleness for s in self.shards]


def run_sharded_policy(policy_factory: Callable[[], SyncPolicy],
                       intervals: Sequence[float], n_shards: int, *,
                       max_pushes: int = 2000,
                       shard_service_fn: Optional[ShardServiceFn] = None,
                       ) -> ShardedPSSimulator:
    """Convenience wrapper mirroring ``repro.ps.simulator.run_policy`` —
    returns the simulator (aggregate in ``.metrics``, per-shard via
    ``.shard_metrics()``)."""
    sim = ShardedPSSimulator(policy_factory, len(intervals), n_shards,
                             constant_intervals(intervals),
                             shard_service_fn=shard_service_fn)
    sim.run(max_pushes=max_pushes)
    return sim


def hot_shard_service(hot_shard: int, hot_seconds: float,
                      base_seconds: float = 0.0) -> ShardServiceFn:
    """Skewed shard load: one shard is slower to service (hot key range /
    oversized embedding slice) — a scenario the monolithic paper setup
    cannot express."""
    def fn(shard: int, worker: int) -> float:
        return hot_seconds if shard == hot_shard else base_seconds

    return fn
