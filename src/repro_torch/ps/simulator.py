"""Discrete-event simulator of the parameter-server cluster.

Deterministic virtual-time execution of any ``SyncPolicy`` over a set of
workers with configurable (possibly heterogeneous and time-varying)
iteration intervals.  This is the instrument for the paper's *systems*
claims — waiting time, iteration throughput, staleness bounds — decoupled
from SGD noise:

  * Figure 2's geometry (where should the fastest worker stop?) becomes an
    executable experiment,
  * Table I's ordering (DSSP ≈ ASP ≫ SSP ≫ BSP in heterogeneous clusters)
    is reproduced in virtual time,
  * property tests drive thousands of random speed profiles through every
    policy and assert the invariants (staleness ≤ bound, BSP lockstep,
    DSSP wait ≤ SSP(s_L) wait, ...).

Worker model: worker ``i`` becomes ready to push ``interval_fn(i, k)``
seconds after its k-th release.  The interval covers compute + comms,
matching the paper's definition of *iteration interval* ("time period
between two consecutive updates the server receives from the worker").

Counterpart of ``repro/ps/simulator.py`` over the port's gates, trackers
and ``RunMetrics``: the same event order, so the same decision stream
and metrics.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policies import SyncPolicy
from repro_torch.core.staleness import StalenessTracker
from repro_torch.ps.metrics import RunMetrics

IntervalFn = Callable[[int, int], float]  # (worker, iteration_idx) -> seconds


def constant_intervals(values: Sequence[float]) -> IntervalFn:
    """Homogeneous-per-worker intervals (value per worker)."""
    vals = list(values)

    def fn(worker: int, k: int) -> float:
        return vals[worker]

    return fn


def jittered_intervals(values: Sequence[float], jitter: float,
                       seed: int = 0) -> IntervalFn:
    """Per-worker base interval with multiplicative uniform jitter.

    Deterministic: uses a counter-based hash so (worker, k) always maps to
    the same draw regardless of event order.
    """
    vals = list(values)

    def fn(worker: int, k: int) -> float:
        h = (worker * 1_000_003 + k * 7_919 + seed * 104_729) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h ^= h >> 16
        u = h / 0xFFFFFFFF  # [0, 1]
        return vals[worker] * (1.0 + jitter * (2.0 * u - 1.0))

    return fn


def phase_shift_intervals(base: Sequence[float], slow_after: int,
                          factor: float, worker: int = 0) -> IntervalFn:
    """One worker degrades by ``factor`` after ``slow_after`` iterations —
    models the paper's 'unstable environment' future-work scenario and
    exercises the controller's adaptivity."""
    vals = list(base)

    def fn(w: int, k: int) -> float:
        v = vals[w]
        if w == worker and k >= slow_after:
            v *= factor
        return v

    return fn


class PSSimulator:
    """Event-driven PS cluster under a synchronization policy."""

    def __init__(self, policy: SyncPolicy, n_workers: int,
                 interval_fn: IntervalFn):
        self.policy = policy
        self.n = n_workers
        self.interval_fn = interval_fn
        self.tracker = StalenessTracker(range(n_workers))
        self.metrics = RunMetrics(policy=policy.name, n_workers=n_workers)
        self._events: List[Tuple[float, int, int]] = []  # (time, seq, worker)
        self._seq = itertools.count()
        self._blocked: Dict[int, float] = {}  # worker -> arrival time
        self._iters: Dict[int, int] = {w: 0 for w in range(n_workers)}
        self.now = 0.0

    # -- scheduling --------------------------------------------------------
    def _schedule_next(self, worker: int, at: float) -> None:
        k = self._iters[worker]
        self._iters[worker] += 1
        push_at = at + self.interval_fn(worker, k)
        heapq.heappush(self._events, (push_at, next(self._seq), worker))

    def _release(self, worker: int, at: float, waited: float) -> None:
        if waited > 0:
            self.metrics.record_wait(worker, waited)
        self._schedule_next(worker, at)

    # -- main loop ------------------------------------------------------------
    def run(self, max_pushes: Optional[int] = None,
            max_time: Optional[float] = None) -> RunMetrics:
        if max_pushes is None and max_time is None:
            raise ValueError("need a stopping condition")
        for w in range(self.n):
            self._schedule_next(w, 0.0)

        while self._events:
            t, _, w = heapq.heappop(self._events)
            if max_time is not None and t > max_time:
                break
            self.now = t
            rec = self.tracker.record_push(w, t)
            dec = self.policy.on_push(self.tracker, w, t)
            self.metrics.record_push(
                w, rec.staleness, applied=dec.apply_update,
                credit=dec.credit_used, time=t)
            if dec.release_now:
                self._release(w, t, 0.0)
            else:
                self._blocked[w] = t
            # Every push may unblock waiters (Alg. 1 line 17 re-check).
            self._drain_blocked(t)
            if max_pushes is not None and self.metrics.total_pushes >= max_pushes:
                break

        # Workers still blocked at the end contribute their tail wait.
        for w, arrival in self._blocked.items():
            self.metrics.record_wait(w, max(0.0, self.now - arrival))
        self._blocked.clear()
        return self.metrics

    def _drain_blocked(self, t: float) -> None:
        # Iterate to fixpoint: releasing one worker never increases another
        # blocked worker's gap, but BSP-style policies release in groups.
        progressed = True
        while progressed:
            progressed = False
            for w in sorted(self._blocked):
                if self.policy.may_release(self.tracker, w):
                    arrival = self._blocked.pop(w)
                    self._release(w, t, t - arrival)
                    progressed = True


def run_policy(policy: SyncPolicy, intervals: Sequence[float], *,
               max_pushes: int = 2000, jitter: float = 0.0,
               seed: int = 0) -> RunMetrics:
    """Convenience wrapper used by benchmarks and tests."""
    n = len(intervals)
    fn = (constant_intervals(intervals) if jitter == 0.0
          else jittered_intervals(intervals, jitter, seed))
    sim = PSSimulator(policy, n, fn)
    return sim.run(max_pushes=max_pushes)
