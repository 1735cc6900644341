"""Staleness bookkeeping shared by every synchronization policy.

This is the server-side state of Algorithm 1 in the paper:

  * ``t_i``       — number of push requests received from worker ``i`` so far
                    (the worker's *iteration count* as seen by the server).
  * ``A[i][0..1]``— timestamps of the two latest push requests per worker
                    (Algorithm 2's table A).
  * ``r_i``       — extra-iteration credit granted to worker ``i`` beyond the
                    staleness lower bound ``s_L`` (DSSP only).

The tracker is policy-agnostic: BSP/ASP/SSP/DSSP all read from it, only
DSSP writes credits.  All methods are O(#workers) or better and are called
under the server lock, so no internal synchronization is needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass
class PushRecord:
    """One push request as seen by the server (for metrics/replay)."""

    worker: int
    iteration: int          # t_p after increment
    timestamp: float        # server-side arrival clock
    staleness: int          # t_p - t_slowest at arrival
    waited: float = 0.0     # seconds the worker was blocked before OK
    credit_used: bool = False   # released via a pre-granted r_p credit


class StalenessTracker:
    """Server-side iteration counts + two-latest-push timestamp table."""

    def __init__(self, workers: Iterable[int]):
        self.workers: List[int] = list(workers)
        if not self.workers:
            raise ValueError("StalenessTracker needs at least one worker")
        self.counts: Dict[int, int] = {w: 0 for w in self.workers}
        # A[i] = (latest_ts, second_latest_ts); NaN = not yet observed.
        self.table: Dict[int, Tuple[float, float]] = {
            w: (math.nan, math.nan) for w in self.workers
        }
        self.credits: Dict[int, int] = {w: 0 for w in self.workers}
        self.history: List[PushRecord] = []

    # -- membership (elastic clusters: workers may join/leave) -------------
    def add_worker(self, w: int) -> None:
        if w in self.counts:
            return
        self.workers.append(w)
        # A joining worker starts at the *slowest* count so it does not
        # stall everyone (it is "caught up by definition" on arrival).
        self.counts[w] = self.slowest_count()
        self.table[w] = (math.nan, math.nan)
        self.credits[w] = 0

    def remove_worker(self, w: int) -> None:
        if w not in self.counts:
            return  # already departed (idempotent for crash paths)
        self.workers.remove(w)
        del self.counts[w], self.table[w], self.credits[w]

    # -- Algorithm 1 bookkeeping -------------------------------------------
    def record_push(self, worker: int, timestamp: float) -> PushRecord:
        """t_p += 1; shift table A; return the record (staleness filled in)."""
        if worker not in self.counts:
            self.add_worker(worker)
        self.counts[worker] += 1
        latest, _ = self.table[worker]
        self.table[worker] = (timestamp, latest)
        rec = PushRecord(
            worker=worker,
            iteration=self.counts[worker],
            timestamp=timestamp,
            staleness=self.counts[worker] - self.slowest_count(),
        )
        self.history.append(rec)
        return rec

    # -- queries -------------------------------------------------------------
    def slowest_count(self) -> int:
        return min(self.counts.values(), default=0)

    def fastest_count(self) -> int:
        return max(self.counts.values(), default=0)

    def slowest_worker(self) -> int:
        return min(self.workers, key=lambda w: (self.counts[w], w))

    def fastest_worker(self) -> int:
        return max(self.workers, key=lambda w: (self.counts[w], -w))

    def is_fastest(self, worker: int) -> bool:
        return self.counts[worker] == self.fastest_count()

    def gap(self, worker: int) -> int:
        """t_p - t_slowest (the staleness of worker's next iteration)."""
        return self.counts[worker] - self.slowest_count()

    def latest_interval(self, worker: int) -> Optional[float]:
        """Length of the latest iteration interval of ``worker`` (Alg. 2 L4-5).

        None until the server has seen two pushes from the worker.
        """
        latest, second = self.table[worker]
        if math.isnan(latest) or math.isnan(second):
            return None
        return latest - second

    def latest_timestamp(self, worker: int) -> Optional[float]:
        ts = self.table[worker][0]
        return None if math.isnan(ts) else ts

    # -- metrics --------------------------------------------------------------
    def staleness_profile(self) -> Dict[int, int]:
        return {w: self.gap(w) for w in self.workers}

    def max_observed_staleness(self) -> int:
        return max((r.staleness for r in self.history), default=0)


def regret_bound_constant(s: int, num_workers: int) -> float:
    """The √(2(s+1)P) factor in the paper's Theorem 1/2 regret bound.

    DSSP with range [s_L, s_U] has the same bound as SSP with s = s_U
    (Theorem 2: substitute s' = s_L + r_max).  Exposed so experiments can
    report the theoretical staleness penalty next to measured throughput.
    """
    if s < 0 or num_workers < 1:
        raise ValueError("staleness must be >= 0 and workers >= 1")
    return math.sqrt(2.0 * (s + 1) * num_workers)


def dssp_effective_bound(s_lower: int, s_upper: int) -> int:
    """Worst-case staleness DSSP can admit = s_U (Theorem 2)."""
    if not 0 <= s_lower <= s_upper:
        raise ValueError(f"need 0 <= s_L <= s_U, got [{s_lower}, {s_upper}]")
    return s_upper
