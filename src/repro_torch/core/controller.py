"""Algorithm 2: the DSSP synchronization controller.

Given the two latest push timestamps of every worker (table A in the
paper), the controller simulates the next ``r_max`` push times of the
current fastest worker ``p`` and of the slowest worker, and returns the
extra-iteration credit ``r* ∈ [0, r_max]`` that minimizes the *predicted*
waiting time of ``p``:

    Sim_p[0]       = A[p][0]
    Sim_p[i]       = Sim_p[0] + i · I_p                    (i = 1..r_max)
    Sim_slow[0]    = A[slow][0] + I_slow
    Sim_slow[k]    = Sim_slow[0] + k · I_slow              (k = 1..r_max)
    r*             = argmin_r  min_k | Sim_slow[k] − Sim_p[r] |

where I_w = A[w][0] − A[w][1] is the latest iteration interval of worker
``w`` (the paper's one-step predictor, §III.B assumption: contiguous
iterations of a worker in a short window have similar processing time).

Beyond-paper extensions (all optional, default = paper behaviour):

  * interval estimators 'ema' and 'median' — robust to transient network
    jitter the paper flags as a failure mode of the last-interval
    predictor ("we may make some wrong predictions … DSSP can still
    converge").
  * asymmetric tie-breaking — on equal predicted waits prefer the smaller
    r (less staleness ⇒ smaller Theorem-2 regret constant), which the
    paper's argmin leaves unspecified.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.staleness import StalenessTracker


def simulate_push_times(start: float, interval: float, r_max: int,
                        *, lead: int = 0) -> List[float]:
    """Sim array of Algorithm 2 lines 6-7.

    ``lead=0`` gives Sim_p (first entry = the just-received push);
    ``lead=1`` gives Sim_slowest (first entry = the *next predicted* push
    of the slowest worker, A[slow][0] + I_slow).
    """
    if r_max < 0:
        raise ValueError("r_max must be >= 0")
    if interval < 0:
        raise ValueError("interval must be >= 0")
    return [start + (i + lead) * interval for i in range(r_max + 1)]


def optimal_extra_iterations(sim_fast: Sequence[float],
                             sim_slow: Sequence[float]) -> int:
    """Line 8 of Algorithm 2: argmin_r min_k |sim_slow[k] - sim_fast[r]|.

    Ties broken toward smaller r (lower staleness, see module docstring).
    """
    best_r, best_gap = 0, float("inf")
    for r, tp in enumerate(sim_fast):
        gap = min(abs(ts - tp) for ts in sim_slow)
        if gap < best_gap:
            best_r, best_gap = r, gap
    return best_r


@dataclasses.dataclass
class ControllerDecision:
    """One controller invocation, kept for metrics/EXPERIMENTS."""

    worker: int
    r_star: int
    predicted_wait: float
    interval_fast: float
    interval_slow: float
    timestamp: float


class IntervalEstimator:
    """Predicts a worker's next iteration interval from its push history."""

    def __init__(self, mode: str = "last", window: int = 8,
                 ema_alpha: float = 0.5):
        if mode not in ("last", "ema", "median"):
            raise ValueError(f"unknown estimator mode {mode!r}")
        self.mode = mode
        self.window = window
        self.ema_alpha = ema_alpha
        self._hist: Dict[int, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._ema: Dict[int, float] = {}

    def observe(self, worker: int, interval: float) -> None:
        self._hist[worker].append(interval)
        prev = self._ema.get(worker)
        self._ema[worker] = (interval if prev is None
                             else self.ema_alpha * interval
                             + (1 - self.ema_alpha) * prev)

    def predict(self, worker: int) -> Optional[float]:
        hist = self._hist.get(worker)
        if not hist:
            return None
        if self.mode == "last":
            return hist[-1]
        if self.mode == "ema":
            return self._ema[worker]
        return statistics.median(hist)


class SynchronizationController:
    """The server-side controller DSSP calls for the current fastest worker.

    ``r_max = s_U − s_L`` is the width of the user-given threshold range.
    """

    def __init__(self, r_max: int, *, estimator: str = "last",
                 window: int = 8):
        if r_max < 0:
            raise ValueError("r_max must be >= 0")
        self.r_max = r_max
        self.estimator = IntervalEstimator(mode=estimator, window=window)
        self.decisions: List[ControllerDecision] = []

    # The tracker's record_push() already maintains table A; the controller
    # additionally feeds its interval estimator (a superset of the paper's
    # last-interval table when estimator != 'last').
    def observe_push(self, tracker: StalenessTracker, worker: int) -> None:
        interval = tracker.latest_interval(worker)
        if interval is not None:
            self.estimator.observe(worker, max(0.0, interval))

    def __call__(self, tracker: StalenessTracker, worker: int,
                 push_timestamp: float) -> int:
        """Algorithm 2. Returns r* (0 ⇒ block now, paper line 17)."""
        slowest = tracker.slowest_worker()
        i_fast = self.estimator.predict(worker)
        i_slow = self.estimator.predict(slowest)
        slow_ts = tracker.latest_timestamp(slowest)
        if i_fast is None or i_slow is None or slow_ts is None:
            # Cold start: not enough history to simulate — the paper's
            # table A has NaNs. Be conservative: no extra credit.
            return 0
        sim_fast = simulate_push_times(push_timestamp, i_fast, self.r_max)
        sim_slow = simulate_push_times(slow_ts, i_slow, self.r_max, lead=1)
        r_star = optimal_extra_iterations(sim_fast, sim_slow)
        predicted_wait = min(abs(ts - sim_fast[r_star]) for ts in sim_slow)
        self.decisions.append(ControllerDecision(
            worker=worker, r_star=r_star, predicted_wait=predicted_wait,
            interval_fast=i_fast, interval_slow=i_slow,
            timestamp=push_timestamp))
        return r_star

    # -- metrics ----------------------------------------------------------
    def mean_granted(self) -> float:
        if not self.decisions:
            return 0.0
        return sum(d.r_star for d in self.decisions) / len(self.decisions)

    def grant_histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for d in self.decisions:
            hist[d.r_star] = hist.get(d.r_star, 0) + 1
        return hist
