"""Run metrics for the parameter-server layer.

Everything the paper measures lives here: iteration throughput (pushes/s,
i.e. update frequency on the server), per-worker waiting time, staleness
distribution, and the (time, updates) trajectory used for the
convergence-vs-wall-clock plots (paper Fig. 3/4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: Trajectory lists are decimated (every other point dropped, endpoints
#: kept) whenever they reach this length, so a long run holds at most
#: ~CAP points instead of one tuple per push.
TRAJECTORY_CAP = 8192


def _decimate(lst: List) -> None:
    """Halve a trajectory in place, keeping the first and last points
    (readers depend on ``lst[0]``/``lst[-1]`` being the run endpoints)."""
    last = lst[-1]
    dec = lst[::2]
    if dec[-1] != last:
        dec.append(last)
    lst[:] = dec


@dataclasses.dataclass
class RunMetrics:
    policy: str
    n_workers: int
    total_pushes: int = 0
    applied_updates: int = 0
    dropped_updates: int = 0
    total_time: float = 0.0
    wait_time: Dict[int, float] = dataclasses.field(default_factory=dict)
    pushes: Dict[int, int] = dataclasses.field(default_factory=dict)
    staleness_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    credit_releases: int = 0
    # (virtual/wall time, cumulative applied updates) trajectory
    update_trajectory: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    # optional loss trajectory from real training: (time, step, loss)
    loss_trajectory: List[Tuple[float, int, float]] = dataclasses.field(
        default_factory=list)

    # -- recording ---------------------------------------------------------
    def record_push(self, worker: int, staleness: int, *,
                    applied: bool, credit: bool, time: float) -> None:
        self.total_pushes += 1
        self.pushes[worker] = self.pushes.get(worker, 0) + 1
        self.staleness_hist[staleness] = (
            self.staleness_hist.get(staleness, 0) + 1)
        if applied:
            self.applied_updates += 1
        else:
            self.dropped_updates += 1
        if credit:
            self.credit_releases += 1
        self.update_trajectory.append((time, self.applied_updates))
        if len(self.update_trajectory) >= TRAJECTORY_CAP:
            _decimate(self.update_trajectory)
        self.total_time = max(self.total_time, time)

    def record_loss_point(self, time: float, step: int,
                          loss: float) -> None:
        self.loss_trajectory.append((time, step, loss))
        if len(self.loss_trajectory) >= TRAJECTORY_CAP:
            _decimate(self.loss_trajectory)

    def record_wait(self, worker: int, waited: float) -> None:
        self.wait_time[worker] = self.wait_time.get(worker, 0.0) + waited

    # -- summaries ----------------------------------------------------------
    @property
    def total_wait(self) -> float:
        return sum(self.wait_time.values())

    @property
    def throughput(self) -> float:
        """Applied updates per unit time — the paper's iteration throughput."""
        return self.applied_updates / self.total_time if self.total_time else 0.0

    @property
    def max_staleness(self) -> int:
        return max(self.staleness_hist, default=0)

    @property
    def mean_staleness(self) -> float:
        n = sum(self.staleness_hist.values())
        if not n:
            return 0.0
        return sum(s * c for s, c in self.staleness_hist.items()) / n

    def wait_fraction(self) -> float:
        """Fraction of aggregate worker-time spent blocked."""
        denom = self.n_workers * self.total_time
        return self.total_wait / denom if denom else 0.0

    def time_to_updates(self, n: int) -> Optional[float]:
        """Virtual/wall time at which the n-th update was applied (Table I analogue)."""
        for t, u in self.update_trajectory:
            if u >= n:
                return t
        return None

    def time_to_loss(self, target: float) -> Optional[float]:
        """Wall time to first reach loss <= target (paper Table I analogue)."""
        for t, _, loss in self.loss_trajectory:
            if loss <= target:
                return t
        return None

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "workers": self.n_workers,
            "pushes": self.total_pushes,
            "applied": self.applied_updates,
            "dropped": self.dropped_updates,
            "time": round(self.total_time, 6),
            "throughput": round(self.throughput, 3),
            "total_wait": round(self.total_wait, 6),
            "wait_frac": round(self.wait_fraction(), 4),
            "mean_staleness": round(self.mean_staleness, 3),
            "max_staleness": self.max_staleness,
            "credit_releases": self.credit_releases,
        }


def compare(metrics: List[RunMetrics]) -> str:
    """Fixed-width comparison table for benchmark output."""
    cols = ["policy", "throughput", "total_wait", "wait_frac",
            "mean_staleness", "max_staleness", "applied", "time"]
    rows = [[str(m.summary()[c]) for c in cols] for m in metrics]
    widths = [max(len(c), *(len(r[i]) for r in rows)) for i, c in enumerate(cols)]
    out = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        out.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    return "\n".join(out)


def hist_percentile(hist: Dict[int, int], q: float) -> float:
    """q-quantile (q in [0,1]) of a value->count histogram.

    Weighted quantile straight off the histogram — O(distinct values),
    never materializing one entry per observation.  Matches
    ``statistics.quantiles(xs, n=100, method='exclusive')`` at the
    percentile index the old list-based implementation used, so results
    are bit-identical to the pre-histogram code path.
    """
    items = sorted((s, c) for s, c in hist.items() if c > 0)
    total = sum(c for _, c in items)
    if total == 0:
        return 0.0
    if total == 1:
        return float(items[0][0])

    def order_stat(k: int) -> int:
        # 0-indexed k-th smallest observation, by cumulative count.
        cum = 0
        for s, c in items:
            cum += c
            if k < cum:
                return s
        return items[-1][0]

    # statistics.quantiles(n=100) exclusive method, at cut point i:
    #   j = clamp(i * (N + 1) // 100, 1, N - 1)
    #   delta = i * (N + 1) - j * 100      (after clamping, so it can
    #                                       leave [0, 100] at the tails)
    #   result = (x[j-1] * (100 - delta) + x[j] * delta) / 100
    i = min(98, max(0, int(q * 100) - 1)) + 1
    m = total + 1
    j = min(max(i * m // 100, 1), total - 1)
    delta = i * m - j * 100
    lo, hi = order_stat(j - 1), order_stat(j)
    return (lo * (100 - delta) + hi * delta) / 100


def staleness_percentile(m: RunMetrics, q: float) -> float:
    """q-quantile of observed staleness (q in [0,1])."""
    return hist_percentile(m.staleness_hist, q)
