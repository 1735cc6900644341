"""Synchronization (gating) policies — the server side of Algorithm 1.

A policy decides, for every push request, (a) whether the carried gradient
is applied to the global weights and (b) whether the pushing worker is
released immediately (``OK``) or blocked.  Blocked workers are re-checked
(``may_release``) after every subsequent push.

Implemented paradigms:

  * ``BSPPolicy``            — lockstep (== SSP with s = 0).
  * ``ASPPolicy``            — never blocks.
  * ``SSPPolicy(s)``         — release iff t_p − t_slowest ≤ s.
  * ``DSSPPolicy(s_L, s_U)`` — the paper's contribution: Algorithm 1 with
    per-worker credits ``r_p`` granted by the Algorithm-2 controller.
  * ``BackupWorkersBSP(n, c)`` — Chen et al. 2016 baseline the paper
    discusses: per round apply the first ``n − c`` gradients, drop the
    ``c`` straggler gradients, stragglers are not blocked.

One semantic note on Algorithm 1 vs. Figure 2: the pseudocode (release on
grant at line 14, then decrement-release on later pushes at lines 3-5)
admits ``r* + 1`` releases per grant, while Figure 2's walkthrough
("DSSP allows worker₁ to run 3 more iterations and stop at the green
line") counts the on-grant release as the first of the ``r*``.  We follow
the figure: a grant of ``r*`` yields exactly ``r*`` releases
(credits ← r* − 1 plus the immediate OK), so the worker stops exactly at
the controller's predicted minimum-wait boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core.controller import SynchronizationController
from repro_torch.core.staleness import StalenessTracker, dssp_effective_bound
from repro_torch.obs.trace import TRACE


@dataclasses.dataclass
class Decision:
    apply_update: bool          # fold the pushed gradient into global weights?
    release_now: bool           # send OK immediately?
    credit_used: bool = False   # released via a pre-granted DSSP credit


class SyncPolicy:
    """Base class. Policies are stateful and are called under the server lock."""

    name = "base"

    def on_push(self, tracker: StalenessTracker, worker: int,
                timestamp: float) -> Decision:
        raise NotImplementedError

    def may_release(self, tracker: StalenessTracker, worker: int) -> bool:
        """Re-evaluated for a blocked worker after every later push."""
        raise NotImplementedError

    def effective_staleness_bound(self, tracker: StalenessTracker) -> float:
        """Upper bound on admitted staleness (for Theorem-1/2 reporting)."""
        raise NotImplementedError


class SSPPolicy(SyncPolicy):
    """Stale Synchronous Parallel with fixed threshold ``s`` (Ho et al. '13)."""

    def __init__(self, staleness: int):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.s = staleness
        self.name = f"ssp(s={staleness})"

    def on_push(self, tracker, worker, timestamp):
        return Decision(apply_update=True,
                        release_now=tracker.gap(worker) <= self.s)

    def may_release(self, tracker, worker):
        return tracker.gap(worker) <= self.s

    def effective_staleness_bound(self, tracker):
        return self.s


class BSPPolicy(SSPPolicy):
    """Bulk Synchronous Parallel — SSP with s = 0 (full barrier)."""

    def __init__(self):
        super().__init__(0)
        self.name = "bsp"


class ASPPolicy(SyncPolicy):
    """Asynchronous Parallel — apply everything, never block (Hogwild-style)."""

    name = "asp"

    def on_push(self, tracker, worker, timestamp):
        return Decision(apply_update=True, release_now=True)

    def may_release(self, tracker, worker):
        return True

    def effective_staleness_bound(self, tracker):
        return float("inf")


class DSSPPolicy(SyncPolicy):
    """Dynamic SSP (the paper, Algorithms 1 + 2).

    ``s_lower``/``s_upper`` are the user's threshold range [s_L, s_U];
    ``r_max = s_U − s_L``.  ``estimator`` selects the interval predictor
    ('last' = paper, 'ema'/'median' = robust variants, §II of DESIGN.md).
    """

    def __init__(self, s_lower: int, s_upper: int, *,
                 estimator: str = "last",
                 controller: Optional[SynchronizationController] = None):
        dssp_effective_bound(s_lower, s_upper)  # validates the range
        self.s_lower = s_lower
        self.s_upper = s_upper
        self.controller = controller or SynchronizationController(
            s_upper - s_lower, estimator=estimator)
        self.name = f"dssp(s_L={s_lower},s_U={s_upper},{estimator})"
        self.credits_granted = 0
        self.credits_spent = 0

    def _trace_decision(self, tracker, worker: int, reason: str,
                        gap: int, threshold: int, r_star: int = 0) -> None:
        """``dssp_decision`` instant: the Algorithm-1/2 gate outcome.

        ``reason`` is one of ``credit_spend`` / ``credit_void`` /
        ``free`` / ``grant`` / ``block``; the threshold *extensions*
        (``grant`` + ``credit_spend``) are exactly the pushes
        ``RunMetrics`` counts in ``credit_releases``.
        """
        TRACE.instant(
            "dssp_decision", worker=worker,
            clock=tracker.counts.get(worker, -1),
            args={"reason": reason, "gap": gap, "threshold": threshold,
                  "s_lower": self.s_lower, "s_upper": self.s_upper,
                  "r_star": r_star,
                  "credits_left": tracker.credits[worker]})

    def on_push(self, tracker, worker, timestamp):
        # Feed the interval estimator on *every* push (table A upkeep).
        self.controller.observe_push(tracker, worker)
        gap = tracker.gap(worker)

        # Lines 3-5: spend a pre-granted credit.  A credit is only valid
        # while the hard bound holds (gap can outgrow it if the slowest
        # worker *leaves* the cluster — elastic membership); otherwise the
        # credit is voided and we fall through to the gating logic.
        if tracker.credits[worker] > 0:
            if gap <= self.s_upper:
                tracker.credits[worker] -= 1
                self.credits_spent += 1
                if TRACE.enabled:
                    self._trace_decision(tracker, worker, "credit_spend",
                                         gap, self.s_upper)
                return Decision(apply_update=True, release_now=True,
                                credit_used=True)
            tracker.credits[worker] = 0
            if TRACE.enabled:
                self._trace_decision(tracker, worker, "credit_void",
                                     gap, self.s_lower)

        # Lines 8-9: within the lower bound — free to go.
        if gap <= self.s_lower:
            if TRACE.enabled:
                self._trace_decision(tracker, worker, "free", gap,
                                     self.s_lower)
            return Decision(apply_update=True, release_now=True)

        # Lines 11-15: only the *current fastest* worker consults the
        # controller (footnote 1: saves server compute).  The grant is
        # capped so the worker never *runs* an iteration more than s_U
        # ahead of the slowest (r_max is "the maximum extra iterations
        # allowed ... beyond the lower bound", §III — Theorem 2 needs the
        # total staleness bounded by s_L + r_max = s_U, so repeated grants
        # must not compound past it).
        if tracker.is_fastest(worker):
            headroom = self.s_upper - gap + 1   # releases left within bound
            if headroom > 0:
                r_star = min(self.controller(tracker, worker, timestamp),
                             headroom)
                if r_star > 0:
                    # Figure-2 semantics: this OK is the first of r* releases.
                    tracker.credits[worker] = r_star - 1
                    self.credits_granted += r_star
                    if TRACE.enabled:
                        self._trace_decision(
                            tracker, worker, "grant", gap,
                            min(self.s_upper, gap + r_star - 1),
                            r_star=r_star)
                    return Decision(apply_update=True, release_now=True,
                                    credit_used=True)

        # Line 17: block until the slowest catches up to within s_L.
        if TRACE.enabled:
            self._trace_decision(tracker, worker, "block", gap,
                                 self.s_lower)
        return Decision(apply_update=True, release_now=False)

    def may_release(self, tracker, worker):
        return tracker.gap(worker) <= self.s_lower

    def effective_staleness_bound(self, tracker):
        return self.s_upper


class BackupWorkersBSP(SyncPolicy):
    """BSP with ``c`` backup workers (Chen et al. 2016).

    Per synchronous round, the first ``n_workers − c`` arriving gradients
    are applied; once they arrive the round commits and everyone blocked
    in it is released.  The ``c`` straggler gradients of that round are
    *dropped* (their training data is wasted — the cost the paper points
    out) and the stragglers are released immediately into the next round.
    """

    def __init__(self, n_workers: int, backups: int):
        if not 0 <= backups < n_workers:
            raise ValueError("need 0 <= backups < n_workers")
        self.n = n_workers
        self.c = backups
        self.quorum = n_workers - backups
        self.round = 0
        self.applied_this_round = 0
        self.worker_round: Dict[int, int] = {}
        self.dropped = 0
        self.name = f"bsp+backup(c={backups})"

    def on_push(self, tracker, worker, timestamp):
        wr = self.worker_round.get(worker, 0)
        if wr < self.round:
            # Straggler from an already-committed round: drop, release.
            self.worker_round[worker] = wr + 1
            self.dropped += 1
            return Decision(apply_update=False, release_now=True)
        self.worker_round[worker] = wr + 1
        self.applied_this_round += 1
        if self.applied_this_round >= self.quorum:
            self.round += 1
            self.applied_this_round = 0
            return Decision(apply_update=True, release_now=True)
        return Decision(apply_update=True, release_now=False)

    def may_release(self, tracker, worker):
        # Released once the round this worker pushed into has committed.
        return self.worker_round.get(worker, 0) <= self.round

    def effective_staleness_bound(self, tracker):
        return 1  # a straggler's dropped round puts it at most 1 behind


def make_policy(name: str, *, n_workers: int = 0, staleness: int = 3,
                s_lower: int = 3, s_upper: int = 15, backups: int = 1,
                estimator: str = "last") -> SyncPolicy:
    """Factory used by configs / CLI (``--sync dssp`` etc.)."""
    name = name.lower()
    if name == "bsp":
        return BSPPolicy()
    if name == "asp":
        return ASPPolicy()
    if name == "ssp":
        return SSPPolicy(staleness)
    if name == "dssp":
        return DSSPPolicy(s_lower, s_upper, estimator=estimator)
    if name in ("backup", "bsp+backup"):
        return BackupWorkersBSP(n_workers, backups)
    raise ValueError(f"unknown sync policy {name!r}")


def make_policy_factory(name: str, **kw) -> Callable[[], SyncPolicy]:
    """Zero-arg factory of *fresh, independent* policy instances.

    Policies are stateful (credits, controller interval tables, backup
    rounds), so anything that runs several gates concurrently — one per
    parameter-server shard in the ``sharded`` gating mode — must construct
    one instance per gate: each shard's DSSP Algorithm-2 controller then
    reads its own per-shard interval table instead of a shared one.
    """
    def factory() -> SyncPolicy:
        return make_policy(name, **kw)

    factory.__name__ = f"policy_factory[{name}]"
    return factory
