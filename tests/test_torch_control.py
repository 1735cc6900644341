"""repro_torch's Algorithm-1 gates and Algorithm-2 controller against the
reference's: the same seeded push sequence through ``make_policy`` in
both packages gives identical decision streams and ``RunMetrics``."""

from __future__ import annotations

import heapq

import numpy as np
import pytest
import torch

import repro.core.policies as jpol
import repro.core.staleness as jstale
import repro.ps.metrics as jmetrics
import repro_torch.core.policies as tpol
import repro_torch.core.staleness as tstale
import repro_torch.ps.metrics as tmetrics
from repro_torch.obs.trace import TRACE

torch.set_num_threads(2)


def _drive(pol_mod, stale_mod, metrics_mod, mode: str, seed: int,
           n_workers: int = 4, pushes: int = 120):
    """Discrete-event run of Algorithm 1: each worker pushes after a
    seeded interval (the last one 3x slower); a blocked worker resumes
    when ``may_release`` says so, re-checked after every push."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0.8, 1.2, size=(n_workers, pushes))
    base[-1] *= 3.0
    policy = pol_mod.make_policy(mode, n_workers=n_workers, staleness=2,
                                 s_lower=1, s_upper=4)
    tracker = stale_mod.StalenessTracker(range(n_workers))
    metrics = metrics_mod.RunMetrics(policy=policy.name, n_workers=n_workers)
    events = [(base[w, 0], w) for w in range(n_workers)]
    heapq.heapify(events)
    count = [0] * n_workers
    blocked = {}
    stream = []
    while events and metrics.total_pushes < pushes:
        t, w = heapq.heappop(events)
        rec = tracker.record_push(w, t)
        dec = policy.on_push(tracker, w, t)
        metrics.record_push(w, rec.staleness, applied=dec.apply_update,
                            credit=dec.credit_used, time=t)
        stream.append((w, rec.iteration, rec.staleness, dec.apply_update,
                       dec.release_now, dec.credit_used))
        count[w] += 1
        if dec.release_now:
            heapq.heappush(events, (t + base[w, count[w] % pushes], w))
        else:
            blocked[w] = t
        for b in sorted(blocked):
            if policy.may_release(tracker, b):
                metrics.record_wait(b, t - blocked.pop(b))
                heapq.heappush(events, (t + base[b, count[b] % pushes], b))
                stream.append(("release", b, t))
    return stream, metrics


@pytest.mark.parametrize("mode", ["bsp", "asp", "ssp", "dssp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decision_streams_and_metrics_identical(mode, seed):
    js, jm = _drive(jpol, jstale, jmetrics, mode, seed)
    ts, tm = _drive(tpol, tstale, tmetrics, mode, seed)
    assert ts == js
    assert tm.summary() == jm.summary()
    assert tm.staleness_hist == jm.staleness_hist
    assert tm.wait_time == jm.wait_time
    assert tm.update_trajectory == jm.update_trajectory
    if mode == "dssp":
        assert tm.credit_releases > 0


def test_dssp_controller_grants_match_and_trace_counts_extensions():
    """The two controllers grant the same credits, and the port's traced
    grant/credit_spend decisions count exactly the credit releases."""
    TRACE.enable(source="server")
    try:
        ts, tm = _drive(tpol, tstale, tmetrics, "dssp", 3)
        events = TRACE.drain()
    finally:
        TRACE.disable()
    js, jm = _drive(jpol, jstale, jmetrics, "dssp", 3)
    assert ts == js
    ext = [e for e in events if e["name"] == "dssp_decision"
           and e["args"]["reason"] in ("grant", "credit_spend")]
    assert len(ext) == tm.credit_releases == jm.credit_releases > 0
