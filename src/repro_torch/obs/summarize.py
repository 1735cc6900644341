"""Trace analysis: the paper's quantities out of a trace file.

``summarize(events)`` reduces a merged event list (from a
``TraceCollector`` or read back via ``export.read_trace``) to the
numbers the DSSP paper reports on:

  * **wait fraction** — total ``gate_wait`` time over the run's
    worker-seconds (wall span x number of workers seen computing),
    i.e. the fraction of capacity the synchronization gate burned.
  * **threshold timeline** — the effective staleness threshold chosen
    at each ``dssp_decision`` event, in (worker, clock) order, plus the
    count of threshold *extensions* (decisions where a credit was
    granted or spent — exactly the pushes ``RunMetrics`` counts in
    ``credit_releases``).
  * **staleness percentiles** — p50/p90/p99 of per-push staleness,
    computed from the histogram of ``push`` span args with the same
    weighted-quantile rule as ``ps/metrics.staleness_percentile``.

``python -m repro_torch.obs summarize <trace>`` prints ``format_summary``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List


def summarize(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce a merged trace to the run-level summary dict."""
    from repro_torch.ps.metrics import hist_percentile

    events = list(events)
    spans = [e for e in events if float(e.get("dur", 0.0)) > 0.0]
    t_lo = min((float(e["ts"]) for e in events), default=0.0)
    t_hi = max((float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))
                for e in events), default=0.0)
    wall = max(t_hi - t_lo, 0.0)

    by_name: Dict[str, int] = {}
    for e in events:
        name = e.get("name", "event")
        by_name[name] = by_name.get(name, 0) + 1

    workers = sorted({int(e.get("worker", -1)) for e in events
                      if e.get("name") in ("compute_step", "gate_wait",
                                           "push")
                      and int(e.get("worker", -1)) >= 0})
    wait_s = sum(float(e["dur"]) for e in spans
                 if e.get("name") == "gate_wait")
    busy_s = sum(float(e["dur"]) for e in spans
                 if e.get("name") == "compute_step")
    worker_seconds = wall * max(len(workers), 1)
    wait_fraction = (wait_s / worker_seconds) if worker_seconds > 0 else 0.0

    per_worker_wait: Dict[int, float] = {}
    for e in spans:
        if e.get("name") == "gate_wait":
            w = int(e.get("worker", -1))
            per_worker_wait[w] = per_worker_wait.get(w, 0.0) + float(e["dur"])

    # DSSP decision timeline, in the stable (worker, clock) merge order.
    decisions = sorted(
        (e for e in events if e.get("name") == "dssp_decision"),
        key=lambda e: (int(e.get("clock", -1)), int(e.get("worker", -1)),
                       e.get("seq", -1)))
    timeline = []
    # Extensions dedup by (worker, clock): a sharded server runs one
    # policy PER SHARD, so one push emits S decision events with the
    # same worker-clock; ``RunMetrics.credit_releases`` counts that
    # push once (credit ORed across shards), and so must we.
    extended = set()
    for e in decisions:
        a = e.get("args") or {}
        reason = a.get("reason", "")
        if reason in ("grant", "credit_spend"):
            extended.add((int(e.get("worker", -1)),
                          int(e.get("clock", -1))))
        timeline.append({
            "worker": int(e.get("worker", -1)),
            "clock": int(e.get("clock", -1)),
            "threshold": a.get("threshold"),
            "reason": reason,
            "s_lower": a.get("s_lower"),
            "s_upper": a.get("s_upper"),
        })

    # Staleness distribution from push spans, as a histogram — the
    # weighted-quantile helper keeps this O(distinct values).
    hist: Dict[int, int] = {}
    for e in events:
        if e.get("name") == "push":
            s = (e.get("args") or {}).get("staleness")
            if s is not None:
                hist[int(s)] = hist.get(int(s), 0) + 1
    percentiles = {f"p{q}": hist_percentile(hist, q / 100.0)
                   for q in (50, 90, 99)} if hist else {}

    return {
        "events": len(events),
        "event_counts": by_name,
        "wall_s": wall,
        "workers": workers,
        "wait_s": wait_s,
        "busy_s": busy_s,
        "wait_fraction": wait_fraction,
        "per_worker_wait_s": per_worker_wait,
        "dssp": {
            "decisions": len(decisions),
            "threshold_extensions": len(extended),
            "timeline": timeline,
        },
        "staleness": {"hist": hist, **percentiles},
    }


def format_summary(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of a ``summarize`` dict."""
    lines: List[str] = []
    lines.append(f"events           {summary['events']}")
    counts = summary.get("event_counts", {})
    if counts:
        body = "  ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        lines.append(f"by name          {body}")
    lines.append(f"wall time        {summary['wall_s']:.3f}s")
    workers = summary.get("workers", [])
    lines.append(f"workers          {len(workers)} "
                 f"({', '.join(map(str, workers)) or '-'})")
    lines.append(f"gate wait        {summary['wait_s']:.3f}s  "
                 f"(fraction {summary['wait_fraction']:.4f})")
    pww = summary.get("per_worker_wait_s", {})
    if pww:
        body = "  ".join(f"w{w}={t:.3f}s" for w, t in sorted(pww.items()))
        lines.append(f"wait by worker   {body}")
    dssp = summary.get("dssp", {})
    lines.append(f"dssp decisions   {dssp.get('decisions', 0)}  "
                 f"(threshold extensions {dssp.get('threshold_extensions', 0)})")
    timeline = dssp.get("timeline", [])
    if timeline:
        lines.append("threshold timeline (worker@clock -> threshold/reason):")
        shown = timeline if len(timeline) <= 20 else timeline[:20]
        for d in shown:
            lines.append(f"    w{d['worker']}@{d['clock']:<6d} -> "
                         f"{d['threshold']} ({d['reason']})")
        if len(timeline) > len(shown):
            lines.append(f"    ... {len(timeline) - len(shown)} more")
    st = summary.get("staleness", {})
    if st.get("hist"):
        lines.append(f"staleness        p50={st.get('p50')}  "
                     f"p90={st.get('p90')}  p99={st.get('p99')}")
    return "\n".join(lines)
