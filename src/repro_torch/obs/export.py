"""Trace export/import: Chrome ``trace_event`` JSON and JSONL.

Two formats, one event schema (see ``trace.py``):

  * **JSONL** — one event dict per line.  This is the spill format
    workers write incrementally (a truncated last line from a killed
    process is tolerated on read) and the lossless interchange format.
  * **Chrome trace JSON** — ``{"traceEvents": [...]}``, loadable in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Spans
    become complete events (``ph: "X"``), zero-duration records become
    thread-scoped instants (``ph: "i"``); each source gets its own pid
    with a ``process_name`` metadata record, and the worker id becomes
    the tid so per-worker lanes line up.  The native fields Chrome has
    no slot for (``seq``/``clock``/``shard``/``src``) ride in ``args``
    so ``read_trace`` can round-trip the file back into event dicts.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Iterable, List

_US = 1e6  # trace_event timestamps are microseconds


# -- JSONL ---------------------------------------------------------------
def write_jsonl(events: Iterable[Dict[str, Any]], path) -> int:
    """Write events one-per-line; returns the count written."""
    n = 0
    with open(path, "w", encoding="utf-8") as fh:
        for e in events:
            fh.write(json.dumps(e, separators=(",", ":")))
            fh.write("\n")
            n += 1
    return n


def read_jsonl(path) -> List[Dict[str, Any]]:
    """Read a JSONL trace, tolerating a truncated final line (the
    signature a killed worker's spill file leaves behind)."""
    out: List[Dict[str, Any]] = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return out
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue  # mid-write when the process died
            if isinstance(e, dict):
                out.append(e)
    return out


# -- Chrome trace_event --------------------------------------------------
def _chrome_records(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    pids = {src: i + 1 for i, src in
            enumerate(sorted({e.get("src", "") for e in events}))}
    records: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": src or "unknown"}}
        for src, pid in pids.items()
    ]
    for e in events:
        args = dict(e.get("args") or {})
        for k in ("seq", "clock", "shard", "src"):
            if k in e:
                args[k] = e[k]
        rec: Dict[str, Any] = {
            "name": e.get("name", "event"),
            "cat": "repro",
            "ts": float(e.get("ts", 0.0)) * _US,
            "pid": pids.get(e.get("src", ""), 0),
            "tid": max(int(e.get("worker", -1)), 0),
            "args": args,
        }
        dur = float(e.get("dur", 0.0))
        if dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = dur * _US
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        records.append(rec)
    return records


def write_chrome_trace(events: Iterable[Dict[str, Any]], path) -> int:
    """Write a Perfetto-loadable ``{"traceEvents": [...]}`` file;
    returns the number of (non-metadata) events written."""
    events = list(events)
    doc = {"traceEvents": _chrome_records(events),
           "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return len(events)


def _from_chrome(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for r in records:
        if not isinstance(r, dict) or r.get("ph") == "M":
            continue
        args = dict(r.get("args") or {})
        e: Dict[str, Any] = {
            "seq": args.pop("seq", -1),
            "ts": float(r.get("ts", 0.0)) / _US,
            "dur": float(r.get("dur", 0.0)) / _US,
            "name": r.get("name", "event"),
            "worker": int(r.get("tid", -1)),
            "shard": args.pop("shard", -1),
            "clock": args.pop("clock", -1),
            "src": args.pop("src", ""),
        }
        if args:
            e["args"] = args
        out.append(e)
    return out


def read_trace(path) -> List[Dict[str, Any]]:
    """Read either trace format back into event dicts.

    Sniffs the content: a JSON object with ``traceEvents`` is a Chrome
    trace; anything else is treated as JSONL.
    """
    p = pathlib.Path(path)
    text = p.read_text(encoding="utf-8")
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and "traceEvents" in doc:
            return _from_chrome(doc["traceEvents"])
    return read_jsonl(p)
