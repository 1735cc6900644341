"""Cross-process trace collection: many ring buffers, one timeline.

Worker processes drain their ``TRACE`` ring as ``MSG_TRACE`` frames
over whatever transport the run already speaks (plus a per-process
JSONL spill for abnormal exits — see ``launch/proc_pool.py``); the
server-side ``PSServerEndpoint`` hands each batch to a
``TraceCollector``, which dedups and merges them with the server's own
recorder into one run timeline.

Dedup is by ``(src, seq)``: a worker's events may arrive twice (once
over a frame, once recovered from its spill file), and the per-recorder
monotone ``seq`` makes the duplicate exact, so recovery after a kill is
idempotent with the happy path.

``MetricsSampler`` is the interval half of the telemetry: a daemon
thread sampling a callable (staleness histogram, per-worker wait,
effective threshold, perfcount counters — whatever the session wires
in) into ``metrics_snapshot`` instants on the server recorder.
"""

from __future__ import annotations

import pathlib
import threading
from typing import Any, Callable, Dict, Iterable, List

from repro_torch.obs.trace import TraceRecorder


class TraceCollector:
    """Merge drained event batches from many sources, exactly once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._seen: set = set()

    def __len__(self) -> int:
        return len(self._events)

    # -- ingestion -------------------------------------------------------
    def ingest(self, source: str, events: Iterable[Any]) -> int:
        """Add one drained batch; returns how many were new.

        Each event keeps its own ``src`` when it carries one (spill
        files and frames both ship recorder-stamped events); ``source``
        is the fallback for events without.  Malformed entries are
        dropped, not raised — collection must never fail a run.
        """
        added = 0
        with self._lock:
            for e in events:
                if not isinstance(e, dict) or "name" not in e:
                    continue
                src = e.get("src") or source
                key = (src, e.get("seq", -1))
                if key in self._seen:
                    continue
                self._seen.add(key)
                if e.get("src") != src:
                    e = dict(e)
                    e["src"] = src
                self._events.append(e)
                added += 1
        return added

    def ingest_local(self, recorder: TraceRecorder,
                     source: str = "server") -> int:
        """Drain an in-process recorder straight into the collector."""
        return self.ingest(recorder.source or source, recorder.drain())

    def ingest_spill_dir(self, path) -> int:
        """Recover per-process JSONL spill files (``<src>.jsonl``).

        The reader tolerates a truncated final line — exactly what a
        killed worker leaves behind.
        """
        from repro_torch.obs.export import read_jsonl
        p = pathlib.Path(path)
        if not p.is_dir():
            return 0
        added = 0
        for f in sorted(p.glob("*.jsonl")):
            added += self.ingest(f.stem, read_jsonl(f))
        return added

    # -- merged views ----------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def timeline(self) -> List[Dict[str, Any]]:
        """All events on one wall-clock axis (export order)."""
        return sorted(self.events(),
                      key=lambda e: (e.get("ts", 0.0), e.get("src", ""),
                                     e.get("seq", -1)))

    def by_worker_clock(self) -> List[Dict[str, Any]]:
        """The run timeline the DSSP analysis wants: grouped by worker,
        ordered by that worker's iteration clock.  The key is total —
        ``(worker, clock, ts, src, seq)`` — so the merge order is
        stable regardless of frame/spill arrival order."""
        return sorted(self.events(),
                      key=lambda e: (e.get("worker", -1),
                                     e.get("clock", -1),
                                     e.get("ts", 0.0),
                                     e.get("src", ""),
                                     e.get("seq", -1)))


class MetricsSampler(threading.Thread):
    """Periodic ``metrics_snapshot`` instants on a recorder.

    ``fn`` runs on this daemon thread every ``every`` seconds; its dict
    becomes the event's ``args``.  ``stop()`` takes one final sample so
    even a run shorter than the interval gets a snapshot.
    """

    def __init__(self, recorder: TraceRecorder,
                 fn: Callable[[], Dict[str, Any]], every: float):
        super().__init__(name="obs-metrics-sampler", daemon=True)
        if every <= 0:
            raise ValueError(f"sample interval must be > 0, got {every}")
        self.recorder = recorder
        self.fn = fn
        self.every = float(every)
        # NOT named _stop: threading.Thread has a private _stop() method
        # that join() calls internally — shadowing it with an Event
        # makes every join() blow up.
        self._halt = threading.Event()

    def _sample(self) -> None:
        try:
            self.recorder.instant("metrics_snapshot", args=self.fn())
        except Exception:
            pass  # telemetry must never take the run down

    def run(self) -> None:
        while not self._halt.wait(self.every):
            self._sample()

    def stop(self) -> None:
        if not self._halt.is_set():
            self._halt.set()
            self._sample()
        self.join(timeout=2.0)
