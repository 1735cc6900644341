"""Process-local bounded ring-buffer trace recorder.

One module-global recorder (``TRACE``) per process; every hook in the
hot path is written as

    t0 = TRACE.now() if TRACE.enabled else 0.0
    ... the traced region ...
    if TRACE.enabled:
        TRACE.span("push", t0, worker=w, clock=it, args={...})

so a build that never enables tracing pays exactly one attribute read
per hook site, and a *call* on the disabled recorder is a single
early-return.

Design constraints, in order:

  * **Bounded.**  Events land in a ``collections.deque(maxlen=...)`` —
    a run that out-produces its drain cadence silently drops its
    *oldest* events instead of growing without bound.
  * **Cheap.**  The enabled fast path is one ``perf_counter`` read, one
    counter bump and one tuple append (all GIL-atomic enough for the
    server's many pushing threads; the per-recorder ``seq`` comes from
    ``itertools.count``, whose ``__next__`` is atomic in CPython).
  * **Mergeable.**  Timestamps are monotonic (``time.perf_counter``)
    while recording and converted to *wall-clock* seconds on ``drain``
    using the wall/mono anchor captured at ``enable`` — so ring
    buffers drained from different processes land on one comparable
    time axis, and ordering within a process never goes backwards.

Event record (the dict ``drain`` emits; also the JSONL line format):

    {"seq": int,          # per-recorder monotone id (dedup key)
     "ts": float,         # wall-clock seconds (start of the span)
     "dur": float,        # seconds; 0.0 for instant events
     "name": str,         # see EVENT_NAMES
     "worker": int,       # -1 when not worker-scoped
     "shard": int,        # -1 when not shard-scoped
     "clock": int,        # worker iteration / push count; -1 unknown
     "src": str,          # recorder source ("server", "w0", ...)
     "args": dict}        # optional event payload

Stdlib-only on purpose: spawned workers and CLI tooling import this
without torch anywhere near the path.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

#: Ring capacity when ``enable`` is not given one.  At ~100 bytes per
#: event tuple this bounds a recorder around a few MB.
DEFAULT_CAPACITY = 65536

#: The typed event vocabulary (exporters and ``summarize`` key on it).
EVENT_NAMES = (
    "push",              # span: one gated push, server side
    "gate_wait",         # span: time blocked in the Algorithm-1 gate
    "apply",             # span: one optimizer apply (tree or fused)
    "coalesce_flush",    # span: one batched fused_update_batched launch
    "pull",              # span: full-snapshot pull
    "pull_delta",        # span: version-delta pull
    "kernel_launch",     # instant: one kernel launch
    "compute_step",      # span: one worker forward/backward iteration
    "dssp_decision",     # instant: Algorithm-1/2 gate decision (DSSP)
    "frame_tx",          # instant: one encoded transport frame
    "frame_rx",          # instant: one decoded transport frame
    "metrics_snapshot",  # instant: periodic MetricsSampler sample
    "snapshot",          # span: one whole server checkpoint (repro_torch.ft)
    "snapshot_shard",    # span: one shard's state grab UNDER its lock —
                         #       the only pause a snapshot imposes
    "snapshot_write",    # span: one snapshot's serialization to disk
                         #       (the checkpoint writer thread)
    "reconnect",         # span: a client's backoff reconnect loop
    "failover",          # span: server restart-and-resume from a snapshot
    "fault",             # instant: one injected FaultPlan event
    "reshard",           # span: one whole live reshard (repro_torch.ft)
    "reshard_shard",     # span: one old shard's retire-and-copy UNDER
                         #       its lock — a reshard's only pause
    "replica_refresh",   # span: a serving replica's delta-pull refresh
    "decode_batch",      # span: one continuously-batched decode call
    "staleness_block",   # span: admission blocked on the serve-side
                         #       SSP gate until a fresh refresh landed
)


class TraceRecorder:
    """Bounded, process-local, thread-tolerant event ring."""

    __slots__ = ("enabled", "source", "capacity", "_events", "_seq",
                 "_wall0", "_mono0", "_lock")

    def __init__(self) -> None:
        self.enabled = False
        self.source = ""
        self.capacity = DEFAULT_CAPACITY
        self._events: collections.deque = collections.deque(
            maxlen=DEFAULT_CAPACITY)
        self._seq = itertools.count()
        self._wall0 = 0.0
        self._mono0 = 0.0
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------
    def enable(self, source: str = "server",
               capacity: int = DEFAULT_CAPACITY) -> None:
        """Arm the recorder: fresh ring, fresh seq, wall/mono anchor."""
        with self._lock:
            self.source = source
            self.capacity = int(capacity)
            self._events = collections.deque(maxlen=self.capacity)
            self._seq = itertools.count()
            self._wall0 = time.time()
            self._mono0 = time.perf_counter()
            self.enabled = True

    def disable(self) -> None:
        """Stop recording and drop anything not yet drained."""
        with self._lock:
            self.enabled = False
            self._events.clear()

    # -- recording (the hot path) ----------------------------------------
    def now(self) -> float:
        """Span start timestamp (monotonic; pair with ``span``)."""
        return time.perf_counter()

    def instant(self, name: str, *, worker: int = -1, shard: int = -1,
                clock: int = -1,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a zero-duration event; no-op while disabled."""
        if not self.enabled:
            return
        self._events.append((next(self._seq), time.perf_counter(), 0.0,
                             name, worker, shard, clock, args))

    def span(self, name: str, t0: float, *, worker: int = -1,
             shard: int = -1, clock: int = -1,
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span started at ``t0`` (= an earlier ``now()``)
        ending now; no-op while disabled."""
        if not self.enabled:
            return
        dur = time.perf_counter() - t0
        self._events.append((next(self._seq), t0, dur, name, worker,
                             shard, clock, args))

    # -- draining --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def drain(self) -> List[Dict[str, Any]]:
        """Swap the ring out and return its events as wall-clock dicts.

        Safe to call while recording continues: the swap happens under
        the lock; an append racing the swap lands in whichever ring it
        grabbed first (at most a handful of events slide to the next
        drain — never lost, never duplicated).
        """
        with self._lock:
            if not self._events:
                return []
            batch = self._events
            self._events = collections.deque(maxlen=self.capacity)
            wall0, mono0, src = self._wall0, self._mono0, self.source
        out = []
        for seq, t0, dur, name, worker, shard, clock, args in batch:
            e: Dict[str, Any] = {
                "seq": seq,
                "ts": wall0 + (t0 - mono0),
                "dur": dur,
                "name": name,
                "worker": worker,
                "shard": shard,
                "clock": clock,
                "src": src,
            }
            if args:
                e["args"] = args
            out.append(e)
        return out


#: The process-global recorder every instrumented site writes through.
TRACE = TraceRecorder()
