"""Continuous-batching request queue for the serving replicas.

Counterpart of ``repro/serve/batching.py``, copied: one thread-safe
queue per replica.  Producers ``submit`` decode requests; the replica's
serve loop calls ``next_batch``, which blocks for the first request,
then lingers up to ``window_s`` collecting more (to ``max_batch``)
before handing the batch to the decoder, so a burst shares one decode
call while a lone request never waits longer than the window.

Stdlib and numpy only: the queue runs inside spawned replica processes
next to the transport client, before the decoder takes over.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DecodeRequest:
    """One prompt in, one greedy continuation out.

    The submit side fills ``request_id``/``prompt``/``enqueue_t``; the
    replica fills the completion fields when the batch it rode in
    finishes decoding.
    """

    request_id: int
    prompt: np.ndarray                    # (prompt_len,) int32 token ids
    enqueue_t: float = 0.0                # perf_counter at submit
    # -- completion (filled by the replica) ------------------------------
    tokens: Optional[np.ndarray] = None   # (max_new,) generated ids
    latency_s: float = 0.0                # enqueue -> decode done
    staleness: int = -1                   # admitted at this staleness
    version: int = -1                     # resident version served from
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)


class BatchQueue:
    """Blocking submit/next_batch pair with a linger window.

    ``next_batch`` returns ``None`` exactly once the queue is closed
    AND drained: the replica's serve-loop sentinel.  ``close`` wakes
    every waiter; requests already queued still get served.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: List[DecodeRequest] = []
        self._closed = False
        self.submitted = 0

    def submit(self, request: DecodeRequest) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._items.append(request)
            self.submitted += 1
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def next_batch(self, max_batch: int,
                   window_s: float) -> Optional[List[DecodeRequest]]:
        """Block for the first request, linger up to ``window_s`` for
        more, return at most ``max_batch`` in FIFO order.  ``None``
        means closed and drained: stop serving."""
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                self._cond.wait(timeout=0.25)
            if len(self._items) < max_batch and window_s > 0:
                # One bounded wait: either more arrivals topped the batch
                # up (notify fired) or the window elapsed and we serve
                # what we have.
                self._cond.wait(timeout=window_s)
            batch = self._items[:max_batch]
            del self._items[:len(batch)]
            return batch

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


__all__ = ["BatchQueue", "DecodeRequest"]
