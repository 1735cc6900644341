"""Bounded exponential backoff with deterministic jitter.

One policy object serves every retry loop of the transports — the tcp
client's initial connect (worker spawn vs server bind races) and the
reconnect loop of ``PSTransportClient`` — so a test can reason about
exactly how long a given failure takes to surface.

Jitter is seeded (``random.Random(seed)``), never ambient: two retry
loops constructed with the same policy and seed sleep the same
schedule, which makes a run that retries reproducible.

Counterpart of ``repro/ft/backoff.py`` (the same policies and
schedules).  Stdlib-only: the transport client imports it; the rest of
``repro_torch.ft`` (fault plans, snapshots, the restartable server
process, live resharding) builds on it.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Delay schedule: ``base_s * factor**i`` capped at ``max_s``, at
    most ``max_tries`` attempts, each delay jittered by up to
    ``jitter`` (a fraction of the delay, added)."""

    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    max_tries: int = 8
    jitter: float = 0.25

    def __post_init__(self):
        if self.base_s <= 0 or self.max_s <= 0:
            raise ValueError("backoff delays must be positive")
        if self.factor < 1.0:
            raise ValueError("backoff factor must be >= 1")
        if self.max_tries < 1:
            raise ValueError("backoff needs at least one try")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter is a fraction of the delay in [0, 1]")

    def delays(self, seed: int = 0) -> Iterator[float]:
        """The deterministic sleep schedule: one delay per retry (so
        ``max_tries`` attempts yield ``max_tries - 1`` delays)."""
        rng = random.Random(seed)
        for i in range(self.max_tries - 1):
            d = min(self.base_s * (self.factor ** i), self.max_s)
            yield d * (1.0 + self.jitter * rng.random())


#: Conservative default for the initial tcp connect: ~10 tries over
#: roughly three seconds — enough to absorb a worker-spawn vs
#: server-bind race without masking a genuinely absent server forever.
CONNECT_POLICY = BackoffPolicy(base_s=0.05, factor=1.7, max_s=0.8,
                               max_tries=10)

#: Failover reconnect: a restarting server has to reload a checkpoint
#: and rebind, so back off further and longer before giving up.
RECONNECT_POLICY = BackoffPolicy(base_s=0.1, factor=2.0, max_s=2.0,
                                 max_tries=12)


def retry(fn: Callable, policy: BackoffPolicy, *, seed: int = 0,
          retry_on: Tuple[Type[BaseException], ...] = (OSError,),
          sleep: Callable[[float], None] = time.sleep,
          on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Call ``fn()`` up to ``policy.max_tries`` times, sleeping the
    policy's jittered schedule between attempts.  Re-raises the last
    failure when the budget is exhausted; ``on_retry(attempt, exc)``
    observes each intermediate failure (telemetry hooks)."""
    schedule = policy.delays(seed)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            delay = next(schedule, None)
            if delay is None:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)


__all__ = ["BackoffPolicy", "CONNECT_POLICY", "RECONNECT_POLICY", "retry"]
