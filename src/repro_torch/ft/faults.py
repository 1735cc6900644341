"""Deterministic fault injection for chaos testing.

Counterpart of ``repro/ft/faults.py``: the same plan fields, JSON form
and per-worker drop decisions for the same seed.

A ``FaultPlan`` is a frozen, picklable description of every fault a
run should suffer — which makes chaos *reproducible*: the same plan +
seed injects the same faults at the same points, in CI and on a
laptop.

Three fault families:

  * **kill the server** at push-round R — implemented server-side (a
    watchdog in ``ft.server_proc`` SIGKILLs the server process when
    its aggregate push count crosses R; SIGKILL on purpose: no atexit,
    no final snapshot, the worst case),
  * **kill worker W** at its local iteration R' — the worker process
    SIGKILLs *itself* mid-loop (``worker_kill_due``), exercising the
    server's disconnect path and the barrier-seat release,
  * **drop / delay frames** of kind K with probability p — injected in
    ``FaultyChannel``, a ``Channel`` wrapper that parses each outgoing
    frame's header and consults a per-worker seeded RNG; a dropped
    frame surfaces to the client as ``TransportClosed`` (exactly what
    a dead socket looks like), driving the reconnect path.

Every injected fault is emitted as a typed ``fault`` obs instant so a
trace of a chaos run shows *why* the failover spans exist.

Stdlib, the trace recorder and the frame codec only.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import Any, Dict, Optional

from repro_torch.obs.trace import TRACE
from repro_torch.transport.base import Channel, Frame, TransportClosed
from repro_torch.wireformat import HEADER_SIZE, decode_header


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Sentinel-disabled fields: ``-1`` rounds and ``0.0`` probability
    mean 'never'.  ``drop_kind``/``delay_kind`` are wireformat MSG_*
    codes (0 = any kind)."""

    kill_server_round: int = -1   # SIGKILL server at aggregate push R
    kill_worker: int = -1         # which worker id self-SIGKILLs ...
    kill_worker_round: int = -1   # ... at this local iteration
    drop_kind: int = 0            # frame kind to drop (0 = any)
    drop_prob: float = 0.0        # per-frame drop probability
    delay_kind: int = 0           # frame kind to delay (0 = any)
    delay_ms: float = 0.0         # injected per-frame latency
    kill_mid_reshard: bool = False  # SIGKILL the server INSIDE a live
    #                               reshard (between shard migrations —
    #                               the torn-window failover case)
    seed: int = 0                 # RNG seed (per-worker offset added)

    def __post_init__(self):
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError("drop_prob is a probability in [0, 1]")
        if self.delay_ms < 0:
            raise ValueError("delay_ms must be >= 0")

    @property
    def active(self) -> bool:
        return (self.kill_server_round >= 0
                or (self.kill_worker >= 0 and self.kill_worker_round >= 0)
                or self.drop_prob > 0.0 or self.delay_ms > 0.0
                or self.kill_mid_reshard)

    @property
    def wants_channel(self) -> bool:
        """Does this plan need a ``FaultyChannel`` wrapper at all?"""
        return self.drop_prob > 0.0 or self.delay_ms > 0.0

    def worker_kill_due(self, worker_id: int, iteration: int) -> bool:
        return (self.kill_worker == worker_id
                and self.kill_worker_round >= 0
                and iteration == self.kill_worker_round)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FaultPlan":
        if not d:
            return cls()
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def kill_self() -> None:  # pragma: no cover - the process dies here
    """SIGKILL the calling process: no cleanup, no flush — the honest
    simulation of a machine dropping off the fleet."""
    os.kill(os.getpid(), signal.SIGKILL)


class FaultyChannel(Channel):
    """Channel wrapper injecting the plan's drop/delay faults into the
    request path, deterministically per ``(plan.seed, worker_id)``."""

    def __init__(self, inner: Channel, plan: FaultPlan, worker_id: int):
        self.inner = inner
        self.plan = plan
        self.worker_id = worker_id
        self._rng = random.Random((plan.seed << 16) ^ worker_id)

    def request(self, data: bytes) -> Frame:
        plan = self.plan
        kind = 0
        if len(data) >= HEADER_SIZE:
            try:
                frame, _ = decode_header(bytes(data[:HEADER_SIZE]))
                kind = frame.kind
            except Exception:
                kind = 0
        if plan.drop_prob > 0.0 and plan.drop_kind in (0, kind):
            if self._rng.random() < plan.drop_prob:
                if TRACE.enabled:
                    TRACE.instant("fault", worker=self.worker_id,
                                  args={"fault": "drop", "kind": kind})
                raise TransportClosed(
                    f"injected drop of frame kind {kind} "
                    f"(worker {self.worker_id})")
        if plan.delay_ms > 0.0 and plan.delay_kind in (0, kind):
            if TRACE.enabled:
                TRACE.instant("fault", worker=self.worker_id,
                              args={"fault": "delay", "kind": kind,
                                    "ms": plan.delay_ms})
            time.sleep(plan.delay_ms / 1000.0)
        return self.inner.request(data)

    def close(self) -> None:
        self.inner.close()


def wrap_channel(channel: Channel, plan: Optional[FaultPlan],
                 worker_id: int) -> Channel:
    """Wrap iff the plan injects channel-level faults; otherwise the
    original channel passes through untouched (zero overhead)."""
    if plan is not None and plan.wants_channel:
        return FaultyChannel(channel, plan, worker_id)
    return channel


__all__ = ["FaultPlan", "FaultyChannel", "wrap_channel", "kill_self"]
