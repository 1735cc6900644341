"""Transport ABC + the worker-side RPC client.

Counterpart of ``repro/transport/base.py``.  A ``Transport`` moves
*frames* (``repro_torch.wireformat``: 44-byte header + packed (rows,
512) body) between a worker and a ``PSServerEndpoint``.  Three
backends:

  * ``inproc`` — in-memory loopback: the full encode/dispatch/decode
    path with no OS transport underneath,
  * ``tcp``    — length-prefixed frames over a socket; one server
    thread per connection so a push blocked in the sync-policy gate
    never stalls other workers,
  * ``shmem``  — ``multiprocessing.shared_memory`` request/reply slots
    for local workers: the frame body is written once into the segment
    and parsed in place on the server.

Every backend's *address* is a small picklable tuple, so a spawned
worker process can reconstruct its client with ``connect(address,
worker_id)`` — see ``repro_torch.launch.proc_pool``.  The frames are
byte-identical to the reference's, so a client of either package talks
to an endpoint of the other.  Payloads on this side are CPU
``torch.Tensor``s; a pushed CUDA tensor is copied to the host by the
codec.
"""

from __future__ import annotations

import abc
import json
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.api.protocol import DeltaPull
from repro_torch.ft.backoff import RECONNECT_POLICY, BackoffPolicy, retry
from repro_torch.obs.trace import TRACE
from repro_torch.wireformat import (
    FLAG_FULL,
    MSG_BYE,
    MSG_DELTA,
    MSG_ECHO,
    MSG_ERR,
    MSG_HELLO,
    MSG_LOSS,
    MSG_PULL,
    MSG_PULL_DELTA,
    MSG_PUSH,
    MSG_STOP,
    MSG_SUB,
    MSG_TRACE,
    Frame,
    FrameError,
    encode_frame,
)


class TransportClosed(ConnectionError):
    """The peer went away (server shutdown, closed segment, dead socket)."""


class Channel(abc.ABC):
    """One request/reply lane between a client and an endpoint."""

    @abc.abstractmethod
    def request(self, data: bytes) -> Frame:
        """Send one encoded frame, block for the reply frame."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release the lane (idempotent)."""


class PSTransportClient:
    """Parameter-server RPCs over any ``Channel``.

    Mirrors the worker-facing surface of ``ParameterServer`` /
    ``ShardedParameterServer`` (pull/push packed, record_loss, leave)
    plus an ``echo`` diagnostic.  ``push_packed``/``pull_packed``
    return ``False``/``None`` once the server has stopped — the worker
    loop's clean-exit signal.

    ``channel_factory`` (when the backend provides one — tcp does)
    arms ``reconnect()``: after the server dies mid-RPC
    (``TransportClosed`` / ``OSError``), the client rebuilds its
    channel with bounded exponential backoff and re-HELLOs.  HELLO is
    idempotent server-side, so a reconnect never acquires a second
    barrier seat; the worker keeps its last-seen version vector and
    the delta-pull dominance rule decides full-vs-delta resync.
    """

    def __init__(self, channel: Channel, worker_id: int, *,
                 compress: str = "none",
                 channel_factory: Optional[Callable[[], Channel]] = None):
        self.channel = channel
        self.worker_id = worker_id
        self.compress = compress
        self.channel_factory = channel_factory
        self.server_rows: Optional[int] = None
        self.clock = 0
        self.reconnects = 0
        #: The server's live-reshard epoch this client last built its
        #: layout against (HELLO/SUB replies carry it in the frame's
        #: ``shard`` field; old servers leave it at -1 -> treat as 0).
        #: Pushes echo it back in ``aux`` so the server can translate a
        #: buffer packed against a just-retired layout.
        self.reshard_epoch = 0

    # -- plumbing --------------------------------------------------------
    def _request(self, frame: Frame, compress: str = "none") -> Frame:
        reply = self.channel.request(encode_frame(frame, compress))
        if reply.kind == MSG_ERR:
            raise FrameError(f"server rejected frame: {reply.error}")
        self.clock = reply.clock
        return reply

    # -- RPCs ------------------------------------------------------------
    def hello(self) -> int:
        """Join the barrier group; returns the full wire-buffer row
        count (what ``pull_packed()`` with no shard routing yields)."""
        reply = self._request(Frame(kind=MSG_HELLO, worker=self.worker_id))
        self.server_rows = int(reply.aux)
        self.reshard_epoch = max(0, reply.shard)
        return self.server_rows

    def subscribe(self) -> int:
        """Register as a serving REPLICA: same reply as ``hello`` (wire
        rows in aux, server version in clock) but the server takes no
        barrier seat for us — a subscriber only ever pulls, and must
        never slow the training workers' sync-policy gate."""
        reply = self._request(Frame(kind=MSG_SUB, worker=self.worker_id))
        self.server_rows = int(reply.aux)
        self.reshard_epoch = max(0, reply.shard)
        return self.server_rows

    def pull_packed(self, shard: int = -1, *,
                    copy: bool = True) -> Optional[torch.Tensor]:
        """Latest packed params (one shard's region if ``shard >= 0``);
        ``None`` once the server has stopped.

        ``copy=False`` may return a view into the transport's receive
        buffer, valid only until the next request on this client — safe
        when the caller moves it to a device buffer immediately.
        """
        reply = self._request(Frame(kind=MSG_PULL, worker=self.worker_id,
                                    shard=shard))
        if reply.kind == MSG_STOP:
            return None
        if reply.payload is None:
            raise FrameError("pull reply carried no payload")
        return reply.payload.clone() if copy else reply.payload

    def pull_delta(self, versions, *,
                   copy: bool = True) -> Optional[DeltaPull]:
        """Version-delta pull: only the shards that advanced past
        ``versions`` (the vector returned by the previous call, or
        ``(-1,) * n_shards`` for the bootstrap pull — every shard then
        arrives, which IS the full snapshot).  Returns ``None`` once
        the server has stopped.  ``copy=False`` returns regions viewing
        the transport's receive buffer, valid until the next request on
        this client."""
        reply = self._request(Frame(kind=MSG_PULL_DELTA,
                                    worker=self.worker_id,
                                    versions=tuple(int(v)
                                                   for v in versions)))
        if reply.kind == MSG_STOP:
            return None
        if reply.kind != MSG_DELTA:
            raise FrameError(f"expected a DELTA reply, got kind "
                             f"{reply.kind}")
        entries = list(reply.delta or ())
        return DeltaPull(
            versions=tuple(reply.versions or ()),
            shards=tuple(s for s, _ in entries),
            regions=tuple(a.clone() if copy else a
                          for _, a in entries),
            full=bool(reply.flags & FLAG_FULL),
            epoch=max(0, reply.shard))

    def push_packed(self, wire, shard: int = -1, clock: int = 0) -> bool:
        """Push a packed gradient buffer; BLOCKS until the server's sync
        policy releases this worker (the Algorithm-1 gate, carried
        across the process boundary by the pending reply).  Returns
        ``False`` once the server has stopped."""
        frame = Frame(kind=MSG_PUSH, worker=self.worker_id, shard=shard,
                      clock=clock, aux=float(self.reshard_epoch),
                      payload=wire)
        reply = self._request(frame, compress=self.compress)
        return reply.kind != MSG_STOP

    def record_loss(self, step: int, loss: float) -> None:
        self._request(Frame(kind=MSG_LOSS, worker=self.worker_id,
                            clock=int(step), aux=float(loss)))

    def send_trace(self, events: Sequence[dict]) -> None:
        """Flush a drained trace event batch to the server-side
        collector (no-op reply; an endpoint without a collector drops
        the batch)."""
        if not events:
            return
        blob = json.dumps(list(events),
                          separators=(",", ":")).encode("utf-8")
        self._request(Frame(kind=MSG_TRACE, worker=self.worker_id,
                            blob=blob))

    def echo(self, arr, compress: str = "none") -> torch.Tensor:
        """Payload round-trip diagnostic (health checks + codec tests)."""
        reply = self._request(Frame(kind=MSG_ECHO, worker=self.worker_id,
                                    payload=arr), compress)
        return reply.payload.clone()

    def reconnect(self, policy: BackoffPolicy = RECONNECT_POLICY, *,
                  seed: Optional[int] = None) -> int:
        """Failover path: tear down the dead channel, rebuild one via
        ``channel_factory`` with jittered backoff, and re-HELLO.

        Returns the server's wire-row count (the HELLO reply); raises
        ``TransportClosed`` when no factory exists or the backoff
        budget is exhausted — at that point the server is genuinely
        gone, not restarting.
        """
        if self.channel_factory is None:
            raise TransportClosed(
                "this transport cannot reconnect (no channel factory)")
        try:
            self.channel.close()
        except OSError:
            pass
        t0 = TRACE.now() if TRACE.enabled else 0.0
        tries = [0]

        def attempt() -> int:
            tries[0] += 1
            channel = self.channel_factory()
            try:
                self.channel = channel
                return self.hello()
            except BaseException:
                channel.close()
                raise

        rows = retry(attempt, policy,
                     seed=self.worker_id if seed is None else seed,
                     retry_on=(TransportClosed, OSError))
        self.reconnects += 1
        if TRACE.enabled:
            TRACE.span("reconnect", t0, worker=self.worker_id,
                       args={"tries": tries[0], "rows": rows})
        return rows

    def bye(self) -> None:
        """Leave the barrier group so survivors are not gated on us."""
        try:
            self._request(Frame(kind=MSG_BYE, worker=self.worker_id))
        except (TransportClosed, OSError):
            pass  # server already gone — nothing left to leave

    def close(self) -> None:
        self.channel.close()


class Transport(abc.ABC):
    """Server-side lifecycle of one transport backend."""

    name: str = "?"

    @abc.abstractmethod
    def serve(self, endpoint: Any) -> None:
        """Start accepting worker connections for ``endpoint``
        (non-blocking; serving happens on daemon threads)."""

    @abc.abstractmethod
    def address(self) -> Tuple:
        """Picklable descriptor a worker process passes to
        ``repro_torch.transport.connect``."""

    @abc.abstractmethod
    def connect(self, worker_id: int, *,
                compress: str = "none") -> PSTransportClient:
        """In-process client (the parent's own handle on the server)."""

    @abc.abstractmethod
    def shutdown(self) -> None:
        """Stop serving and invalidate outstanding channels.  Does NOT
        stop the parameter server itself — call ``server.stop()`` first
        so gate-blocked pushes drain with a STOP reply instead of a
        broken pipe."""
