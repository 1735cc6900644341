"""Server-side RPC dispatch: frames in, parameter-server calls out.

Counterpart of ``repro/transport/endpoint.py``.  ``PSServerEndpoint``
adapts a ``ParameterServer`` (``apply_mode='packed'``) or
``ShardedParameterServer`` (``apply_mode='fused'``) to the frame
protocol.  The endpoint is transport-agnostic: every backend funnels
each decoded request through ``handle`` (or raw bytes through
``handle_bytes``) on its own thread, so a push that blocks inside the
sync-policy gate simply parks that connection's thread.

Per-shard routing: an endpoint built with ``shards={0, 2}`` serves only
those shards' regions (frames must carry ``shard >= 0``), so different
shards of one ``ShardedParameterServer`` can live behind different
endpoints/ports.  ``ShardRouter`` is the client-side counterpart that
splits a full wire buffer across such endpoints.

The server's buffers live on its device (``cuda:0``); a pull reply
needs them on the host.  The endpoint keeps one host copy per (shard,
reshard epoch, version), for full pulls and for each delta region
alike, so W workers pulling the same state cost one device-to-host
copy.  TRACE frames go to the session's ``TraceCollector`` (acknowledged
and dropped without one).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.transport.base import PSTransportClient
from repro_torch.wireformat import (
    FLAG_FULL,
    MSG_BYE,
    MSG_DELTA,
    MSG_ECHO,
    MSG_ERR,
    MSG_HELLO,
    MSG_LOSS,
    MSG_OK,
    MSG_PULL,
    MSG_PULL_DELTA,
    MSG_PUSH,
    MSG_STOP,
    MSG_SUB,
    MSG_TRACE,
    WIRE_LANES,
    Frame,
    FrameError,
    decode_frame,
    encode_frame,
)


class PSServerEndpoint:
    """Frame-level RPC surface over a packed-mode parameter server.

    ``server`` must speak the packed wire format (``push_packed`` /
    ``pull_packed``); per-shard routing additionally needs the sharded
    server's ``push_packed_shard`` / ``pull_packed_shard``.
    """

    def __init__(self, server, *, shards: Optional[Sequence[int]] = None,
                 collector=None):
        if not getattr(server, "packed_wire", False):
            raise ValueError(
                "endpoint needs a packed-wire server (apply_mode="
                f"'packed'/'fused'), got apply_mode="
                f"{getattr(server, 'apply_mode', None)!r}")
        self.server = server
        self.shards = None if shards is None else frozenset(shards)
        #: ``repro_torch.obs.TraceCollector`` to merge MSG_TRACE flushes
        #: into; without one the frames are acknowledged and dropped.
        self.collector = collector
        if self.shards is not None:
            known = range(getattr(server, "n_shards", 1))
            bad = sorted(self.shards - set(known))
            if bad:
                raise ValueError(f"endpoint routes shards {bad} but the "
                                 f"server has {len(known)} shard(s)")
        self._hello_lock = threading.Lock()
        # Serving replicas (MSG_SUB): pull-only peers that hold no
        # barrier seat, so on_disconnect must NOT remove_worker them.
        self._subscribers: set = set()
        # Host copies of pulled state: key (-1 for the full buffer, or a
        # shard id) -> (epoch, version, tensor).  The epoch is part of
        # the key because a live reshard keeps the version sum while the
        # layout changes.
        self._pull_lock = threading.Lock()
        self._pull_cache: Dict[int, tuple] = {}

    def _epoch(self) -> int:
        """The server's live-reshard epoch (0 for servers without the
        surface) — stamped into HELLO/SUB/PULL/DELTA replies via the
        frame's otherwise-unused ``shard`` field."""
        return int(getattr(self.server, "reshard_epoch", 0))

    # -- sizing (transports pre-allocate from this) ----------------------
    def wire_rows(self) -> int:
        layout = self.server.plan.wire_layout()
        if self.shards is None:
            return layout.total_rows
        return sum(layout.shard_rows[j] for j in self.shards)

    def max_payload_bytes(self) -> int:
        layout = self.server.plan.wire_layout()
        return self.wire_rows() * WIRE_LANES * max(4, layout.dtype.itemsize)

    # -- dispatch --------------------------------------------------------
    def handle_bytes(self, data) -> bytes:
        """Raw frame in, raw reply frame out (the loopback hot path)."""
        try:
            frame = decode_frame(data)
        except FrameError as e:
            return encode_frame(Frame(kind=MSG_ERR, error=str(e)))
        return encode_frame(self.handle(frame))

    def handle(self, frame: Frame) -> Frame:
        try:
            return self._dispatch(frame)
        except Exception as e:
            # The RPC boundary must ALWAYS answer: an escaped exception
            # would kill the serving thread (tcp) or leave the slot
            # stuck in request state forever (shmem).
            return Frame(kind=MSG_ERR, worker=frame.worker,
                         error=f"{type(e).__name__}: {e}")

    def _dispatch(self, frame: Frame) -> Frame:
        server = self.server
        kind = frame.kind
        if kind == MSG_HELLO:
            with self._hello_lock:
                server.add_worker(frame.worker)  # idempotent
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version, shard=self._epoch(),
                         aux=float(self.wire_rows()))
        if kind == MSG_SUB:
            if self.shards is not None:
                raise FrameError(
                    "replica subscriptions need a full-store endpoint "
                    "(their delta pulls cover every shard); this one "
                    f"routes shards {sorted(self.shards)} only")
            with self._hello_lock:
                self._subscribers.add(frame.worker)
            # Deliberately NO add_worker: a subscriber never pushes, so
            # seating it would change every BSP/SSP/DSSP gate decision.
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version, shard=self._epoch(),
                         aux=float(self.wire_rows()))
        if kind == MSG_PULL:
            if server.stopped:
                return Frame(kind=MSG_STOP, worker=frame.worker,
                             clock=server.version)
            buf = self._pull(frame)
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version, shard=self._epoch(),
                         payload=buf)
        if kind == MSG_PULL_DELTA:
            if server.stopped:
                # Training workers take STOP and exit; a subscribed
                # replica still gets deltas until its vector matches
                # the FINAL weights — only then does STOP freeze it.
                with self._hello_lock:
                    is_sub = frame.worker in self._subscribers
                if not is_sub or tuple(frame.versions or ()) == \
                        tuple(server.shard_versions()):
                    return Frame(kind=MSG_STOP, worker=frame.worker,
                                 clock=server.version)
            if self.shards is not None:
                raise FrameError(
                    "delta pulls need a full-store endpoint; this one "
                    f"routes shards {sorted(self.shards)} only")
            d = server.pull_delta(frame.worker, frame.versions)
            epoch = int(d.epoch)
            entries = [(int(j), self._host(
                j, epoch, d.versions[j], lambda r=r: r))
                for j, r in zip(d.shards, d.regions)]
            return Frame(kind=MSG_DELTA, worker=frame.worker,
                         clock=server.version,
                         flags=FLAG_FULL if d.full else 0,
                         shard=epoch, versions=tuple(d.versions),
                         delta=entries)
        if kind == MSG_PUSH:
            if server.stopped:
                return Frame(kind=MSG_STOP, worker=frame.worker,
                             clock=server.version)
            self._push(frame)  # blocks in the policy gate
            kind_out = MSG_STOP if server.stopped else MSG_OK
            return Frame(kind=kind_out, worker=frame.worker,
                         clock=server.version)
        if kind == MSG_LOSS:
            server.record_loss(int(frame.clock), float(frame.aux))
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version)
        if kind == MSG_BYE:
            server.remove_worker(frame.worker)
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version)
        if kind == MSG_TRACE:
            if self.collector is not None and frame.blob:
                try:
                    events = json.loads(frame.blob)
                except json.JSONDecodeError:
                    events = None
                if isinstance(events, list):
                    self.collector.ingest(f"w{frame.worker}", events)
            return Frame(kind=MSG_OK, worker=frame.worker,
                         clock=server.version)
        # MSG_STOP is a server-side REPLY kind only: accepting it as a
        # request would let any connected worker halt training.
        if kind == MSG_ECHO:
            return Frame(kind=MSG_ECHO, worker=frame.worker,
                         payload=frame.payload)
        raise FrameError(f"kind {kind} is not a request")

    # -- server calls ----------------------------------------------------
    def _check_shard(self, frame: Frame) -> int:
        shard = frame.shard
        if self.shards is not None:
            if shard < 0:
                raise FrameError(
                    "this endpoint serves shards "
                    f"{sorted(self.shards)}; frames must carry a shard id")
            if shard not in self.shards:
                raise FrameError(f"shard {shard} is not served here "
                                 f"(have {sorted(self.shards)})")
        return shard

    def _host(self, key: int, epoch: int, version: int,
              fetch: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The host copy of state ``key`` (-1: the full buffer, else a
        shard) at (epoch, version): cached, else fetched and copied to
        the host once."""
        with self._pull_lock:
            hit = self._pull_cache.get(key)
            if hit is not None and hit[:2] == (epoch, version):
                return hit[2]
        host = fetch().cpu()
        with self._pull_lock:
            cached = self._pull_cache.get(key)
            if cached is None or (epoch, version) >= cached[:2]:
                self._pull_cache[key] = (epoch, version, host)
        return host

    def _pull(self, frame: Frame) -> torch.Tensor:
        shard = self._check_shard(frame)
        if shard < 0:
            fetch = lambda: self.server.pull_packed(frame.worker)  # noqa: E731
            version = self.server.version
        else:
            fetch = lambda: self.server.pull_packed_shard(  # noqa: E731
                shard, frame.worker)
            version = self.server.shard_versions()[shard]
        return self._host(shard, self._epoch(), version, fetch)

    def _push(self, frame: Frame) -> None:
        shard = self._check_shard(frame)
        if frame.payload is None:
            raise FrameError("push frame carried no payload")
        # copy=True: a shmem payload views the segment in place, and the
        # client overwrites it with its next request; on the CPU ``to``
        # would otherwise alias it.  On CUDA this is the one H2D copy.
        buf = frame.payload.to(self.server.device, copy=True)
        if shard < 0:
            if hasattr(self.server, "reshard"):
                # ``aux`` carries the layout epoch the client packed
                # against: a push that raced a live reshard is validated
                # against the retired plan and translated; an epoch the
                # server never issued bounces with a "resync" error.
                self.server.push_packed(frame.worker, buf,
                                        epoch=int(frame.aux))
            else:
                self.server.push_packed(frame.worker, buf)
        else:
            self.server.push_packed_shard(frame.worker, shard, buf)

    # -- lifecycle hooks (called by transports) --------------------------
    def on_disconnect(self, worker: int) -> None:
        """A connection died without BYE (killed worker, broken pipe):
        drop it from the barrier group so survivors are not gated on a
        corpse.  Subscribed replicas hold no seat and are only
        unregistered."""
        with self._hello_lock:
            if worker in self._subscribers:
                self._subscribers.discard(worker)
                return
        self.server.remove_worker(worker)


class ShardRouter:
    """Client-side shard fan-out across per-shard endpoints.

    ``clients`` maps shard id -> ``PSTransportClient`` (several shards
    may share one client).  Pushes visit shards in canonical order
    0..S-1 — same acyclic-wait argument as the sharded server's
    ``push`` — and pulls reassemble the full wire buffer from per-shard
    regions.
    """

    def __init__(self, clients: Dict[int, PSTransportClient],
                 shard_rows: Sequence[int]):
        self.rebuild(clients, shard_rows)

    def rebuild(self, clients: Dict[int, PSTransportClient],
                shard_rows: Sequence[int]) -> None:
        """Re-point the routing table after a live reshard: the shard
        count (and each shard's row extent) changed, so the old
        shard -> client map is meaningless.  Callers derive
        ``shard_rows`` from the NEW plan's wire layout and pass a client
        per new shard."""
        if sorted(clients) != list(range(len(shard_rows))):
            raise ValueError(
                f"need one client per shard 0..{len(shard_rows) - 1}, "
                f"got {sorted(clients)}")
        self.clients = dict(clients)
        self.shard_rows = tuple(shard_rows)

    def pull_packed(self) -> Optional[torch.Tensor]:
        regions = []
        for j, rows in enumerate(self.shard_rows):
            if rows == 0:
                continue
            buf = self.clients[j].pull_packed(shard=j)
            if buf is None:
                return None
            regions.append(buf)
        return torch.cat(regions) if len(regions) > 1 else regions[0]

    def push_packed(self, wire, clock: int = 0) -> bool:
        if tuple(wire.shape) != (sum(self.shard_rows), WIRE_LANES):
            raise ValueError(f"wire buffer {tuple(wire.shape)} does not "
                             f"match ({sum(self.shard_rows)}, "
                             f"{WIRE_LANES})")
        alive, row = True, 0
        for j, rows in enumerate(self.shard_rows):
            if rows == 0:
                continue
            region = wire[row:row + rows]
            alive = self.clients[j].push_packed(region, shard=j,
                                                clock=clock) and alive
            row += rows
        return alive
